"""goi_tpu_torch's aligner and text providers against goi_tpu: the seeded
parameters, the state-dict loader, the aligned text tokens, both logit
heads, the precomputed store and encode_and_align
(tests/test_export_misc.py::test_text_and_res_providers without its RES
half). Tolerance: rtol 1e-5 / atol 1e-6, float32 GEMMs of 1024 terms in
another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.query.align import VisionLanguageAlign as JAlign
from goi_tpu.query import text_encoder as jte
from goi_tpu_torch import interop
from goi_tpu_torch.query import text_encoder as tte
from goi_tpu_torch.query.align import VisionLanguageAlign as TAlign

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
FIELDS = ("w_text", "b_text", "log_scale", "bias_lang", "bias0")


def _pair(seed=0, **kw):
    return (JAlign.create(seed=seed, **kw),
            TAlign.create(seed=seed, device="cpu", **kw))


@pytest.mark.parametrize("kw", [{}, dict(embed_dim=64, embed_dim_language=96,
                                         prior_prob=0.2, log_scale=-0.5)])
def test_create_draws_the_same_parameters(kw):
    ja, ta = _pair(seed=3, **kw)
    for k in FIELDS:
        assert getattr(ta, k).dtype == torch.float32
        np.testing.assert_array_equal(getattr(ta, k).numpy(),
                                      np.asarray(getattr(ja, k)))
    assert ta.device == torch.device("cpu")
    back = interop.aligner_from_numpy(
        *[np.asarray(getattr(ja, k)) for k in FIELDS], device="cpu")
    for k in FIELDS:
        assert torch.equal(getattr(back, k), getattr(ta, k))


def _state_dict(rng, torch_tensors):
    sd = {"dot_product_projection_text.weight": rng.normal(0, 0.03,
                                                           (256, 1024)),
          "dot_product_projection_text.bias": rng.normal(0, 0.1, 256),
          "log_scale": np.array(0.3), "bias_lang": rng.normal(0, 0.1, 1024),
          "bias0": np.array([-4.2])}
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    return {k: torch.as_tensor(v) for k, v in sd.items()} \
        if torch_tensors else sd


@pytest.mark.parametrize("torch_tensors", [False, True])
def test_state_dict_tokens_and_logits_match_jax(torch_tensors):
    rng = np.random.default_rng(1)
    sd = _state_dict(rng, torch_tensors)
    ta = TAlign.from_state_dict(sd, device="cpu")
    ja = JAlign.from_state_dict({k: np.asarray(v) for k, v in sd.items()})
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ta, k).numpy(),
                                      np.asarray(getattr(ja, k)))
    emb = rng.normal(0, 1, (3, 1024)).astype(np.float32)
    tt, tb = ta.text_embedding_align(torch.as_tensor(emb))
    jt, jb = ja.text_embedding_align(jnp.asarray(emb))
    assert tt.shape == (3, 256) and tb.shape == (3,)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    x = rng.normal(0, 1, (50, 256)).astype(np.float32)
    np.testing.assert_allclose(
        ta.logit_manual_bias(torch.as_tensor(x), tt).numpy(),
        np.asarray(ja.logit_manual_bias(jnp.asarray(x), jt)), **TOL)
    np.testing.assert_allclose(
        ta.logit(torch.as_tensor(x), tt, tb).numpy(),
        np.asarray(ja.logit(jnp.asarray(x), jt, jb)), **TOL)
    # the clamp at +-50000
    big = torch.as_tensor(x * 1e5)
    assert float(ta.logit(big, tt, tb).abs().max()) == 50000.0


def test_precomputed_store_and_encode_and_align(tmp_path):
    store = str(tmp_path / "prompts.npz")
    rng = np.random.default_rng(0)
    np.savez(store, sofa=rng.normal(size=1024).astype(np.float32),
             chair=rng.normal(size=1024).astype(np.float32))
    tenc, jenc = tte.PrecomputedTextEncoder(store), \
        jte.PrecomputedTextEncoder(store)
    assert tenc.available() == jenc.available() == ["chair", "sofa"]
    np.testing.assert_array_equal(tenc.encode("sofa"), jenc.encode("sofa"))
    with pytest.raises(KeyError, match="not in the precomputed store"):
        tenc.encode("table")
    ja, ta = _pair()
    tt, tb = tte.encode_and_align(tenc, ta, "sofa")
    jt, jb = jte.encode_and_align(jenc, ja, "sofa")
    assert tt.shape == (256,) and tt.device == ta.device
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(float(tb), float(jb), **TOL)


def test_eva02_encoder_needs_its_checkpoint(tmp_path):
    missing = str(tmp_path / "model_language.pth")
    with pytest.raises(FileNotFoundError) as te:
        tte.TorchEVA02TextEncoder(missing)
    with pytest.raises(FileNotFoundError) as je:
        jte.TorchEVA02TextEncoder(missing)
    assert str(te.value) == str(je.value)
