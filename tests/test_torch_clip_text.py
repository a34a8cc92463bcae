"""goi_tpu_torch's CLIP text tower and BPE tokenizer against goi_tpu: the
same params (goi_tpu's init, carried across by interop) through both
transformers, the token ids of both tokenizers on a synthetic merge table,
the converter and the bigE checkpoint manifest. Tolerances are those of
the JAX tests each case mirrors: rtol 1e-4 / atol 1e-5 at the tiny config
(tests/test_clip_text.py), rtol 2e-4 / atol 2e-5 at the bigE layer
geometry (tests/test_clip_text_fullmodel.py)."""

import gzip
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.query import clip_text as jct
from goi_tpu.query.align import VisionLanguageAlign as JAlign
from goi_tpu.query import text_encoder as jte
from goi_tpu_torch import interop
from goi_tpu_torch.query import clip_text as tct
from goi_tpu_torch.query import text_encoder as tte
from goi_tpu_torch.query.align import VisionLanguageAlign as TAlign

torch.set_num_threads(1)

TINY = dict(vocab_size=120, context_length=16, width=64, heads=4, layers=2,
            embed_dim=32)
MANIFEST = os.path.join(os.path.dirname(__file__), "golden",
                        "eva02_text_bigE_manifest.json")
MERGES = ["t h", "th e</w>", "r e", "re d</w>", "c h", "a i", "ch ai",
          "chai r</w>", "o n", "on e</w>", "s o", "so f", "sof a</w>",
          "l a", "la m", "lam p</w>", "b l", "bl u", "blu e</w>", "in g</w>"]
PROMPTS = ["the red chair", "a blue   sofa!", "The lamp, near ONE chair.",
           "it's 3 lamps &amp; a sofa", "painting"]


def _cfgs(**kw):
    return (jct.CLIPTextConfig(**{**TINY, **kw}),
            tct.CLIPTextConfig(**{**TINY, **kw}))


def _tokens(rng, vocab, ctx, batch=3):
    tokens = np.zeros((batch, ctx), np.int32)
    for i in range(batch):
        n = int(rng.integers(3, ctx - 1))
        tokens[i, 0] = vocab - 10                  # SOT-like
        tokens[i, 1:n] = rng.integers(1, vocab - 20, n - 1)
        tokens[i, n] = vocab - 1                   # EOT = the largest id
    return tokens


def _pair(jcfg, tcfg, seed=0):
    params = {k: np.asarray(v) for k, v in
              jct.init_clip_text_params(jax.random.PRNGKey(seed),
                                        jcfg).items()}
    return params, interop.clip_text_from_numpy(params, tcfg, device="cpu")


@pytest.fixture
def bpe(tmp_path):
    path = tmp_path / "bpe.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    return str(path)


@pytest.mark.parametrize("case", ["tiny", "bigE_layer"])
def test_transformer_matches_jax(case):
    if case == "tiny":
        jcfg, tcfg = _cfgs()
        tol = dict(rtol=1e-4, atol=1e-5)
    else:   # the real bigE layer geometry, one layer
        big = dict(width=1280, heads=20, embed_dim=1024, layers=1,
                   vocab_size=512, context_length=20)
        jcfg, tcfg = _cfgs(**big)
        tol = dict(rtol=2e-4, atol=2e-5)
    params, model = _pair(jcfg, tcfg, seed=1)
    tokens = _tokens(np.random.default_rng(1), jcfg.vocab_size,
                     jcfg.context_length)
    want = jct.clip_text_forward(params, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        got = model(torch.as_tensor(tokens))
    np.testing.assert_allclose(got["eot"].numpy(), np.asarray(want["eot"]),
                               **tol)
    np.testing.assert_allclose(got["tokens"].numpy(),
                               np.asarray(want["tokens"]), **tol)
    # the EOT index is the argmax of the ids: EOT must be the largest
    np.testing.assert_array_equal(got["eot_idx"].numpy(),
                                  np.asarray(want["eot_idx"]))
    np.testing.assert_array_equal(got["eot_idx"].numpy(), tokens.argmax(1))


@pytest.mark.parametrize("no_regex", [False, True])
def test_tokenizer_ids_equal_jax(bpe, monkeypatch, no_regex):
    """The same ids on a synthetic merge table; without `regex` (absent
    on the card machine) both split words with the ASCII pattern."""
    if no_regex:
        monkeypatch.setitem(sys.modules, "regex", None)
    jt, tt = jct.ClipTokenizer(bpe, 16), tct.ClipTokenizer(bpe, 16)
    assert tt.encoder == jt.encoder
    for p in PROMPTS:
        assert tt.encode(p) == jt.encode(p), p
    mat = tt(PROMPTS)
    np.testing.assert_array_equal(mat, jt(PROMPTS))
    eot = tt.encoder[tt.EOT]
    assert eot == max(tt.encoder.values())
    np.testing.assert_array_equal(mat.argmax(1),
                                  [list(r).index(eot) for r in mat])
    # a merge applies: "chair" is one token, "the" one
    assert tt.encode("the chair") == [tt.encoder["the</w>"],
                                      tt.encoder["chair</w>"]]


def test_convert_openclip_state_loads_strict():
    jcfg, tcfg = _cfgs()
    params, model = _pair(jcfg, tcfg)
    wrapped = {("text." if i % 2 else "") + ("transformer." + k
               if k.startswith("resblocks.") else
               "token_embedding.weight" if k == "token_embedding" else k):
               torch.tensor(v) for i, (k, v) in
               enumerate(sorted(params.items()))}
    conv = tct.convert_openclip_text_state(wrapped)
    assert conv.keys() == jct.convert_openclip_text_state(wrapped).keys() \
        == params.keys()
    other = interop.clip_text_from_numpy(conv, tcfg, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    with pytest.raises(RuntimeError, match="Unexpected key"):
        interop.load_flat_params(other, {**conv, "extra": np.zeros(1)})
    del conv["ln_final.bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        interop.load_flat_params(other, conv)


def test_bigE_manifest_converts_onto_the_module():
    """The official EVA02-CLIP-bigE-14-plus text tower's names and shapes
    (tests/golden) convert 1:1 onto CLIPTextTransformer's state_dict at
    CLIP_TEXT_BIGE (built on the meta device: nothing allocated)."""
    with open(MANIFEST) as f:
        manifest = json.load(f)
    conv = tct.convert_openclip_text_state(
        {k: np.broadcast_to(np.float32(0), v) for k, v in manifest.items()})
    shapes = {k: v.shape for k, v in conv.items()}
    assert len(shapes) == len(manifest)
    model = tct.CLIPTextTransformer(tct.CLIP_TEXT_BIGE, device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == shapes
    assert sum(v.numel() for v in model.parameters()) > 690e6


def test_encoder_and_align_match_jax(bpe):
    jcfg, tcfg = _cfgs(vocab_size=600)   # the merge table's 534 ids
    params, model = _pair(jcfg, tcfg, seed=2)
    jenc = jct.JaxCLIPTextEncoder(params, jcfg, bpe)
    tenc = tct.TorchCLIPTextEncoder(model, bpe)
    assert tenc.device == torch.device("cpu")
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tenc.encode("the red chair"),
                               jenc.encode("the red chair"), **tol)
    batch = tenc.encode_batch(PROMPTS)
    np.testing.assert_allclose(batch, jenc.encode_batch(PROMPTS), **tol)
    np.testing.assert_allclose(batch[1], tenc.encode(PROMPTS[1]), **tol)
    # the text_encoder module lists the live tower as a provider
    assert tte.TorchCLIPTextEncoder is tct.TorchCLIPTextEncoder
    kw = dict(embed_dim=16, embed_dim_language=jcfg.embed_dim)
    jtok, jbias = jte.encode_and_align(jenc, JAlign.create(seed=0, **kw),
                                       "a blue sofa")
    ttok, tbias = tte.encode_and_align(
        tenc, TAlign.create(seed=0, device="cpu", **kw), "a blue sofa")
    np.testing.assert_allclose(ttok.numpy(), np.asarray(jtok), **tol)
    np.testing.assert_allclose(tbias.numpy(), np.asarray(jbias), **tol)


def test_init_follows_the_jax_rules_and_the_generator():
    _, tcfg = _cfgs()
    a = tct.init_clip_text_(tct.CLIPTextTransformer(tcfg, device="cpu"),
                            torch.Generator().manual_seed(5))
    b = tct.init_clip_text_(tct.CLIPTextTransformer(tcfg, device="cpu"),
                            torch.Generator().manual_seed(5))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    shapes = {k: tuple(v.shape) for k, v in
              jct.init_clip_text_params(jax.random.PRNGKey(0),
                                        _cfgs()[0]).items()}
    assert {k: tuple(v.shape) for k, v in sa.items()} == shapes
    w = tcfg.width
    assert torch.equal(sa["resblocks.0.ln_1.weight"], torch.ones(w))
    assert torch.equal(sa["resblocks.1.attn.in_proj_bias"],
                       torch.zeros(3 * w))
    assert abs(float(sa["resblocks.0.mlp.c_fc.weight"].std())
               - w ** -0.5) < 0.1 * w ** -0.5
    assert abs(float(sa["token_embedding"].std()) - 0.02) < 0.002
