"""The distillation loss's row path (semantic/losses.py `_RowLoss`) by its
plain twin on the CPU: the closed form that csrc/distill_loss.cu
computes (the terms from one pass over the rows, the gradients of the
total from the same pass, the LUT's through dsim'^T g and the epilogue)
against autograd of the composition and against goi_tpu's loss, on tied
similarities, tied logits, zero ground-truth rows, a LUT row under the
norm's clamp, grad_output != 1, decoders whose logits the kernel does not
compute, and the callers' strided (P, C) view of a (C, H, W) map."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.semantic.codebook import SemanticDecoder as JDecoder
from goi_tpu.semantic.losses import distillation_loss as j_loss
from goi_tpu_torch.semantic import losses
from goi_tpu_torch.semantic.codebook import SemanticDecoder
from goi_tpu_torch.utils import profiling

torch.set_num_threads(1)

TERMS = ("lab", "sl", "sl1", "recc", "total")
K, C, S, H, W = 12, 16, 10, 20, 25     # P = 500


def _decoder(kind, dtype=torch.float32):
    gen = torch.Generator().manual_seed(3)
    if kind == "two_layer":
        dec = SemanticDecoder.create(gen, dim_in=S, dim_hidden=8, dim_out=K,
                                     num_layer=2, device="cpu")
    else:
        dec = SemanticDecoder.create(gen, dim_in=S, dim_out=K,
                                     norm=kind == "norm_output",
                                     device="cpu")
    with torch.no_grad():
        for b in dec.biases:
            b.normal_(0, 0.1, generator=gen)
        if kind == "tied_logits":
            dec.weights[0][4] = dec.weights[0][1]
            dec.biases[0][4] = dec.biases[0][1]
    return dec.to(dtype)


def _inputs(case, dtype=torch.float32):
    """lut (K, C), sem (P, S), the map (C, H, W)."""
    rng = np.random.default_rng(11)
    lut = rng.normal(0, 1, (K, C))
    lut[7] = lut[2]                       # a duplicate code: tied sim
    sem = rng.normal(0, 1, (H * W, S))
    gt = rng.normal(0, 1, (C, H, W))
    gt[:, 0, 3] = 0.0                     # an all-zero feature row
    if case == "tiny_lut_row":
        lut[5] *= 1e-9 / np.linalg.norm(lut[5])   # under the 1e-8 clamp
    if case == "tied_logits":
        sem[10] = 0.0                     # logits = bias alone
    return [torch.tensor(a, dtype=dtype) for a in (lut, sem, gt)]


def _flat(gt, half=False):
    """The callers' (P, C) view of a (C, H, W) map: strides (1, P)."""
    v = gt.reshape(gt.shape[0], -1).T
    return v[:v.shape[0] // 2] if half else v


def _run(fn, dec, lut, sem, gt_flat, t, scale=1.0, impl=None):
    """(terms, grads) of `scale * total` to the decoder, the LUT and the
    features."""
    dec = _clone(dec)
    lut = lut.clone().requires_grad_()
    sem = sem.clone().requires_grad_()
    if impl is None:
        total, aux = fn(dec, lut, sem, gt_flat, t)
    else:
        total, aux = fn(dec, lut, sem, gt_flat, t, impl=impl)
    (total * scale).backward()
    grads = {"lut": lut.grad, "sem": sem.grad}
    for i, (w, b) in enumerate(zip(dec.weights, dec.biases)):
        grads[f"w{i}"] = w.grad
        if b is not None:
            grads[f"b{i}"] = b.grad
    return {k: aux[k].detach() for k in TERMS}, grads


def _clone(dec):
    return SemanticDecoder([w.detach().clone() for w in dec.weights],
                           [None if b is None else b.detach().clone()
                            for b in dec.biases], dec.norm_output)


def _assert_close(got, want, rtol, what):
    for k in want:
        a, b = got[k], want[k]
        assert a is not None and b is not None, (what, k)
        peak = float(b.abs().max())
        err = float((a.double() - b.double()).abs().max())
        assert err <= rtol * max(peak, 1e-30), (what, k, err, peak)


CASES = ["base", "tied_logits", "tiny_lut_row", "two_layer", "norm_output",
         "half_view"]


@pytest.mark.parametrize("anneal_t", [1.0, 2.0])
@pytest.mark.parametrize("case", CASES)
def test_twin_matches_autograd_of_the_composition(case, anneal_t):
    """In float64 the closed form is the composition's gradient to
    rounding: every term and every gradient (decoder, LUT, features)."""
    kind = case if case in ("tied_logits", "two_layer", "norm_output") \
        else "one_layer"
    dec = _decoder(kind, torch.float64)
    lut, sem, gt = _inputs(case, torch.float64)
    half = case == "half_view"
    flat = _flat(gt, half)
    sem = sem[:flat.shape[0]]
    want = _run(losses.distillation_loss_plain, dec, lut, sem, flat,
                anneal_t)
    got = _run(losses.distillation_loss_rows, dec, lut, sem, flat, anneal_t,
               impl="plain")
    _assert_close(got[0], want[0], 1e-12, "terms")
    assert set(got[1]) == set(want[1])
    _assert_close(got[1], want[1], 1e-9, "grads")


@pytest.mark.parametrize("case", ["base", "tiny_lut_row", "two_layer"])
def test_twin_scales_by_grad_output(case):
    """A quarter of the total (the four-card step's 1 / views) gives a
    quarter of every gradient, and the same terms."""
    kind = "two_layer" if case == "two_layer" else "one_layer"
    dec = _decoder(kind, torch.float64)
    lut, sem, gt = _inputs(case, torch.float64)
    flat = _flat(gt)
    one = _run(losses.distillation_loss_rows, dec, lut, sem, flat, 2.0,
               impl="plain")
    quarter = _run(losses.distillation_loss_rows, dec, lut, sem, flat, 2.0,
                   scale=0.25, impl="plain")
    want = _run(losses.distillation_loss_plain, dec, lut, sem, flat, 2.0,
                scale=0.25)
    for k in TERMS:
        assert torch.equal(one[0][k], quarter[0][k]), k
    _assert_close(quarter[1], {k: 0.25 * v for k, v in one[1].items()},
                  1e-15, "scaled")
    _assert_close(quarter[1], want[1], 1e-9, "vs composition")


@pytest.mark.parametrize("anneal_t", [1.0, 2.0])
@pytest.mark.parametrize("case", ["base", "tied_logits", "tiny_lut_row",
                                  "half_view"])
def test_twin_matches_goi_tpu(case, anneal_t):
    """float32, as both packages run it: the terms and the gradients of
    the one-layer decoder, the LUT and the features against jax.grad of
    goi_tpu's loss on the same numbers."""
    kind = "tied_logits" if case == "tied_logits" else "one_layer"
    dec = _decoder(kind)
    lut, sem, gt = _inputs(case)
    flat = _flat(gt, case == "half_view")
    sem = sem[:flat.shape[0]]
    w0, b0 = dec.weights[0].detach().numpy(), dec.biases[0].detach().numpy()

    def jf(w, b, lut_, sem_):
        jd = JDecoder([w], [b], False)
        return j_loss(jd, lut_, sem_, jnp.asarray(flat.numpy()), anneal_t)

    (_, jaux), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        jnp.asarray(w0), jnp.asarray(b0), jnp.asarray(lut.numpy()),
        jnp.asarray(sem.numpy()))
    terms, grads = _run(losses.distillation_loss_rows, dec, lut, sem, flat,
                        anneal_t, impl="plain")
    for k in TERMS:
        np.testing.assert_allclose(float(terms[k]), float(jaux[k]),
                                   rtol=2e-5, err_msg=k)
    want = {"w0": jg[0], "b0": jg[1], "lut": jg[2], "sem": jg[3]}
    _assert_close(grads, {k: torch.tensor(np.asarray(v))
                          for k, v in want.items()}, 2e-4, "vs goi_tpu")


def test_gradients_only_where_asked(monkeypatch):
    """The forward is told which inputs need a gradient: none under
    no_grad, the LUT's alone for frozen features and decoder; aux terms
    carry no gradient and keep their keys."""
    seen = []
    plain = losses._rows_plain

    def spy(*a, **kw):
        seen.append((kw["grad_x"], kw["grad_w"], kw["grad_lut"]))
        return plain(*a, **kw)

    monkeypatch.setattr(losses, "_rows_plain", spy)
    dec = _decoder("one_layer")
    lut, sem, gt = _inputs("base")
    flat = _flat(gt)
    with torch.no_grad():
        total, aux = losses.distillation_loss_rows(dec, lut, sem, flat, 1.0,
                                                   impl="plain")
    assert seen[-1] == (False, False, False)
    assert set(aux) == set(TERMS)
    assert all(v.dim() == 0 for v in aux.values())
    for p in dec.parameters():
        p.requires_grad_(False)
    lut_g = lut.clone().requires_grad_()
    total, aux = losses.distillation_loss_rows(dec, lut_g, sem, flat, 1.0,
                                               impl="plain")
    assert seen[-1] == (False, False, True)
    assert not any(aux[k].requires_grad for k in TERMS[:4])
    total.backward()
    assert lut_g.grad is not None and dec.weights[0].grad is None


def test_ground_truth_gradient_is_refused():
    dec = _decoder("one_layer")
    lut, sem, gt = _inputs("base")
    flat = _flat(gt).clone().requires_grad_()
    with pytest.raises(ValueError, match="ground-truth"):
        losses.distillation_loss_rows(dec, lut, sem, flat, 1.0,
                                      impl="plain")


def test_decoders_the_kernel_decodes():
    assert losses.decodes_in_kernel(_decoder("one_layer"))
    assert not losses.decodes_in_kernel(_decoder("two_layer"))
    assert not losses.decodes_in_kernel(_decoder("norm_output"))
    wide = SemanticDecoder.create(torch.Generator().manual_seed(0),
                                  dim_in=losses.FUSED_MAX_S + 1, dim_out=K,
                                  device="cpu")
    assert not losses.decodes_in_kernel(wide)
    for k, fused in ((losses.FUSED_MAX_K, True),
                     (losses.FUSED_MAX_K + 1, False), (1024, False)):
        many = SemanticDecoder.create(torch.Generator().manual_seed(0),
                                      dim_in=S, dim_out=k, device="cpu")
        assert losses.decodes_in_kernel(many) == fused, k


def test_many_codes_through_the_logits_path():
    """A codebook past FUSED_MAX_K codes (a user's --tab_len 1024) takes
    the logits path; its twin holds to autograd of the composition."""
    k = 1024
    gen = torch.Generator().manual_seed(5)
    dec = SemanticDecoder.create(gen, dim_in=S, dim_out=k, device="cpu")
    rng = np.random.default_rng(5)
    lut = torch.tensor(rng.normal(0, 1, (k, C)), dtype=torch.float64)
    lut[9] = lut[600]                     # tied sim across the stride
    sem = torch.tensor(rng.normal(0, 1, (H * W, S)), dtype=torch.float64)
    gt = torch.tensor(rng.normal(0, 1, (C, H, W)), dtype=torch.float64)
    dec = dec.double()
    got = _run(losses.distillation_loss_rows, dec, lut, sem, _flat(gt), 2.0,
               impl="plain")
    want = _run(losses.distillation_loss_plain, dec, lut, sem, _flat(gt),
                2.0)
    assert not losses.decodes_in_kernel(dec)
    _assert_close(got[0], want[0], 1e-12, "terms")
    assert set(got[1]) == set(want[1])
    _assert_close(got[1], want[1], 1e-9, "grads")


def test_cpu_tensors_take_the_composition_and_count_it():
    """distillation_loss on CPU tensors is the composition, bit for bit,
    and counts its pixels as loss.plain while a profiler runs."""
    from torch.profiler import ProfilerActivity, profile
    dec = _decoder("one_layer")
    lut, sem, gt = _inputs("base")
    flat = _flat(gt)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got, _ = losses.distillation_loss(dec, lut, sem, flat, 1.0)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    want, _ = losses.distillation_loss_plain(dec, lut, sem, flat, 1.0)
    assert torch.equal(got, want)
    assert counters["loss.plain"] == sem.shape[0]
    assert "loss.fused" not in counters
