"""Semantic distillation loss (the 4-term GOI objective).

Counterpart of goi_tpu/semantic/losses.py, the form of ref:train.py:142-167:

  sem_label = softmax(MLP(rendered S-dim feature))            (pixels, K)
  gtl       = L2-normalized ground-truth APE features         (pixels, C)
  sim       = gtl @ normalize(LUT)^T                          (pixels, K)
  label     = one-hot-ish argmax mask of sim (detached)
  lab  = 50 * MSE(sem_label, label)
  sl   = 1 - mean(max_k sim)
  sl1  = mean entropy of softmax(sim * t), t = 1 (<1000 iters) else 2
  recc = 1 - mean cos(LUT[argmax sem_label], gtl)
  total = lab + sl + 0.3*sl1 + recc

The normalizations keep the JAX package's eps guards (PARITY.md
deviation 6). Two choices keep the gradient equal to JAX's and the same
on every run: the max of sim is `amax`, whose gradient splits evenly
over tied codes as JAX's does (a codebook may hold duplicate rows), and
the picked LUT rows are a one-hot product, whose backward is a matmul
rather than an accumulating index_put_.

Two paths, chosen by `distillation_loss` from the tensors' device:
- `distillation_loss_plain`: the composition above under autograd, for
  CPU tensors;
- `distillation_loss_rows`: for CUDA tensors, one autograd Function
  around csrc/distill_loss.cu (`loss_rows_cuda`): the unit rows and sim
  = gtl @ u^T as one fp32 GEMM by the composition's own operations (sim
  bit for bit, so the codes tie as they do there), then one row kernel
  that computes every per-pixel quantity of the loss and, in the same
  pass, the gradients of the total (the decoder's logits inside the
  kernel for a one-layer decoder of input width <= FUSED_MAX_S and
  output width <= FUSED_MAX_K without norm_output, GOI's default; any
  other decoder runs in PyTorch to its logits, which a second row kernel
  reads, for any number of codes), and in the backward one fp32 GEMM
  dsim^T @ gtl and a small epilogue for the LUT's gradient (the
  derivation is in the kernel's source). The
  Function's plain twin, `_rows_plain`, computes the same closed form
  with PyTorch operations, for the tests on either device.
The Function's aux terms carry no gradient; its total's gradients are
computed only for the inputs that need one, scaled by grad_output. A
CUDA tensor always takes the kernel (or the wrapper raises). While a
profiler is active, the counters `loss.fused` and `loss.plain` add up
the pixels each path takes.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from goi_tpu_torch.raster import _nvcc
from goi_tpu_torch.semantic.codebook import SemanticDecoder, normalize_rows
from goi_tpu_torch.utils.profiling import count

TERMS = ("lab", "sl", "sl1", "recc")
ROW_BLOCKS = 264    # csrc/distill_loss.cu ROW_BLOCKS: partials' rows
FUSED_MAX_S = 32    # the widest decoder input the kernel decodes itself
FUSED_MAX_K = 320   # and the most codes it decodes (a thread a code)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "goi_distill_rows": [_P, _P, _P, _P, _LL, _LL, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _F, _F, _F, _F, _I, _I, _P],
    "goi_distill_finish": [_P, _I, _I, _I, _F, _F, _P, _P, _P, _P],
    "goi_distill_lut_grad": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                             _P, _P]}


def distillation_loss(
    decoder: SemanticDecoder,
    lut: torch.Tensor,          # (K, C) codebook
    sem_feature: torch.Tensor,  # (pixels, S) rendered semantic features
    gt_features: torch.Tensor,  # (pixels, C) APE features (unnormalized)
    anneal_t: float,            # 1.0 before iter 1000, else 2.0
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {lab, sl, sl1, recc, total}): the row kernel for CUDA
    tensors, the composition for CPU tensors (module docstring)."""
    if not _nvcc.is_cuda(sem_feature):
        count("loss.plain", sem_feature.shape[0])
        return distillation_loss_plain(decoder, lut, sem_feature,
                                       gt_features, anneal_t)
    count("loss.fused", sem_feature.shape[0])
    return distillation_loss_rows(decoder, lut, sem_feature, gt_features,
                                  anneal_t)


def distillation_loss_plain(
    decoder: SemanticDecoder, lut: torch.Tensor, sem_feature: torch.Tensor,
    gt_features: torch.Tensor, anneal_t: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The composition under autograd (module docstring)."""
    sem_label = torch.softmax(decoder(sem_feature), dim=-1)
    gtl = normalize_rows(gt_features)
    sim = gtl @ normalize_rows(lut).T                      # (pixels, K)

    sim_val = torch.amax(sim, dim=1, keepdim=True)
    label = (sim == sim_val).to(sim.dtype).detach()
    lab = torch.mean((sem_label - label) ** 2) * 50.0
    sl = 1.0 - torch.mean(sim_val)

    code = torch.argmax(sem_label, dim=-1, keepdim=True)
    one_hot = torch.zeros_like(sem_label).scatter_(1, code, 1.0)
    pick = one_hot @ lut                                   # (pixels, C)
    cos = torch.sum(pick * gtl, dim=-1) / (
        torch.linalg.norm(pick, dim=-1) * torch.linalg.norm(gtl, dim=-1)
        + 1e-12)
    recc = 1.0 - torch.mean(cos)

    anneal = sim * anneal_t
    b = torch.softmax(anneal, dim=1) * torch.log_softmax(anneal, dim=1)
    sl1 = -torch.mean(torch.sum(b, dim=-1))

    total = lab + sl + 0.3 * sl1 + recc
    return total, {"lab": lab, "sl": sl, "sl1": sl1, "recc": recc,
                   "total": total}


def decodes_in_kernel(decoder: SemanticDecoder) -> bool:
    """Whether the row kernel computes the decoder's logits itself: one
    linear layer of input width <= FUSED_MAX_S, output width <=
    FUSED_MAX_K and no output norm."""
    k, s = decoder.weights[0].shape
    return (decoder.num_layer == 1 and not decoder.norm_output
            and s <= FUSED_MAX_S and k <= FUSED_MAX_K)


def distillation_loss_rows(
    decoder: SemanticDecoder, lut: torch.Tensor, sem_feature: torch.Tensor,
    gt_features: torch.Tensor, anneal_t: float, impl: str = "kernel",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss through the row Function: impl "kernel" (CUDA tensors)
    or "plain" (its PyTorch twin, any device). The aux terms are 0-dim
    tensors with no gradient."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl 'kernel' or 'plain' expected, got {impl!r}")
    if decodes_in_kernel(decoder):
        x, w, b = sem_feature, decoder.weights[0], decoder.biases[0]
    else:
        x, w, b = decoder(sem_feature), None, None
    total, terms = _RowLoss.apply(x, w, b, lut, gt_features,
                                  float(anneal_t), torch.is_grad_enabled(),
                                  impl)
    aux = dict(zip(TERMS, terms.unbind()))
    aux["total"] = total
    return total, aux


@dataclasses.dataclass
class _Saved:
    """What a forward leaves its backward: gtl (P, C), u (K, C) and |L_k|
    (K,); dsim (P, K) when the LUT needs a gradient; dx, the gradient to
    the features (P, S) or to the logits (P, K); the sums of the per-code
    terms (the kernel's column layout, csrc/distill_loss.cu)."""
    gtl: torch.Tensor
    u: torch.Tensor
    lnorm: torch.Tensor
    dsim: Optional[torch.Tensor]
    dx: Optional[torch.Tensor]
    sums: torch.Tensor


def _unit_rows(gt: torch.Tensor, lut: torch.Tensor):
    """(|g_p| (P,), gtl, |L_k| (K,), u): normalize_rows' own operations,
    so that gtl @ u^T is the composition's sim bit for bit."""
    gn = torch.linalg.norm(gt, dim=1, keepdim=True)
    ln = torch.linalg.norm(lut, dim=1, keepdim=True)
    return (gn[:, 0], gt / torch.clamp(gn, min=1e-8), ln[:, 0],
            lut / torch.clamp(ln, min=1e-8))


class _RowLoss(torch.autograd.Function):
    """The loss by rows (module docstring); its gradients come from the
    forward's one pass over the rows, scaled by grad_output."""

    @staticmethod
    def forward(ctx, x, w, b, lut, gt, anneal_t, grad_on, impl):
        need = [bool(grad_on and n) for n in ctx.needs_input_grad[:5]]
        if need[4]:
            raise ValueError("distillation_loss: the row path gives no "
                             "gradient to the ground-truth features")
        rows = loss_rows_cuda if impl == "kernel" else _rows_plain
        total, terms, saved = rows(x, w, b, lut, gt, anneal_t,
                                   grad_x=need[0], grad_w=need[1] or need[2],
                                   grad_lut=need[3])
        # the outputs stay out of ctx: a reference to them from their own
        # node would keep every step's buffers alive until a GC pass
        ctx.impl, ctx.need, ctx.saved = impl, need, saved
        ctx.s = 0 if w is None else w.shape[1]
        ctx.save_for_backward(lut)
        ctx.mark_non_differentiable(terms)
        return total, terms

    @staticmethod
    def backward(ctx, g_total, _):
        lut, = ctx.saved_tensors
        out, need = ctx.saved, ctx.need
        g = g_total.reshape(()).to(torch.float32).contiguous()
        dx = out.dx * g if need[0] else None
        dw = db = dlut = None
        if need[1] or need[2] or need[3]:
            r = out.dsim.t() @ out.gtl if need[3] else None
            epilogue = _epilogue_cuda if ctx.impl == "kernel" else \
                _epilogue_plain
            dlut, dw, db = epilogue(out, lut, r, g, ctx.s, need)
        return dx, dw, db, dlut, None, None, None, None


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _constants(p: int, k: int, anneal_t: float):
    """The kernel's float constants: 1/P, 100/(P K) (lab's gradient),
    0.3 t / P (sl1's), 1/(P K) (lab's mean)."""
    return 1.0 / p, 100.0 / (p * k), 0.3 * anneal_t / p, 1.0 / (p * k)


def _check_kernel_inputs(x, w, b, lut, gt):
    dev = lut.device
    named = {"features" if w is not None else "logits": x, "weight": w,
             "bias": b, "lut": lut, "gt_features": gt}
    for name, t in named.items():
        if t is None:
            continue
        if not _nvcc.is_cuda(t) or t.device != dev:
            raise ValueError(f"distillation_loss kernel: {name} must be on "
                             f"the CUDA device of the LUT ({dev}), got "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"distillation_loss kernel: float32 {name} "
                            f"expected, got {t.dtype}")
    p, (k, c) = x.shape[0], lut.shape
    if gt.dim() != 2 or gt.shape != (p, c) or p == 0:
        raise ValueError(f"distillation_loss kernel: gt_features ({p}, {c})"
                         f" with P > 0 expected, got {tuple(gt.shape)}")
    if k == 0:
        raise ValueError("distillation_loss kernel: a codebook of at least "
                         "one code expected")
    if w is None and x.shape != (p, k):
        raise ValueError(f"distillation_loss kernel: logits ({p}, {k}) "
                         f"expected, got {tuple(x.shape)}")
    if w is not None and (w.shape != (k, x.shape[1]) or x.shape[1] == 0
                          or x.shape[1] > FUSED_MAX_S or k > FUSED_MAX_K
                          or (b is not None and b.shape != (k,))):
        raise ValueError(f"distillation_loss kernel: features (P, S <= "
                         f"{FUSED_MAX_S}), weight (K <= {FUSED_MAX_K}, S) "
                         f"and bias (K,) expected, got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if p >= 2 ** 31:
        raise ValueError(f"distillation_loss kernel: {p} pixels are too "
                         f"many")


def loss_rows_cuda(x, w, b, lut, gt, anneal_t, *, grad_x, grad_w,
                   grad_lut):
    """The forward on the card: the unit rows and sim = gtl @ u^T in
    PyTorch (the composition's operations), the row kernel (one launch;
    `launches` counts them) and the sums of its partials. The gradients
    asked for are computed in the same pass at grad_output 1. Returns
    (total, terms, _Saved)."""
    _check_kernel_inputs(x, w, b, lut, gt)
    lib = _nvcc.library("distill_loss", _SIGNATURES)
    p, k = x.shape[0], lut.shape[0]
    fused = w is not None
    s = x.shape[1] if fused else 0
    dev = lut.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    gnorm, gtl, lnorm, u = _unit_rows(gt, lut)
    sim = (gtl @ u.T).contiguous()           # fp32, overwritten by dsim
    inv_p, c_lab, c_sl1, inv_pk = _constants(p, k, anneal_t)
    ncol = 4 + k * (s + 3)
    part = empty(ROW_BLOCKS * ncol)
    dsem = dlogits = logits = None
    if fused:
        w = w.contiguous()
        b = None if b is None else b.contiguous()
        if grad_x:
            dsem = empty(s, p)
    else:
        logits = x.contiguous()
        if grad_x:
            dlogits = empty(p, k)
    stream = _nvcc.stream()
    _nvcc.check(lib.goi_distill_rows(
        sim.data_ptr(), _ptr(logits), _ptr(dlogits),
        x.data_ptr() if fused else None, x.stride(0) if fused else 0,
        x.stride(1) if fused else 0, _ptr(w), _ptr(b), _ptr(dsem),
        gnorm.contiguous().data_ptr(), lnorm.contiguous().data_ptr(),
        part.data_ptr(), p, k, s, anneal_t, inv_p, c_lab, c_sl1,
        int(grad_lut), int(grad_w), stream), "distill_loss rows")
    loss_rows_cuda.launches += 1
    sums = empty(ncol if (grad_w or grad_lut) else 4)
    total, terms = empty(), empty(4)
    _nvcc.check(lib.goi_distill_finish(
        part.data_ptr(), p, ncol, sums.numel(), inv_p, inv_pk,
        sums.data_ptr(), total.data_ptr(), terms.data_ptr(), stream),
        "distill_loss finish")
    dx = dsem.t() if dsem is not None else dlogits
    return total, terms, _Saved(gtl=gtl, u=u, lnorm=lnorm,
                                dsim=sim if grad_lut else None, dx=dx,
                                sums=sums)


loss_rows_cuda.launches = 0


def _epilogue_cuda(out: _Saved, lut, r, g, s, need):
    """dL from R = dsim^T gtl, and dW, db: one launch, scaled by g."""
    lib = _nvcc.library("distill_loss", _SIGNATURES)
    k, c = lut.shape
    dev = lut.device

    def maybe(flag, *shape):
        return torch.empty(shape, dtype=torch.float32, device=dev) \
            if flag else None

    dlut, dw, db = maybe(need[3], k, c), maybe(need[1], k, s), \
        maybe(need[2], k)
    _nvcc.check(lib.goi_distill_lut_grad(
        _ptr(r), out.u.contiguous().data_ptr(), lut.contiguous().data_ptr(),
        out.lnorm.contiguous().data_ptr(), out.sums.data_ptr(), k, c, s,
        g.data_ptr(), _ptr(dlut), _ptr(dw), _ptr(db), _nvcc.stream()),
        "distill_loss grad")
    return dlut, dw, db


def _rows_plain(x, w, b, lut, gt, anneal_t, *, grad_x, grad_w,
                grad_lut):
    """loss_rows_cuda's closed form in PyTorch operations (any device):
    the same quantities, association aside."""
    p, k = x.shape[0], lut.shape[0]
    inv_p, c_lab, c_sl1, inv_pk = _constants(p, k, anneal_t)
    gnorm, gtl, lnorm, u = _unit_rows(gt, lut)
    n = torch.clamp(lnorm, min=1e-8)
    gunit = gnorm / torch.clamp(gnorm, min=1e-8)
    sim = gtl @ u.T
    z = x
    if w is not None:
        z = x @ w.T
        if b is not None:
            z = z + b
    q = torch.softmax(z, dim=1)
    code = torch.argmax(q, dim=1, keepdim=True)
    smax = torch.amax(sim, dim=1, keepdim=True)
    label = (sim == smax).to(sim.dtype)
    a = sim * anneal_t
    ls = torch.log_softmax(a, dim=1)
    p2 = torch.softmax(a, dim=1)
    h = -(p2 * ls).sum(1, keepdim=True)
    sc = sim.gather(1, code)[:, 0]
    nc = n[code[:, 0]]
    num = nc * sc
    den = lnorm[code[:, 0]] * gunit + 1e-12
    loss = torch.stack([((q - label) ** 2).sum(), smax.sum(), h.sum(),
                        (num / den).sum()])
    lab = loss[0] * inv_pk * 50.0
    terms = torch.stack([lab, 1.0 - loss[1] * inv_p, loss[2] * inv_p,
                         1.0 - loss[3] * inv_p])
    total = terms[0] + terms[1] + 0.3 * terms[2] + terms[3]
    s = 0 if w is None else w.shape[1]
    sums = torch.zeros(4 + k * (s + 3), dtype=x.dtype, device=x.device)
    dsim = dx = None
    if grad_lut:
        one_hot = torch.zeros_like(sim).scatter_(1, code, 1.0)
        alpha = -inv_p / den
        dsim = (-label * (inv_p / label.sum(1, keepdim=True))
                - c_sl1 * p2 * (ls + h) + one_hot * (alpha * nc)[:, None])
        cdb = 4 + k * s
        sums[cdb + k:cdb + 2 * k] = one_hot.T @ (alpha * sc)
        sums[cdb + 2 * k:] = one_hot.T @ (inv_p * num * gunit / den ** 2)
    if grad_x or grad_w:
        dq = c_lab * (q - label)
        dz = q * (dq - (q * dq).sum(1, keepdim=True))
        if w is None:
            dx = dz
        else:
            dx = dz @ w
            sums[4:4 + k * s] = (dz.T @ x).reshape(-1)
            sums[4 + k * s:4 + k * s + k] = dz.sum(0)
    return total, terms, _Saved(gtl=gtl, u=u, lnorm=lnorm, dsim=dsim,
                                dx=dx, sums=sums)


def _epilogue_plain(out: _Saved, lut, r, g, s, need):
    """_epilogue_cuda's closed form in PyTorch operations."""
    k = lut.shape[0]
    sums = out.sums
    cdb = 4 + k * s
    dw = g * sums[4:4 + k * s].reshape(k, s) if need[1] else None
    db = g * sums[cdb:cdb + k] if need[2] else None
    dlut = None
    if need[3]:
        u, ln = out.u, out.lnorm[:, None]
        n = torch.clamp(ln, min=1e-8)
        a_k, b_k = sums[cdb + k:cdb + 2 * k, None], sums[cdb + 2 * k:, None]
        dot = (u * r).sum(1, keepdim=True)
        v = torch.where(ln >= 1e-8, (r - u * dot) / n + u * a_k, r / n)
        bl = torch.where(ln > 0, b_k / torch.where(ln > 0, ln, 1.0), 0.0)
        dlut = g * (v + bl * lut)
    return dlut, dw, db
