"""Gathers for monotone index streams: `table[:, idx]`, feature-major.

Counterpart of goi_tpu/raster/gather.py. The TPU version ran the gather
as a block-diagonal one-hot matmul; here a CUDA tensor goes to the
hand-written kernels of csrc/gather.cu, and a CPU tensor to the plain
versions.

`expand_gather` is what binning calls: the expansion's slot -> Gaussian
map fused with the gather of the Gaussians' columns. Its plain version
is the JAX package's formulation (an amax scatter of each Gaussian's
first slot, a cummax, `table[:, g]`, goi_tpu/raster/binning.py:414-423);
the kernel finds each slot's Gaussian by a search of the bases instead
(`slot_owners_search` is that formulation in plain PyTorch), which
gives the same stream bit for bit.

The public contract is kept: a feature-major (C, N) table, which may
carry the TPU version's SPAN + 128 pad columns (they are never read),
and an idx of any length M (no caller-side padding). The TPU version's
one-hot matmul, 128-aligned window and SPAN pad do not carry over.

`mono_rows` is the row-major, block-windowed gather of the JAX package's
micro-benchmark (examples/micro_sortpayload.py `_mono_kernel`): the
kernel csrc/mono_rows.cu on a CUDA tensor, `mono_rows_plain` on a CPU
tensor. goi_tpu_torch/examples/micro_sortpayload.py times it.
"""

from __future__ import annotations

import ctypes

import torch

from goi_tpu_torch.raster import _nvcc

_SIGNATURES = {
    "goi_monotone_gather": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "goi_expand_gather": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]}
VEC = 4   # slots a kernel thread stores at once (16 bytes)
_MONO_SIGNATURES = {"goi_mono_rows": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]}
MONO_B = 1024      # indices per block (the micro-benchmark's B)
MONO_SPAN = 2048   # table rows a block's window covers (its SPAN)


def monotone_gather_plain(table: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    return table[:, idx.long()]


def monotone_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (C, N) float32, idx (M,) int32 non-decreasing with dense
    coverage -> (C, M) == table[:, idx], bit-exact."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table (C, N) and idx (M,) expected, got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if not _nvcc.is_cuda(table):
        return monotone_gather_plain(table, idx)
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"float32 table and int32 idx expected, got "
                        f"{table.dtype} and {idx.dtype}")
    if not _nvcc.is_cuda(idx) or idx.device != table.device:
        raise ValueError("table and idx must be on the same CUDA device")
    lib = _nvcc.library("gather", _SIGNATURES)
    table = table.contiguous()
    idx = idx.contiguous()
    c, n = table.shape
    m = idx.shape[0]
    out = torch.empty((c, m), dtype=torch.float32, device=table.device)
    aligned = m % VEC == 0 and idx.data_ptr() % 16 == 0
    _nvcc.check(lib.goi_monotone_gather(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), c, n, m,
        int(aligned), _nvcc.stream()), "monotone_gather")
    monotone_gather.launches += 1
    return out


monotone_gather.launches = 0


def slot_owners(base: torch.Tensor, m: int) -> torch.Tensor:
    """g_stream of m slots, the JAX package's way: each Gaussian marks
    its first slot (bases clamped to m - 1; amax keeps the highest id
    where several clamp onto the last slot), then a running max."""
    n = base.shape[0]
    mark = torch.zeros(m, dtype=torch.long, device=base.device)
    mark.scatter_reduce_(0, torch.clamp(base, max=m - 1),
                         torch.arange(n, device=base.device), "amax")
    return torch.cummax(mark, 0).values.to(torch.int32)


def slot_owners_search(base: torch.Tensor, m: int) -> torch.Tensor:
    """The same stream as the kernel forms it: g(r) = (number of g with
    min(base[g], m - 1) <= r) - 1."""
    slots = torch.arange(m, device=base.device)
    cb = torch.clamp(base, max=m - 1)
    return (torch.searchsorted(cb, slots, right=True) - 1).to(torch.int32)


def expand_gather_plain(table: torch.Tensor, base: torch.Tensor, m: int):
    g_stream = slot_owners(base, m)
    return g_stream, table[:, g_stream.long()]


def expand_gather(table: torch.Tensor, base: torch.Tensor, m: int):
    """table (C, N) float32 per-Gaussian columns, base (N,) int64 the
    exclusive slot bases of counts >= 1 (cumsum(c) - c: non-decreasing,
    base[0] = 0, clamped to m - 1 here), m slots -> (g_stream (m,) int32,
    rows (C, m) float32 = table[:, g_stream]), bit-exact against
    `expand_gather_plain`."""
    if table.dim() != 2 or base.dim() != 1 or base.shape[0] != table.shape[1]:
        raise ValueError(f"table (C, N) and base (N,) expected, got "
                         f"{tuple(table.shape)} and {tuple(base.shape)}")
    if not 0 < m < 2 ** 31 or base.shape[0] == 0:
        raise ValueError(f"0 < m < 2^31 slots and N > 0 expected, got m={m}"
                         f" and N={base.shape[0]}")
    if not _nvcc.is_cuda(table):
        return expand_gather_plain(table, base, m)
    if table.dtype != torch.float32 or base.dtype != torch.int64:
        raise TypeError(f"float32 table and int64 base expected, got "
                        f"{table.dtype} and {base.dtype}")
    if not _nvcc.is_cuda(base) or base.device != table.device:
        raise ValueError("table and base must be on the same CUDA device")
    lib = _nvcc.library("gather", _SIGNATURES)
    table = table.contiguous()
    base = base.contiguous()
    c, n = table.shape
    g_stream = torch.empty(m, dtype=torch.int32, device=table.device)
    rows = torch.empty((c, m), dtype=torch.float32, device=table.device)
    _nvcc.check(lib.goi_expand_gather(
        table.data_ptr(), base.data_ptr(), g_stream.data_ptr(),
        rows.data_ptr(), c, n, m, int(m % VEC == 0), _nvcc.stream()),
        "expand_gather")
    expand_gather.launches += 1
    return g_stream, rows


expand_gather.launches = 0


def mono_rows_plain(table: torch.Tensor, idx: torch.Tensor,
                    blk: int = MONO_B, span: int = MONO_SPAN) -> torch.Tensor:
    n = table.shape[0]
    i = idx.long()
    lo = torch.clamp(i[::blk], max=n - span)
    local = i - lo.repeat_interleave(blk)[:i.shape[0]]
    ok = (local >= 0) & (local < span)
    return torch.where(ok[:, None], table[i],
                       torch.zeros((), dtype=table.dtype, device=table.device))


def mono_rows(table: torch.Tensor, idx: torch.Tensor, blk: int = MONO_B,
              span: int = MONO_SPAN) -> torch.Tensor:
    """table (n, C) float32 row-major, idx (m,) int32 non-decreasing ->
    (m, C): row i is table[idx[i]] when idx[i] lies in its block's window
    [lo, lo + span), lo = min(idx[i // blk * blk], n - span), else zero
    (the one-hot semantics of the TPU version), bit-exact."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table (n, C) and idx (m,) expected, got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if not _nvcc.is_cuda(table):
        return mono_rows_plain(table, idx, blk, span)
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"float32 table and int32 idx expected, got "
                        f"{table.dtype} and {idx.dtype}")
    if not _nvcc.is_cuda(idx) or idx.device != table.device:
        raise ValueError("table and idx must be on the same CUDA device")
    n, c = table.shape
    m = idx.shape[0]
    if max(n * c, m * c, m + blk, span) >= 2 ** 31 or blk <= 0 or span <= 0:
        raise ValueError(f"the kernel indexes in 32 bits: table "
                         f"{tuple(table.shape)}, {m} indices, blk {blk} and "
                         f"span {span} must stay under 2^31 (blk, span > 0)")
    lib = _nvcc.library("mono_rows", _MONO_SIGNATURES)
    table = table.contiguous()
    idx = idx.contiguous()
    out = torch.empty((m, c), dtype=torch.float32, device=table.device)
    # 16-byte copies when every row is whole float4s on 16-byte addresses
    vec = c % 4 == 0 and table.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    _nvcc.check(lib.goi_mono_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), c, n, m, blk, span,
        int(vec), _nvcc.stream()), "mono_rows")
    mono_rows.launches += 1
    return out


mono_rows.launches = 0
