"""Gather for monotone index streams: `table[:, idx]`, feature-major.

Counterpart of goi_tpu/raster/gather.py. The TPU version ran the gather
as a block-diagonal one-hot matmul; here a CUDA tensor goes to the
hand-written kernel csrc/gather.cu (one thread per output element), and
a CPU tensor to the plain version `table[:, idx]`.

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

_SIGNATURES = {"goi_monotone_gather": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]}
_MONO_SIGNATURES = {"goi_mono_rows": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
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
    _nvcc.check(lib.goi_monotone_gather(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), c, n, m,
        _nvcc.stream()), "monotone_gather")
    monotone_gather.launches += 1
    return out


monotone_gather.launches = 0


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
    lib = _nvcc.library("mono_rows", _MONO_SIGNATURES)
    table = table.contiguous()
    idx = idx.contiguous()
    n, c = table.shape
    m = idx.shape[0]
    out = torch.empty((m, c), dtype=torch.float32, device=table.device)
    _nvcc.check(lib.goi_mono_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), c, n, m, blk, span,
        _nvcc.stream()), "mono_rows")
    mono_rows.launches += 1
    return out


mono_rows.launches = 0
