"""Gather for monotone index streams: `table[:, idx]`, feature-major.

Counterpart of goi_tpu/raster/gather.py. The TPU version ran the gather
as a block-diagonal one-hot matmul; here a CUDA tensor goes to the
hand-written kernel csrc/gather.cu (one thread per output element), and
a CPU tensor to the plain version `table[:, idx]`.

The public contract is kept: a feature-major (C, N) table, which may
carry the TPU version's SPAN + 128 pad columns (they are never read),
and an idx of any length M (no caller-side padding). The TPU version's
one-hot matmul, 128-aligned window and SPAN pad do not carry over.
"""

from __future__ import annotations

import ctypes

import torch

from goi_tpu_torch.raster import _nvcc

_SIGNATURES = {"goi_monotone_gather": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]}


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
