"""Instance -> Gaussian gradient reductions, deterministic on every device.

Counterpart of goi_tpu/raster/pallas_blend.py `_reduce_transported`,
`_reduce_transported_chain`, `_blocked_segment_reduce` and
`_prefix_blocks`. The blend backward (csrc/blend_bwd.cu) leaves one
gradient row per sorted instance position; both reductions put the rows
in Gaussian-major order by one permutation and sum each Gaussian's run
with `blocked_segment_reduce`:

- 'chain': the binning's sort permutation (`sort_slots[p]` = expansion
  slot of sorted position p) scatters the rows into expansion order,
  where Gaussian g owns slots [bounds[g], bounds[g + 1]);
- 'scatter': a stable sort of the rows by Gaussian id, with the runs'
  bounds from a binary search.

The sums never use float atomics (`index_add_`, `scatter_add_`,
accumulating `index_put_` on CUDA), so a backward gives the same bits on
every run. The block prefix is the hand-written CUDA kernel
csrc/prefix.cu on a CUDA tensor and `prefix_blocks_plain` on a CPU
tensor. The TPU's pad fill, payload sort and row mask (its rows were
indexed by (tile, chunk)) do not carry over: the port's rows are indexed
by sorted position, and rows past the kept instances are zero, so the
reduces pass no mask to the prefix (the kernel still takes one, as the
TPU kernel did).

`dense_boundary_reduce` (`RasterConfig.dense_reduce`, the counterpart of
`_dense_boundary_reduce`) gives blocked_segment_reduce's bits with the
prefix and its read-out at the bounds fused into csrc/prefix_boundary.cu
(`prefix_boundary`; `prefix_boundary_plain` on a CPU tensor).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from goi_tpu_torch.raster import _nvcc

CUMSUM_BLOCK = 512   # rows per prefix block (the JAX package's choice)
SUB = 128            # smallest block; other sizes are padded to it

_SIGNATURES = {"goi_prefix_blocks": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]}
_BOUNDARY_SIGNATURES = {"goi_prefix_boundary": [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p]}


def prefix_blocks_plain(rows: torch.Tensor, okf: Optional[torch.Tensor],
                        blk: int):
    """Plain version of the kernel: (block-local exclusive prefixes
    ((nb + 1) * blk, d) with a trailing zero block, block totals (nb, d))."""
    m, d = rows.shape
    nb = m // blk
    x = rows if okf is None else rows * okf.reshape(m, 1)
    incl = torch.cumsum(x.reshape(nb, blk, d), dim=1)
    inner = torch.zeros((nb + 1, blk, d), dtype=rows.dtype,
                        device=rows.device)
    inner[:nb, 1:] = incl[:, :-1]
    return inner.reshape((nb + 1) * blk, d), incl[:, -1]


def prefix_blocks(rows: torch.Tensor, okf: Optional[torch.Tensor] = None,
                  blk: int = CUMSUM_BLOCK):
    """rows (nb * blk, d) float32 [okf (nb * blk,) or (nb * blk, 1)
    float32 row mask] -> (block-local exclusive prefixes
    ((nb + 1) * blk, d) with a trailing zero block, block totals (nb, d))."""
    if rows.dim() != 2 or rows.shape[0] % blk or blk % 32:
        raise ValueError(f"rows (nb * {blk}, d) with blk a multiple of 32 "
                         f"expected, got {tuple(rows.shape)}")
    if okf is not None and okf.numel() != rows.shape[0]:
        raise ValueError("okf needs one entry per row")
    if not _nvcc.is_cuda(rows):
        return prefix_blocks_plain(rows, okf, blk)
    if rows.dtype != torch.float32 or (okf is not None
                                       and okf.dtype != torch.float32):
        raise TypeError("float32 rows and okf expected")
    if okf is not None and okf.device != rows.device:
        raise ValueError("rows and okf must be on the same CUDA device")
    lib = _nvcc.library("prefix", _SIGNATURES)
    rows = rows.contiguous()
    okf = None if okf is None else okf.contiguous()
    m, d = rows.shape
    nb = m // blk
    inner = torch.empty(((nb + 1) * blk, d), dtype=torch.float32,
                        device=rows.device)
    tot = torch.empty((nb, d), dtype=torch.float32, device=rows.device)
    _nvcc.check(lib.goi_prefix_blocks(
        rows.data_ptr(), None if okf is None else okf.data_ptr(), d, nb, blk,
        inner.data_ptr(), tot.data_ptr(), _nvcc.stream()), "prefix_blocks")
    prefix_blocks.launches += 1
    return inner, tot


prefix_blocks.launches = 0


def _block_owner_sums(tot: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(n, d) sums of the block totals tot[b], b in [q[g], q[g + 1]), for
    non-decreasing q: a segmented inclusive scan over the blocks (each
    block has one owner, so the owners' runs are the segments), read at
    each run's last block. Hillis-Steele steps of adds within one
    segment: deterministic, and the rounding scales with the segment's
    own sum (no difference of larger prefixes)."""
    nb = tot.shape[0]
    owner = torch.searchsorted(q, torch.arange(nb, device=q.device),
                               right=True)
    x = tot
    head = torch.ones(nb, dtype=torch.bool, device=tot.device)
    head[1:] = owner[1:] != owner[:-1]
    off = 1
    while off < nb:
        x = torch.cat([x[:off], torch.where(head[off:, None], x[off:],
                                            x[off:] + x[:-off])])
        head = torch.cat([head[:off], head[off:] | head[:-off]])
        off *= 2
    last = torch.clamp(q[1:] - 1, min=0)
    return torch.where((q[1:] > q[:-1])[:, None], x[last],
                       torch.zeros_like(x[last]))


def prefix_boundary_plain(rows: torch.Tensor, p: torch.Tensor, blk: int):
    """Plain version of the kernel: (the block-local exclusive prefix at
    each row p[g], zero at the stream's end nb * blk (n + 1, d), block
    totals (nb, d))."""
    inner, tot = prefix_blocks_plain(rows, None, blk)
    return inner[p.long()], tot


def prefix_boundary(rows: torch.Tensor, p: torch.Tensor,
                    blk: int = CUMSUM_BLOCK):
    """rows (nb * blk, d) float32, p (n + 1,) int64 non-decreasing in
    [0, nb * blk] -> (lb (n + 1, d) = prefix_blocks(rows)[0][p], block
    totals (nb, d)), without writing the full prefix."""
    if rows.dim() != 2 or rows.shape[0] % blk or blk % 32:
        raise ValueError(f"rows (nb * {blk}, d) with blk a multiple of 32 "
                         f"expected, got {tuple(rows.shape)}")
    if p.dim() != 1:
        raise ValueError(f"p (n + 1,) expected, got {tuple(p.shape)}")
    if not _nvcc.is_cuda(rows):
        return prefix_boundary_plain(rows, p, blk)
    if rows.dtype != torch.float32 or p.dtype != torch.int64:
        raise TypeError("float32 rows and int64 p expected")
    if p.device != rows.device:
        raise ValueError("rows and p must be on the same CUDA device")
    lib = _nvcc.library("prefix_boundary", _BOUNDARY_SIGNATURES)
    rows = rows.contiguous()
    p = p.contiguous()
    m, d = rows.shape
    nb = m // blk
    lb = torch.empty((p.shape[0], d), dtype=torch.float32,
                     device=rows.device)
    tot = torch.empty((nb, d), dtype=torch.float32, device=rows.device)
    _nvcc.check(lib.goi_prefix_boundary(
        rows.data_ptr(), d, nb, blk, p.data_ptr(), p.shape[0], lb.data_ptr(),
        tot.data_ptr(), _nvcc.stream()), "prefix_boundary")
    prefix_boundary.launches += 1
    return lb, tot


prefix_boundary.launches = 0


def _blocked(rows: torch.Tensor, bounds: torch.Tensor):
    """rows padded to a whole number of blocks, the block size, and the
    bounds clamped to the unpadded length m."""
    m = rows.shape[0]
    blk = next(b for b in (CUMSUM_BLOCK, 256, SUB) if m % b == 0
               or b == SUB)
    if m % blk:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, -m % blk))
    return rows, blk, torch.clamp(bounds.long(), max=m)


def blocked_segment_reduce(rows: torch.Tensor, bounds: torch.Tensor):
    """Per-segment sums of Gaussian-major rows with block-local error.

    rows (m, d); bounds (n + 1,) non-decreasing segment boundaries
    (clamped to m here). Returns (n, d) with

      seg(g) = L[p_g+1] - L[p_g] + sum of tot[b], b in [p_g // B, p_g+1 // B)

    where L is the block-local exclusive prefix and tot the block totals
    (B rows a block): no quantity of the stream's global magnitude is
    ever formed (PARITY.md deviation 9)."""
    rows, blk, p = _blocked(rows, bounds)
    inner, tot = prefix_blocks(rows, None, blk)
    lb = inner[p]
    return lb[1:] - lb[:-1] + _block_owner_sums(tot, p // blk)


def dense_boundary_reduce(rows: torch.Tensor, bounds: torch.Tensor):
    """blocked_segment_reduce with the prefix and the read-out of L at
    the bounds fused into one kernel (csrc/prefix_boundary.cu): the
    same values, bit for bit, without the (m, d) prefix round trip.
    Bounds may repeat (the chain's clamp under a budget overflow)."""
    rows, blk, p = _blocked(rows, bounds)
    lb, tot = prefix_boundary(rows, p, blk)
    return lb[1:] - lb[:-1] + _block_owner_sums(tot, p // blk)


def reduce_chain(rows: torch.Tensor, sort_slots: torch.Tensor,
                 bounds: torch.Tensor, dense: bool = False) -> torch.Tensor:
    """rows (m, d) by sorted position -> (n, d) per-Gaussian sums:
    scattered into expansion order by the sort permutation (each
    destination written once), then summed over bounds
    (dense_boundary_reduce if `dense`, else blocked_segment_reduce: the
    same bits)."""
    stream = torch.empty_like(rows)
    stream[sort_slots.long()] = rows
    if dense:
        return dense_boundary_reduce(stream, bounds)
    return blocked_segment_reduce(stream, bounds)


def reduce_scatter(rows: torch.Tensor, gid: torch.Tensor,
                   n_gauss: int) -> torch.Tensor:
    """rows (m, d) by sorted position, gid (m,) their Gaussian ids ->
    (n_gauss, d) sums by id (zero rows may carry any id)."""
    order = torch.argsort(gid, stable=True)
    keys = gid[order].contiguous()
    bounds = torch.searchsorted(
        keys, torch.arange(n_gauss + 1, dtype=keys.dtype,
                           device=keys.device))
    return blocked_segment_reduce(rows[order], bounds)
