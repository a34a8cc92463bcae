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
every run. Two hand-written CUDA kernels do the 'chain' sum on a CUDA
tensor, their plain versions on a CPU tensor: the block prefix
(csrc/prefix.cu, `prefix_blocks_plain`), then the read-out of the
prefix at the bounds with each segment's whole-block term
(csrc/owner_sums.cu `owner_sums`, `owner_sums_plain`: one fp32 sum of
the block totals in ascending block order, the counterpart of the JAX
package's `jax.ops.segment_sum` over the blocks' owners). The TPU's pad
fill, payload sort and row mask (its rows were indexed by (tile,
chunk)) do not carry over: the port's rows are indexed by sorted
position, and rows past the kept instances are zero, so the reduces pass
no mask to the prefix (the kernel still takes one, as the TPU kernel
did).

`dense_boundary_reduce` (`RasterConfig.dense_reduce`, the counterpart of
`_dense_boundary_reduce`) gives blocked_segment_reduce's bits with the
prefix and its read-out at the bounds fused into csrc/prefix_boundary.cu
(`prefix_boundary`; `prefix_boundary_plain` on a CPU tensor), whose
read-out `owner_sums` takes as it is. Its blocks find their bounds in a
first-bound table (`block_first_bounds_plain` is the table's plain
twin).

Both prefix kernels keep a block's (blk, d) rows in shared memory, so rows
wider than fits (d > 106 at blk = 512, as a trace of more than 105
channels gives) are scanned in column slices, one launch each: every
column's scan is its own, so the bits are those of one launch.
`prefix_blocks` brings rows in and out through a ring of stages where
the ring fits beside the scan buffer (d <= 36 at blk = 512) and loads
and stores them directly past that, in the same launch.
`owner_sums` keeps nothing in shared memory and takes any width in one
launch.
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
_BOUNDARY_SIGNATURES = {
    "goi_first_bounds": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    "goi_prefix_boundary": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]}
_OWNER_SIGNATURES = {"goi_owner_sums": [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p]}


def column_slices(d: int, blk: int, smem: int):
    """[c0, c1) column slices of (blk, d) row blocks, as few and as even
    as fit `smem` bytes of one CTA's shared memory (4 (blk + 33) bytes a
    column, csrc/block_scan.cuh smem_bytes)."""
    per = smem // (4 * (blk + 33))
    k = -(-d // per)
    step = -(-d // k)
    return [(c0, min(c0 + step, d)) for c0 in range(0, d, step)]


def _by_column_slices(launch, rows: torch.Tensor, blk: int):
    """launch(part) -> (a, b) for each column slice of rows, joined along
    the columns; the slices fit the shared memory a CTA may opt in to on
    rows' device (227 KB on the H100)."""
    smem = torch.cuda.get_device_properties(
        rows.device).shared_memory_per_block_optin
    parts = [launch(rows[:, c0:c1].contiguous())
             for c0, c1 in column_slices(rows.shape[1], blk, smem)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(x, 1) for x in zip(*parts))


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
    okf = None if okf is None else okf.contiguous()
    m, d = rows.shape
    if (m + blk) * d >= 2 ** 31:
        raise ValueError(f"the kernel indexes in 32 bits: rows "
                         f"{tuple(rows.shape)} are too many")
    lib = _nvcc.library("prefix", _SIGNATURES)
    nb = m // blk

    def launch(part):
        # the kernel's bulk copies read whole blocks from 16-byte
        # boundaries: the tensors it is given (a view that is not
        # contiguous is copied first)
        for name, t in (("rows", part), ("okf", okf)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary "
                                 f"for the kernel's bulk copies")
        d = part.shape[1]
        inner = torch.empty(((nb + 1) * blk, d), dtype=torch.float32,
                            device=rows.device)
        tot = torch.empty((nb, d), dtype=torch.float32, device=rows.device)
        _nvcc.check(lib.goi_prefix_blocks(
            part.data_ptr(), None if okf is None else okf.data_ptr(), d, nb,
            blk, inner.data_ptr(), tot.data_ptr(), _nvcc.stream()),
            "prefix_blocks")
        prefix_blocks.launches += 1
        return inner, tot
    return _by_column_slices(launch, rows, blk)


prefix_blocks.launches = 0


def block_first_bounds_plain(p: torch.Tensor, nb: int,
                             blk: int) -> torch.Tensor:
    """Plain version of csrc/prefix_boundary.cu's first-bound table:
    (nb + 2,) int32 with first[b] = the number of bounds p[g] < b * blk
    (blocks [first[b], first[b + 1]) of p lie in row block b; block nb
    holds the bounds at the stream's end nb * blk), counted per block and
    summed."""
    per_block = torch.bincount(p.long() // blk, minlength=nb + 1)
    return torch.cat([per_block.new_zeros(1),
                      torch.cumsum(per_block[:nb + 1], 0)]).to(torch.int32)


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
    m, d = rows.shape
    if max(rows.numel(), p.shape[0] * d, m + blk) >= 2 ** 31:
        raise ValueError(f"the kernel indexes in 32 bits: rows "
                         f"{tuple(rows.shape)} and {p.shape[0]} bounds are "
                         f"too many")
    lib = _nvcc.library("prefix_boundary", _BOUNDARY_SIGNATURES)
    p = p.contiguous()
    nb = m // blk
    # the first-bound table, one launch per call; the count below counts
    # the prefix kernel's launches, one per column slice
    first = torch.empty(nb + 2, dtype=torch.int32, device=rows.device)
    _nvcc.check(lib.goi_first_bounds(p.data_ptr(), p.shape[0], nb, blk,
                                     first.data_ptr(), _nvcc.stream()),
                "prefix_boundary first-bound table")

    def launch(part):
        d = part.shape[1]
        lb = torch.empty((p.shape[0], d), dtype=torch.float32,
                         device=rows.device)
        tot = torch.empty((nb, d), dtype=torch.float32, device=rows.device)
        _nvcc.check(lib.goi_prefix_boundary(
            part.data_ptr(), d, nb, blk, p.data_ptr(), p.shape[0],
            first.data_ptr(), lb.data_ptr(), tot.data_ptr(),
            _nvcc.stream()), "prefix_boundary")
        prefix_boundary.launches += 1
        return lb, tot
    return _by_column_slices(launch, rows, blk)


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


def owner_sums_plain(prefix: torch.Tensor, p: torch.Tensor,
                     tot: torch.Tensor, blk: int, indexed: bool):
    """Plain version of the kernel: (n, d) with row g = (prefix[hi] -
    prefix[lo]) + the block totals tot[b], b in [p[g] // blk, p[g + 1] //
    blk), added one block at a time in ascending b to a sum from +0.0
    ((lo, hi) = (p[g], p[g + 1]) if `indexed`, else (g, g + 1)). A
    segment past its last block adds +0.0, which leaves such a sum as it
    is, so every segment's sum is the kernel's."""
    p = p.long()
    q = p // blk
    span = (q[1:] - q[:-1])[:, None]
    acc = torch.zeros((span.shape[0], tot.shape[1]), dtype=tot.dtype,
                      device=tot.device)
    last = max(tot.shape[0] - 1, 0)
    for k in range(int(span.max()) if span.numel() else 0):
        acc = acc + torch.where(k < span,
                                tot[torch.clamp(q[:-1] + k, max=last)], 0.0)
    if indexed:
        return (prefix[p[1:]] - prefix[p[:-1]]) + acc
    return (prefix[1:] - prefix[:-1]) + acc


def owner_sums(prefix: torch.Tensor, p: torch.Tensor, tot: torch.Tensor,
               blk: int, indexed: bool):
    """The per-segment sums of blocked_segment_reduce from a block prefix:
    prefix ((nb + 1) * blk, d) float32, every row's block-local exclusive
    prefix (prefix_blocks' inner) if `indexed`, else (n + 1, d) already
    read out at the bounds (prefix_boundary's lb); p (n + 1,) int64
    non-decreasing in [0, nb * blk]; tot (nb, d) the block totals ->
    (n, d), row g = (L[p[g + 1]] - L[p[g]]) + the totals of the whole
    blocks in [p[g] // blk, p[g + 1] // blk), summed in ascending block
    order."""
    if prefix.dim() != 2 or tot.dim() != 2 or p.dim() != 1 \
            or prefix.shape[1] != tot.shape[1]:
        raise ValueError(f"prefix (rows, d), p (n + 1,) and tot (nb, d) "
                         f"expected, got {tuple(prefix.shape)}, "
                         f"{tuple(p.shape)}, {tuple(tot.shape)}")
    if not _nvcc.is_cuda(prefix):
        return owner_sums_plain(prefix, p, tot, blk, indexed)
    if prefix.dtype != torch.float32 or tot.dtype != torch.float32 \
            or p.dtype != torch.int64:
        raise TypeError("float32 prefix and tot, int64 p expected")
    if p.device != prefix.device or tot.device != prefix.device:
        raise ValueError("prefix, p and tot must be on the same CUDA device")
    n, d = p.shape[0] - 1, prefix.shape[1]
    if max(prefix.numel(), tot.numel(), p.shape[0] * d) >= 2 ** 31:
        raise ValueError(f"the kernel indexes in 32 bits: prefix "
                         f"{tuple(prefix.shape)} and {p.shape[0]} bounds "
                         f"are too many")
    lib = _nvcc.library("owner_sums", _OWNER_SIGNATURES)
    prefix, p, tot = prefix.contiguous(), p.contiguous(), tot.contiguous()
    out = torch.empty((n, d), dtype=torch.float32, device=prefix.device)
    if n * d == 0:
        return out
    _nvcc.check(lib.goi_owner_sums(
        prefix.data_ptr(), int(indexed), p.data_ptr(), n, d, tot.data_ptr(),
        blk, out.data_ptr(), _nvcc.stream()), "owner_sums")
    owner_sums.launches += 1
    return out


owner_sums.launches = 0


def blocked_segment_reduce(rows: torch.Tensor, bounds: torch.Tensor):
    """Per-segment sums of Gaussian-major rows with block-local error.

    rows (m, d); bounds (n + 1,) non-decreasing segment boundaries
    (clamped to m here). Returns (n, d) with

      seg(g) = (L[p_g+1] - L[p_g]) + sum of tot[b], b in [p_g // B, p_g+1 // B)

    where L is the block-local exclusive prefix and tot the block totals
    (B rows a block; the block term summed in ascending b): no quantity
    of the stream's global magnitude is ever formed (PARITY.md deviation
    9)."""
    rows, blk, p = _blocked(rows, bounds)
    inner, tot = prefix_blocks(rows, None, blk)
    return owner_sums(inner, p, tot, blk, indexed=True)


def dense_boundary_reduce(rows: torch.Tensor, bounds: torch.Tensor):
    """blocked_segment_reduce with the prefix and the read-out of L at
    the bounds fused into one kernel (csrc/prefix_boundary.cu): the
    same values, bit for bit, without the (m, d) prefix round trip.
    Bounds may repeat (the chain's clamp under a budget overflow)."""
    rows, blk, p = _blocked(rows, bounds)
    lb, tot = prefix_boundary(rows, p, blk)
    return owner_sums(lb, p, tot, blk, indexed=False)


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
    (n_gauss, d) sums by id (zero rows may carry any id): the rows in a
    stable order of their ids, each id's run bounded by a binary search."""
    order = torch.argsort(gid, stable=True)
    keys = gid[order].contiguous()
    bounds = torch.searchsorted(
        keys, torch.arange(n_gauss + 1, dtype=keys.dtype,
                           device=keys.device))
    return blocked_segment_reduce(rows[order], bounds)
