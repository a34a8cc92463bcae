"""Collectives with the gradients the sharded render needs.

JAX's shard_map transposes its collectives for free; here each one that
carries a gradient is a torch.autograd.Function:

- `all_gather_rows` (the splat gather): forward, the ranks' (n, ...)
  rows concatenated in rank order; backward, the transpose of
  jax.lax.all_gather(..., tiled=True): every rank's gradient of the
  gathered rows, each rank's slice returned to it (all_to_all) and summed
  in rank order (a reduce-scatter with a fixed order of the sum);
- `all_to_all_rows` (the rows exchange): forward, pack d of (D * cap,
  ...) rows to rank d; backward, the reverse all-to-all;
- `gather_frame_rows` (the frame assembly of out_specs P(None, axis,
  None)): forward, every rank's (C, h, W) slab joined along H; backward,
  this rank's slab of the incoming gradient with no communication,
  because every rank computes the same replicated loss on the whole
  frame (torch.distributed.nn.functional.all_gather would sum the D
  equal gradients and scale them by D);
- `pack_rows` (a rank's packs of its rows for the exchange): backward,
  each pack's gradient written to its rows of a dense (D, n, ...)
  buffer (a row is in a pack at most once, so no write collides) and
  summed over the packs in order: no float atomics.

The collectives use names torch has under NCCL and gloo alike (all_gather
with a list of views, all_to_all_single, all_reduce).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def gather_parts(x: torch.Tensor, group) -> torch.Tensor:
    """(D, *x.shape): every rank's x, in rank order (no gradient)."""
    out = x.new_empty((dist.get_world_size(group),) + tuple(x.shape))
    dist.all_gather(list(out.unbind(0)), x.contiguous(), group=group)
    return out


def swap_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all of equal blocks along dim 0: block d goes to rank d,
    block s of the result came from rank s (no gradient)."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """parts (D, ...) summed along dim 0, part 0 first."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group (overflow counters)."""
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = gather_parts(x, group)
        return parts.reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        d = dist.get_world_size(ctx.group)
        mine = swap_blocks(grad, ctx.group)
        return ordered_sum(mine.reshape((d, -1) + tuple(grad.shape[1:]))), \
            None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) on each rank -> (D * n, ...) rows of every rank in rank
    order; the backward sums the ranks' gradients of this rank's rows."""
    return _AllGatherRows.apply(x, group)


class _AllToAllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return swap_blocks(x, group)

    @staticmethod
    def backward(ctx, grad):
        return swap_blocks(grad, ctx.group), None


def all_to_all_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(D * cap, ...) packs, pack d for rank d -> (D * cap, ...), block s
    from rank s; the backward returns each gradient block to its
    source."""
    return _AllToAllRows.apply(x, group)


class _GatherFrameRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.h = dist.get_rank(group), x.shape[1]
        parts = gather_parts(x, group)                  # (D, C, h, W)
        c, w = x.shape[0], x.shape[2]
        return parts.permute(1, 0, 2, 3).reshape(c, -1, w)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.h
        return grad[:, lo:lo + ctx.h].contiguous(), None


def gather_frame_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(C, h, W) slab of each rank -> the (C, D * h, W) frame, slabs in
    rank order. The loss on the frame must be the same on every rank: the
    backward keeps this rank's slab of its gradient and communicates
    nothing."""
    return _GatherFrameRows.apply(x, group)


class _PackRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, ok):
        ctx.n = x.shape[0]
        ctx.save_for_backward(idx, ok)
        rows = x[idx.reshape(-1)]
        return torch.where(ok.reshape((-1,) + (1,) * (x.dim() - 1)), rows,
                           torch.zeros_like(rows))

    @staticmethod
    def backward(ctx, grad):
        idx, ok = ctx.saved_tensors
        d = idx.shape[0]
        flat = (idx + ctx.n * torch.arange(d, device=idx.device)[:, None])
        buf = grad.new_zeros((d * ctx.n,) + tuple(grad.shape[1:]))
        keep = ok.reshape(-1)
        buf[flat.reshape(-1)[keep]] = grad[keep]
        return ordered_sum(buf.reshape((d, ctx.n) + tuple(grad.shape[1:]))), \
            None, None


def pack_rows(x: torch.Tensor, idx: torch.Tensor,
              ok: torch.Tensor) -> torch.Tensor:
    """x (n, ...), idx (D, cap) int64 row of x at each pack slot, ok
    (D, cap) bool -> (D * cap, ...) packs, zero where not ok. A row sits
    at most once in each pack."""
    return _PackRows.apply(x, idx, ok)
