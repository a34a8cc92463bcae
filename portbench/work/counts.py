"""Operation and byte counts of the work a cell's inputs need, frozen
with the benchmark, and the H100's published peaks.

They count what the math needs, not what an implementation does: the
blend's (pixel, Gaussian) pairs that it composites (alpha >= 1/255,
reached before the transmittance falls under 1e-4, counted by the
plain reference), times the operations of one such pair written out
from the blend's equations; and the dense products of the loss and the
decoder as GOI writes them. A kernel's roofline is the larger of its
operations over the fp32 peak and its bytes over the memory bandwidth
(each input byte read once, each output byte written once).
"""

from __future__ import annotations

# NVIDIA H100 SXM (H100 80GB HBM3) data sheet, dense, at 700 W
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
F32 = 4

# one composited pair of the forward, per the blend's equations:
#   dx, dy                                   2
#   power = -0.5 (a dx^2 + c dy^2) - b dx dy 9
#   exp, opacity *, min(0.99), alpha test    4
#   1 - alpha, T (1 - alpha), stop test      3
#   w = alpha T                              1
# then a multiply-add (2) a blended channel
FWD_PAIR_BASE = 19
# one composited pair of the backward to the semantic features:
# recompute dx, dy, power, alpha, the step's T and w (19, as above),
# then a multiply-add a channel into the Gaussian's gradient
BWD_SEM_PAIR_BASE = 19
# geometry of a Gaussian the blend reads: mean2d 2, conic 3, opacity 1
GEOM = 6


def blend_fwd(pairs: int, gaussians: int, pixels: int,
              channels: int) -> dict:
    """The forward blend of one view into `channels` output channels
    (semantics, and colour where the frame needs it)."""
    return {"flops": pairs * (FWD_PAIR_BASE + 2 * channels),
            "bytes": F32 * (gaussians * (GEOM + channels)
                            + pixels * channels)}


def blend_bwd_semantics(pairs: int, gaussians: int, pixels: int,
                        sem: int) -> dict:
    """The blend's backward from d loss / d semantic map to the
    Gaussians' semantic features."""
    return {"flops": pairs * (BWD_SEM_PAIR_BASE + 2 * sem),
            "bytes": F32 * (pixels * sem + gaussians * (GEOM + sem))}


def distill_loss_flops(pixels: int, sem: int, tab_len: int,
                       channels: int) -> int:
    """The loss's dense products and their backward: sim = gtl @ lut^T
    and one_hot @ lut, forward and backward to the codebook (four
    products of pixels x channels x tab_len), and the decoder
    sem -> tab_len, forward and backward to its input and weight."""
    return 2 * pixels * channels * tab_len * 4 + 2 * pixels * sem \
        * tab_len * 3


def roofline_s(work: dict) -> float:
    return max(work["flops"] / PEAK_FP32_FLOPS,
               work["bytes"] / PEAK_BYTES_S)


def distill_step(config: dict, view: dict, per_step: list) -> dict:
    """Mean work of the profiled steps, each (pairs, gaussians) of its
    view: the blend backward's, and the whole step's FLOPs (blend
    forward and backward of the semantics, loss, decoder)."""
    px = view["width"] * view["height"]
    s = config["scene"]["sem_dim"]
    c = config["maps"]["channels"]
    k = config["codebook"]["tab_len"]
    n = len(per_step)
    bwd = [blend_bwd_semantics(p, g, px, s) for p, g in per_step]
    fwd = [blend_fwd(p, g, px, s) for p, g in per_step]
    return {
        "blend_bwd_bound_s": sum(roofline_s(w) for w in bwd) / n,
        "step_flops": sum(a["flops"] + b["flops"] for a, b in zip(fwd, bwd))
        / n + distill_loss_flops(px, s, k, c),
    }


def query_frame(config: dict, view: dict, per_frame: list) -> dict:
    """Mean work of the profiled frames, each (pairs, gaussians): the
    forward blend of colour and semantics, and the frame's FLOPs (that
    blend, the decoder and the similarity)."""
    px = view["width"] * view["height"]
    s = config["scene"]["sem_dim"]
    c = config["maps"]["channels"]
    k = config["codebook"]["tab_len"]
    n = len(per_frame)
    fwd = [blend_fwd(p, g, px, s + 3) for p, g in per_frame]
    return {
        "blend_fwd_bound_s": sum(roofline_s(w) for w in fwd) / n,
        "frame_flops": sum(w["flops"] for w in fwd) / n
        + 2 * px * s * k + 2 * px * c,
    }
