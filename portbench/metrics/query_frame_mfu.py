"""The whole viewer frame's share of the fp32 peak: the frame's counted
FLOPs (portbench/work: the blend of colour and semantics, the decoder,
the similarity) over the mean time of a frame, against 67 TFLOP/s."""

from portbench.work.counts import PEAK_FP32_FLOPS

LAYER = "whole frame"
SOURCE = "host_clock"
MOVES = "query_frame_ms.p95"


def read(r):
    w = r.get("work")
    if not w or "frame_flops" not in w:
        return None
    return 100.0 * w["frame_flops"] / (r["frame_ms"] * 1e-3
                                       * PEAK_FP32_FLOPS)
