"""The whole four-card step's share of the cards' fp32 peak: the counted
FLOPs of its four cameras (portbench/work: blend forward and backward
of the semantics, the loss's products, the decoder, each camera's) over
the step time of the traced run's window outside its profiled steps,
against 4 x 67 TFLOP/s."""

from portbench.work.counts import PEAK_FP32_FLOPS

LAYER = "whole step"
SOURCE = "host_clock"
MOVES = "dp4_step_ms"


def read(r):
    w = r.get("work")
    if not w or "step_flops" not in w or r.get("chips") is None:
        return None
    n = r["chips"]
    return 100.0 * n * w["step_flops"] / (r["step_ms"] * 1e-3 * n
                                          * PEAK_FP32_FLOPS)
