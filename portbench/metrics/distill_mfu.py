"""The whole distillation step's share of the fp32 peak: the step's
counted FLOPs (portbench/work: the blend forward and backward of the
semantics, the loss's products, the decoder) over the step time of the
traced run's window outside its profiled steps, against 67 TFLOP/s."""

from portbench.work.counts import PEAK_FP32_FLOPS

LAYER = "whole step"
SOURCE = "host_clock"
MOVES = "distill_step_ms"


def read(r):
    w = r.get("work")
    if not w or "step_flops" not in w:
        return None
    return 100.0 * w["step_flops"] / (r["step_ms"] * 1e-3 * PEAK_FP32_FLOPS)
