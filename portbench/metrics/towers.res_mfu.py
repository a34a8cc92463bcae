"""The whole RES request's share of the fp32 peak: the request's counted
FLOPs (portbench/work/towers.py: GroundingDINO and SAM's image encoder
at the view's size, and a mask decode for each box that reached SAM, by
the port's counter res.boxes) over the mean time of a request outside
the profiled ones, against 67 TFLOP/s."""

from portbench import spanread
from portbench.work.counts import PEAK_FP32_FLOPS

LAYER = "whole request"
SOURCE = "host_clock"
MOVES = "query_frame_ms.p95"


def read(r):
    w = r.get("work")
    snap = spanread.snapshot(r)
    n = snap["units"].get("res.request", 0) if snap else 0
    if not w or not n:
        return None
    boxes = snap["counters"].get("res.boxes", 0) / n
    flops = w["fixed_flops"] + boxes * w["box_flops"]
    return 100.0 * flops / (r["request_ms"] * 1e-3 * PEAK_FP32_FLOPS)
