"""blend_fwd's share of its roofline in the viewer frames: the bound of
the composited pairs' operations and bytes (portbench/work) over the
kernel's device time in the traced frames."""

LAYER = "blend"
SOURCE = "device_trace"
MOVES = "query_frame_ms.p95"


def read(r):
    p, w = r.get("profile"), r.get("work")
    if not p or not w or "blend_fwd_bound_s" not in w:
        return None
    t = sum(v for k, v in p["kernels"].items() if "blend_fwd" in k)
    if t <= 0:
        return None
    return 100.0 * w["blend_fwd_bound_s"] * p["units"] / t
