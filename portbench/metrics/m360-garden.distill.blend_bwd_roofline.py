"""blend_bwd's share of its roofline in the distillation step: the
bound of the composited pairs' backward to the semantic features
(portbench/work) over the kernel's device time in the profiled steps."""

LAYER = "blend"
SOURCE = "device_trace"
MOVES = "m360-garden.distill_step_ms"


def read(r):
    p, w = r.get("profile"), r.get("work")
    if not p or not w or "blend_bwd_bound_s" not in w:
        return None
    t = sum(v for k, v in p["kernels"].items() if "blend_bwd" in k)
    if t <= 0:
        return None
    return 100.0 * w["blend_bwd_bound_s"] * p["units"] / t
