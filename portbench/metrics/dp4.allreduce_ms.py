"""Device milliseconds a data-parallel step of the collectives (NCCL's
kernels: the gradients' all-reduce of dist/shard.py _mean_over_data
through dist/collectives.py, and the step's small ones) on rank 0, from
the profiler's trace of the profiled steps."""

LAYER = "dist"
SOURCE = "device_trace"
MOVES = "dp4_step_ms"


def read(r):
    p = r.get("profile")
    if not p or r.get("chips") is None:
        return None
    t = sum(v for k, v in p["kernels"].items() if "nccl" in k.lower())
    if t <= 0:
        return None
    return t * 1e3 / p["units"]
