"""Device milliseconds a data-parallel step, on rank 0, of the gradients'
cat, divide and copies back around the all-reduce: the self time of
the port's span `dist.mean_over_data`."""

from portbench import spanread

LAYER = "dist"
SOURCE = "program_span"
MOVES = "dp4_step_ms"


def read(r):
    return spanread.per_unit(r, "dist.step", "dist.mean_over_data", "self_device_ms")
