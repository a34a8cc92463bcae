"""Device milliseconds a distillation step of raster/preprocess.py
preprocess inside render, from the port's span `render.preprocess`."""

from portbench import spanread

LAYER = "render"
SOURCE = "program_span"
MOVES = "distill_step_ms"


def read(r):
    return spanread.per_unit(r, "distill.step", "render.preprocess", "device_ms")
