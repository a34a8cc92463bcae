"""Device milliseconds a distillation step of the blend backward's
instance-to-Gaussian reduce (raster/cuda_blend.py reduce_rows), from the
port's span `blend.reduce`."""

from portbench import spanread

LAYER = "blend backward and reduce"
SOURCE = "program_span"
MOVES = "m360-garden.distill_step_ms"


def read(r):
    return spanread.per_unit(r, "distill.step", "blend.reduce", "device_ms")
