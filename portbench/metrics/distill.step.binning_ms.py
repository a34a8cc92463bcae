"""Device milliseconds a distillation step of the binning (render._bin:
expansion, cull, the sort, tile ranges), from the port's span
`render.binning`."""

from portbench import spanread

LAYER = "render"
SOURCE = "program_span"
MOVES = "distill_step_ms"


def read(r):
    return spanread.per_unit(r, "distill.step", "render.binning", "device_ms")
