"""Device milliseconds a distillation step of raster/render.py render
(preprocess, binning, the blend forward and the frame's assembly), from
the port's span `render`: the in-program twin of distill.render_fwd_ms."""

from portbench import spanread

LAYER = "render"
SOURCE = "program_span"
MOVES = "distill_step_ms"


def read(r):
    return spanread.per_unit(r, "distill.step", "render", "device_ms")
