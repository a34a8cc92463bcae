"""Device milliseconds a distillation step of the render's backward, from
the semantic map's gradient to the Gaussians' (blend_bwd, the reduce,
preprocess's backward): the port's span `render.backward`."""

from portbench import spanread

LAYER = "blend backward and reduce"
SOURCE = "program_span"
MOVES = "m360-garden.distill_step_ms"


def read(r):
    return spanread.per_unit(r, "distill.step", "render.backward", "device_ms")
