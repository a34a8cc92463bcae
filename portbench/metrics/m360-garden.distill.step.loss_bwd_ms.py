"""Device milliseconds a distillation step of the loss's backward: the
self time of the port's span `distill.backward` (loss.backward() in
train_step) less the render's backward under it."""

from portbench import spanread

LAYER = "loss"
SOURCE = "program_span"
MOVES = "m360-garden.distill_step_ms"


def read(r):
    return spanread.per_unit(r, "distill.step", "distill.backward", "self_device_ms")
