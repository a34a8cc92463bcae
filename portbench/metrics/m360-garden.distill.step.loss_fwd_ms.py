"""Device milliseconds a distillation step of the loss's forward
(semantic/losses.py distillation_loss in train/distill.py distill_loss),
from the port's span `loss.forward`."""

from portbench import spanread

LAYER = "loss"
SOURCE = "program_span"
MOVES = "m360-garden.distill_step_ms"


def read(r):
    return spanread.per_unit(r, "distill.step", "loss.forward", "device_ms")
