"""Device milliseconds a distillation step of the optimizers
(set_scheduled_lr and the three Adam steps in train_step), from the
port's span `optim`."""

from portbench import spanread

LAYER = "trainers"
SOURCE = "program_span"
MOVES = "distill_step_ms"


def read(r):
    return spanread.per_unit(r, "distill.step", "optim", "device_ms")
