"""The share of the binning's sorted slots that the blend walks a
distillation step: 100 x the port's counter binning.kept (the
tiles' ranges) over binning.sorted_slots (the sort's length, the
instance budget)."""

from portbench import spanread

LAYER = "render"
SOURCE = "program_counter"
MOVES = "distill_step_ms"


def read(r):
    return spanread.share(r, "distill.step", "binning.kept",
                          "binning.sorted_slots")
