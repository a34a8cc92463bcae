"""Device milliseconds a step of the three Adam steps of train/optim.py: a
CUDA-event span, synchronised on both sides, around the entry, from a
short loop on the trained state after the window."""

LAYER = "trainers"
SOURCE = "program_span"
MOVES = "distill_step_ms"


def read(r):
    return r.get("spans", {}).get("optim")
