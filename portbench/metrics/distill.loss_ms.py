"""Device milliseconds a step of semantic/losses.py distillation_loss with
the decoder, forward and backward to the rendered map: a CUDA-event
span, synchronised on both sides, around the entry, from a short loop on
the trained state after the window."""

LAYER = "loss"
SOURCE = "program_span"
MOVES = "distill_step_ms"


def read(r):
    return r.get("spans", {}).get("loss")
