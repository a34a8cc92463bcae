"""Device milliseconds a step of the backward from the rendered map to the
Gaussians: blend_bwd and the reduce: a CUDA-event span, synchronised on
both sides, around the entry, from a short loop on the trained state
after the window."""

LAYER = "blend backward and reduce"
SOURCE = "program_span"
MOVES = "distill_step_ms"


def read(r):
    return r.get("spans", {}).get("render_bwd")
