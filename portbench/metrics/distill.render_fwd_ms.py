"""Device milliseconds a step of raster/render.py render: preprocess,
binning and the blend forward: a CUDA-event span, synchronised on both
sides, around the entry, from a short loop on the trained state after
the window."""

LAYER = "render"
SOURCE = "program_span"
MOVES = "distill_step_ms"


def read(r):
    return r.get("spans", {}).get("render_fwd")
