"""The share of the blend forward's walked pairs that blend, over the
profiled viewer frames: 100 x the port's counter blend.blended over
blend.walked (raw's per-pixel counts, summed in float64)."""

from portbench import spanread

LAYER = "blend"
SOURCE = "program_counter"
MOVES = "query_frame_ms.p95"


def read(r):
    return spanread.share(r, "query.frame", "blend.blended",
                          "blend.walked")
