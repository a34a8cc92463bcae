"""Device milliseconds a RES request of GroundingDINO's image path: the
view's resize and normalisation, Swin-T and the input projections, from
the port's span `dino.backbone`."""

from portbench import spanread

LAYER = "towers"
SOURCE = "program_span"
MOVES = "query_frame_ms.p95"


def read(r):
    return spanread.per_unit(r, "res.request", "dino.backbone", "device_ms")
