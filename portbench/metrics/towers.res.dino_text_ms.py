"""Device milliseconds a RES request of GroundingDINO's text path, BERT-
base and feat_map, from the port's span `dino.text`."""

from portbench import spanread

LAYER = "towers"
SOURCE = "program_span"
MOVES = "query_frame_ms.p95"


def read(r):
    return spanread.per_unit(r, "res.request", "dino.text", "device_ms")
