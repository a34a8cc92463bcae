"""Device milliseconds a RES request of GroundingDINO's feature enhancer
(fusion, text and deformable encoder layers), from the port's span
`dino.encoder`."""

from portbench import spanread

LAYER = "towers"
SOURCE = "program_span"
MOVES = "query_frame_ms.p95"


def read(r):
    return spanread.per_unit(r, "res.request", "dino.encoder", "device_ms")
