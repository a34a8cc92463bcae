"""Device milliseconds a RES request of GroundingDINO's query selection,
decoder and the outputs' copy to the host, from the port's span
`dino.decoder`."""

from portbench import spanread

LAYER = "towers"
SOURCE = "program_span"
MOVES = "query_frame_ms.p95"


def read(r):
    return spanread.per_unit(r, "res.request", "dino.decoder", "device_ms")
