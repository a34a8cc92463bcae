"""Device milliseconds a RES request of SAM's set_image: the resize,
normalisation and padding and the ViT-H image encoder, from the port's
span `sam.encoder`."""

from portbench import spanread

LAYER = "towers"
SOURCE = "program_span"
MOVES = "query_frame_ms.p95"


def read(r):
    return spanread.per_unit(r, "res.request", "sam.encoder", "device_ms")
