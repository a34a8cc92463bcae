"""Device milliseconds a RES request of SAM's predict_boxes: the prompt
encoder, the mask decoder and the upscale chain to the view, from the
port's span `sam.decode`."""

from portbench import spanread

LAYER = "towers"
SOURCE = "program_span"
MOVES = "query_frame_ms.p95"


def read(r):
    return spanread.per_unit(r, "res.request", "sam.decode", "device_ms")
