"""Host milliseconds a RES request of the work between the towers: the
caption's tokens and masks, the thresholds and phrases, the boxes'
pixels, the re-rank and the union, from the port's span `res.host`."""

from portbench import spanread

LAYER = "towers"
SOURCE = "program_span"
MOVES = "query_frame_ms.p95"


def read(r):
    return spanread.per_unit(r, "res.request", "res.host", "host_ms")
