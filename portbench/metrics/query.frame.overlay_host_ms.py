"""Host milliseconds a viewer frame of the overlay (app/session.py _frame
after render: decode, similarity, heat, composite, uint8 finish), from
the port's span `query.overlay`."""

from portbench import spanread

LAYER = "overlay"
SOURCE = "program_span"
MOVES = "query_frame_ms.p95"


def read(r):
    return spanread.per_unit(r, "query.frame", "query.overlay", "host_ms")
