"""Host milliseconds a viewer frame of the frame's copy to the host
(QuerySession.render_view's img.cpu().numpy(): the device drains, then
the copy), from the port's span `query.to_host`."""

from portbench import spanread

LAYER = "frame finish"
SOURCE = "program_span"
MOVES = "query_frame_ms.p95"


def read(r):
    return spanread.per_unit(r, "query.frame", "query.to_host", "host_ms")
