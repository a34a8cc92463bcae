"""Device milliseconds a RES request of the viewer's render_view (the
raster of the view and its copy to the host), from the port's span
`query.frame` inside the unit res.request."""

from portbench import spanread

LAYER = "render"
SOURCE = "program_span"
MOVES = "query_frame_ms.p95"


def read(r):
    return spanread.per_unit(r, "res.request", "query.frame", "device_ms")
