"""Host milliseconds a viewer frame of raster/render.py render (the frame
is host-bound: the device idles half of it), from the port's span
`render` over the profiled frames."""

from portbench import spanread

LAYER = "render"
SOURCE = "program_span"
MOVES = "query_frame_ms.p95"


def read(r):
    return spanread.per_unit(r, "query.frame", "render", "host_ms")
