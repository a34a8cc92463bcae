"""The boxes that reach SAM a RES request, from the port's counter
`res.boxes` over its unit res.request: each box adds a mask decode and
its upscale to the view."""

from portbench import spanread

LAYER = "towers"
SOURCE = "program_counter"
MOVES = "query_frame_ms.p95"


def read(r):
    snap = spanread.snapshot(r)
    n = snap["units"].get("res.request", 0) if snap else 0
    if not n or "res.boxes" not in snap["counters"]:
        return None
    return snap["counters"]["res.boxes"] / n
