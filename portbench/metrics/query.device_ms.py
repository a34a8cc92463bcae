"""Device busy milliseconds a viewer frame, from the profiler's trace of
the window's traced frames (the device layer under
QuerySession.render_view)."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "query_frame_ms.p95"


def read(r):
    p = r.get("profile")
    if not p or r.get("frames") is None:
        return None
    return p["busy_s"] * 1e3 / p["units"]
