"""Device milliseconds a RES request of multi-scale deformable attention's
sampling (every ms_deform_attn_core call of the encoder and the
decoder), from the port's span `deform_attn`."""

from portbench import spanread

LAYER = "towers"
SOURCE = "program_span"
MOVES = "query_frame_ms.p95"


def read(r):
    return spanread.per_unit(r, "res.request", "deform_attn", "device_ms")
