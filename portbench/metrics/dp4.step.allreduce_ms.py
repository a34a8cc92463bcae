"""Device milliseconds a data-parallel step, on rank 0, of the gradients'
all-reduce (dist/shard.py _mean_over_data's dist.all_reduce: the
compute stream waits on NCCL, the other cards' straggle included), from
the port's span `dist.allreduce`."""

from portbench import spanread

LAYER = "dist"
SOURCE = "program_span"
MOVES = "dp4_step_ms"


def read(r):
    return spanread.per_unit(r, "dist.step", "dist.allreduce", "device_ms")
