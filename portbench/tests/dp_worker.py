"""One rank of a tiny four-process run of the data-parallel cell on
the CPU (gloo), for test_portbench_faults.py; with the argument
`no_exchange` the gradients' all-reduce over the cards is left out."""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import portbench.run as run  # noqa: E402

TINY = {"config": {"scene": {"n_gaussians": 3000},
                   "views": {"width": 64, "height": 48}},
        "workload": {"params": {"profile_after": 2, "profile_steps": 2}}}


def no_exchange(leaves, terms, mesh):
    for p in leaves:
        if p.grad is None:
            p.grad = p.detach() * 0


if __name__ == "__main__":
    if sys.argv[1] == "no_exchange":
        import goi_tpu_torch.dist.shard as shard
        shard._mean_over_data = no_exchange
    res = run.run_cell("m360-garden.distill-dp4", int(sys.argv[2]), 1.5,
                       False, device="cpu", overrides=TINY)
    if res is not None:
        print(json.dumps(res), flush=True)
