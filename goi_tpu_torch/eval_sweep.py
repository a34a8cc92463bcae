"""Multi-scene eval sweep: `python -m goi_tpu_torch.eval_sweep`.

Counterpart of the root eval_sweep.py: each process takes the model
directories strided by its rank, runs the port's render and metrics
entry points on them on its own card, and after a barrier rank 0 joins
every scene's results.json into one sweep_results.json with the
per-scene and overall means. Called inside a process group, it uses
that group and leaves it formed.

  python -m goi_tpu_torch.eval_sweep -m out/garden out/room ...
  torchrun --nproc_per_node 4 -m goi_tpu_torch.eval_sweep -m ...
  GOI_COORD=h0:8476 GOI_NUM_PROCS=2 GOI_PROC_ID=<i> \\
      python -m goi_tpu_torch.eval_sweep -m ...   (one per host)
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np
import torch.distributed as dist

from goi_tpu_torch import _cli


def main(argv=None):
    parser = ArgumentParser(description="goi_tpu_torch multi-scene eval "
                                        "sweep")
    parser.add_argument("--models", "-m", nargs="+", required=True,
                        help="model dirs (one per scene)")
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_render", action="store_true",
                        help="only score existing renders")
    parser.add_argument("--max_instances", type=int, default=0)
    parser.add_argument("--out", default="sweep_results.json")
    _cli.add_device_flag(parser)
    args = parser.parse_args(argv)

    from goi_tpu_torch import metrics as metrics_cli
    from goi_tpu_torch import render as render_cli
    from goi_tpu_torch.dist import init_multihost
    from goi_tpu_torch.dist.mesh import rank_device

    # a caller's group is used as it is, and left to the caller
    own_group = not dist.is_initialized() and init_multihost(
        device=args.device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    nproc = dist.get_world_size() if dist.is_initialized() else 1
    device = str(rank_device(args.device)) if args.device != "cpu" \
        else "cpu"
    mine = args.models[rank::nproc]
    print(f"[proc {rank}/{nproc}] scenes: {mine}", flush=True)
    for model in mine:
        if not args.skip_render:
            render_cli.main(["-m", model, "--iteration", str(args.iteration),
                             "--skip_train", "--max_instances",
                             str(args.max_instances), "--device", device])
        metrics_cli.evaluate([model], device=device)
    if dist.is_initialized():
        dist.barrier()
    if own_group:
        dist.destroy_process_group()
    if rank != 0:
        return None
    sweep = {"scenes": {}, "mean": {}}
    acc: dict = {}
    for model in args.models:
        path = os.path.join(model, "results.json")
        if not os.path.exists(path):
            print(f"missing {path}")
            continue
        with open(path) as f:
            res = json.load(f)
        method = sorted(res)[-1]          # the newest method entry
        sweep["scenes"][model] = {"method": method, **res[method]}
        for k, v in res[method].items():
            if isinstance(v, (int, float)):
                acc.setdefault(k, []).append(float(v))
    sweep["mean"] = {k: float(np.mean(v)) for k, v in acc.items()}
    with open(args.out, "w") as f:
        json.dump(sweep, f, indent=1)
    print(json.dumps(sweep["mean"]))
    return sweep


if __name__ == "__main__":
    main()
