"""Remote viewer: `python -m goi_tpu_torch.viewer`.

Counterpart of the root viewer.py (the role of the reference's
network_gui loop and the GUI's standalone viewing, ref:train.py:97-111):
serves a trained model over the SIBR wire protocol; point a SIBR remote
viewer (or anything speaking the protocol) at <ip>:<port>. With a
decoder/LUT beside the PLY and an aligned prompt store, frames carry the
query's similarity overlay. The root CLI's flags plus `--device`; the
saved cfg_args of the run, merged under the flags given, pick the scene.
It prints `serving ... on <ip>:<port>` once it listens (the bound port
with --port 0), and on SIGTERM or Ctrl-C its summary line with the
frames served and the kernel launches.

  python -m goi_tpu_torch.viewer -m <model_dir> [--iteration -1]
      [--port 6009] [--prompt_store prompts_aligned.npz --prompt "sofa"]
      [--device cuda|cpu]
"""

from __future__ import annotations

import os
import signal
import time
from argparse import ArgumentParser

import numpy as np
import torch

from goi_tpu_torch import _cli
from goi_tpu_torch.configs.params import (ModelParams, add_params,
                                          combined_params)


def main(argv=None):
    parser = ArgumentParser(description="goi_tpu_torch remote viewer")
    add_params(parser, ModelParams, "Loading Parameters")
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--max_instances", type=int, default=0,
                        help="0 = auto-size from the scene and its first "
                             "4 train views")
    parser.add_argument("--prompt_store", type=str, default="",
                        help=".npz of ALIGNED 256-d prompt embeddings")
    parser.add_argument("--prompt", type=str, default="")
    _cli.add_device_flag(parser)
    args = parser.parse_args(argv)
    device = _cli.resolve_device(args.device)
    mp = combined_params(args, ModelParams)

    from goi_tpu_torch.app.session import QuerySession
    from goi_tpu_torch.data.scene import DECODER, Scene
    from goi_tpu_torch.raster.render import RasterConfig, suggest_budgets
    from goi_tpu_torch.semantic.codebook import SemanticDecoder
    from goi_tpu_torch.viewer.server import NetworkGUI

    clock = _cli.Clock(device)
    with clock.phase("load"):
        scene = Scene(mp, load_iteration=args.iteration, load_sem=False,
                      device=device)
        it_dir = os.path.join(mp.model_path, "point_cloud",
                              f"iteration_{scene.loaded_iter}")
        if os.path.exists(os.path.join(it_dir, DECODER)):
            decoder, lut = Scene.load_semantics(it_dir, device=device)
        else:
            decoder = SemanticDecoder([torch.zeros(1, mp.sem_dim,
                                                   device=device)],
                                      [torch.zeros(1, device=device)])
            lut = None
    budget = args.max_instances or suggest_budgets(
        scene.gaussians, scene.train_cameras[:4])[0]
    sess = QuerySession(scene.gaussians, decoder, lut,
                        RasterConfig(max_instances=budget),
                        white_background=mp.white_background, device=device)
    if args.prompt and args.prompt_store:
        with np.load(args.prompt_store) as store:
            sess.set_text(store[args.prompt])
        print(f"query prompt: {args.prompt!r}", flush=True)

    frames = 0

    def render_fn(cam, scaling_modifier):
        nonlocal frames
        with clock.phase("render"):
            img = sess.render_view(cam, scaling_modifier=scaling_modifier,
                                   as_u8=True)
        frames += 1
        return img

    def stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, stop)
    gui = NetworkGUI(args.ip, args.port, device=device)
    port = gui.listener.getsockname()[1]
    print(f"serving {mp.model_path} (iter {scene.loaded_iter}) on "
          f"{args.ip}:{port} — connect a SIBR remote viewer", flush=True)
    try:
        while True:
            if not gui.serve_step(render_fn, verify=mp.source_path):
                time.sleep(0.005)
    except KeyboardInterrupt:
        pass
    finally:
        gui.close()
        _cli.summary("viewer", clock, iteration=scene.loaded_iter,
                     frames=frames, budget=budget, port=port)


if __name__ == "__main__":
    main()
