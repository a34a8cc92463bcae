"""Driver of the one-card distillation cells.

The window drives the users' loop, train_distillation (seeded epoch
order, the StepTimer's synchronise a step, rebudget), on the cell's
seeded scene, views and feature maps held on the device. Its first
`warmup_steps` steps are set-up; a callback records the loss of the
first steps, the optimizers' state after step 1 and the parameters
after the last compared step, opens the window after the warm-up and
closes it, by raising, at the first step that ends past --seconds.
distill_step_ms is the window's length over the steps completed in it.
With --trace the profiler covers `profile_steps` steps of the window,
and after it a short loop times each layer's entry on the same state
(spans). Once the window has closed and the program's state is freed,
the plain reference follows the first steps from the same inputs.
"""

from __future__ import annotations

import time

import torch

from portbench import inputs, program
from portbench.reference import distill as ref_distill
from portbench.reference import raster as ref_raster
from portbench.trace import Profile, Spans
from portbench.work import counts

KERNELS = ("gather", "blend_fwd", "blend_bwd", "prefix", "owner_sums")


class WindowClosed(Exception):
    pass


def leaves(state) -> dict:
    """The trained leaves of the port's DistillState, by the reference's
    names, with each one's optimizer."""
    return {"semantics": (state.scene.semantics, state.opt_scene),
            "decoder.weight": (state.decoder.weight_0, state.opt_decoder),
            "decoder.bias": (state.decoder.bias_0, state.opt_decoder),
            "lut": (state.lut, state.opt_lut)}


def first_update(p, opt) -> torch.Tensor:
    """Step 1's Adam update of p, worked out from its state after it."""
    st, grp = opt.state[p], opt.param_groups[0]
    b1, b2 = grp["betas"]
    lr = grp["lr"]
    m = st["exp_avg"] / (1 - b1)
    v = st["exp_avg_sq"] / (1 - b2)
    return lr * m / (torch.sqrt(v) + grp["eps"])


class Recorder:
    """train_distillation's callback: the compared readings, the window,
    the profiled steps."""

    def __init__(self, traffic, seconds, trace, device):
        self.warm = traffic["warmup_steps"]
        self.compared = traffic["compared_steps"]
        self.seconds = seconds
        self.device = device
        self.prof = Profile(device) if trace else None
        self.prof_at = self.warm + traffic["profile_after"]
        self.prof_n = traffic["profile_steps"]
        self.losses, self.grad1, self.start, self.end = [], {}, {}, {}
        self.t0 = self.t1 = self.t_first = None
        self.steps = 0
        self.prof_steps = []
        self.state = None

    def __call__(self, it, state, aux):
        self.state = state
        if it <= self.compared:
            self.losses.append(float(aux["total"]))
        if it == 1:
            self.t_first = time.perf_counter()
            for k, (p, opt) in leaves(state).items():
                if "exp_avg" not in opt.state.get(p, {}):
                    # no update was made: no gradient, no change
                    self.grad1[k] = torch.zeros_like(p.detach())
                    self.start[k] = p.detach().clone()
                    continue
                self.grad1[k] = opt.state[p]["exp_avg"] / \
                    (1 - opt.param_groups[0]["betas"][0])
                self.start[k] = p.detach() + first_update(p, opt)
        if it == self.compared:
            self.end = {k: p.detach().clone()
                        for k, (p, _) in leaves(state).items()}
        if it == self.warm:
            self.t0 = time.perf_counter()
            return
        if self.t0 is None:
            return
        if self.prof is not None:
            if it == self.prof_at:
                self.prof.start()
            elif it == self.prof_at + self.prof_n:
                self.prof.stop(self.prof_n)
                self.prof_steps = list(range(self.prof_at + 1, it + 1))
        now = time.perf_counter()
        if now - self.t0 >= self.seconds and (
                self.prof is None or self.prof_steps):
            self.t1 = now
            self.steps = it - self.warm
            raise WindowClosed


def spans(state, cams, maps, order, raster_cfg, n, device) -> dict:
    """Device ms of each layer's entry a step, on the trained state:
    render with the map's leaf detached, the loss and its backward to
    that leaf, the backward through the render, the three optimizers'
    steps. An entry the program no longer has leaves its span out."""
    from goi_tpu_torch.raster.render import render
    from goi_tpu_torch.semantic.losses import distillation_loss
    sp = Spans(device)
    bg = torch.zeros(3, device=device)
    opts = [o for o in (state.opt_scene, state.opt_decoder, state.opt_lut)
            if o is not None]
    for vi in order[:n]:
        for o in opts:
            o.zero_grad(set_to_none=True)
        gt = maps[vi]
        with sp.time("render_fwd"):
            out = render(state.scene, cams[vi], bg, raster_cfg)
            s = out["semantics"].shape[0]
            flat = out["semantics"].reshape(s, -1).T
        leaf = flat.detach().requires_grad_()
        with sp.time("loss"):
            loss, _ = distillation_loss(state.decoder, state.lut, leaf,
                                        gt.reshape(gt.shape[0], -1).T, 1.0)
            loss.backward()
        with sp.time("render_bwd"):
            flat.backward(leaf.grad)
        with sp.time("optim"):
            for o in opts:
                o.step()
    return sp.mean()


def run(*, cell, workload, config, seed, seconds, trace, device, t_start):
    from goi_tpu_torch.raster.render import RasterConfig, suggest_budgets
    from goi_tpu_torch.train.distill import train_distillation
    traffic = workload["params"]
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    marks = [("start", t_start), ("imports", time.perf_counter())]
    program.build_kernels(KERNELS, device)
    marks.append(("build", time.perf_counter()))
    raw = inputs.make_scene(config["scene"], seed, device)
    views = inputs.training_views(config["views"], seed)
    maps, _ = inputs.feature_maps(config["maps"], views, seed, device)
    scene = program.scene(raw)
    cams = [program.camera(v, device) for v in views]
    program.sync(device)
    marks.append(("inputs", time.perf_counter()))
    budget, _ = suggest_budgets(scene, cams)
    raster_cfg = RasterConfig(max_instances=budget)
    marks.append(("budget", time.perf_counter()))
    print(f"[portbench] {cell}: {config['scene']['n_gaussians']} Gaussians, "
          f"{len(views)} views {views[0]['width']}x{views[0]['height']}, "
          f"budget {budget}", flush=True)
    rec = Recorder(traffic, seconds, trace, device)
    try:
        train_distillation(scene, cams, maps,
                           tab_len=config["codebook"]["tab_len"],
                           iterations=traffic["max_steps"],
                           raster_cfg=raster_cfg, seed=seed,
                           log_every=traffic["log_every"], callback=rec)
    except WindowClosed:
        pass
    if rec.t1 is None:
        raise RuntimeError(f"the window did not close in "
                           f"{traffic['max_steps']} steps")
    step_ms = (rec.t1 - rec.t0) * 1e3 / rec.steps
    setup_s = rec.t0 - t_start
    marks += [("codebook and first steps", rec.t_first),
              ("warm-up steps", rec.t0)]
    print(f"[portbench] {cell}: set-up {program.phases(marks)}", flush=True)
    readings = {"step_ms": step_ms, "steps": rec.steps}
    if trace:
        # the step time of the window's steps outside the profiled ones
        readings["step_ms"] = (rec.t1 - rec.t0 - rec.prof.held) * 1e3 / (
            rec.steps - rec.prof_n)
    order = [s[0] for s in ref_distill.view_order(
        seed, len(views), traffic["max_steps"], 1)]
    profile = None
    if trace:
        profile = rec.prof.result()
        readings["profile"] = profile
        readings["spans"] = spans(rec.state, cams, maps, order,
                                  raster_cfg, traffic["span_steps"], device)
    dev_info = program.device_info(device, 1)
    print(f"[portbench] {cell}: {rec.steps} steps in "
          f"{rec.t1 - rec.t0:.3f} s, {step_ms:.3f} ms a step, set-up "
          f"{setup_s:.3f} s, peak {dev_info['memory_peak_bytes']} B",
          flush=True)
    rec.state = None
    del scene, cams
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = ref_distill.first_steps(raw, views, maps, seed,
                                  tab_len=config["codebook"]["tab_len"],
                                  steps=traffic["compared_steps"])
    prog = {"losses": rec.losses, "grad1": rec.grad1, "start": rec.start,
            "end": rec.end}
    numbers = program.training_numbers(prog, ref)
    change = {k: prog["end"][k] - prog["start"][k] for k in prog["end"]}
    ref_change = {k: ref["end"][k] - ref["start"][k] for k in ref["end"]}
    print(f"[portbench] {cell}: leaf gaps, first gradient "
          f"{program.leaf_gaps(prog['grad1'], ref['grad1'])}, change "
          f"{program.leaf_gaps(change, ref_change)}", flush=True)
    print(f"[portbench] {cell}: losses {rec.losses} reference "
          f"{ref['losses']}; reference {time.perf_counter() - t_ref:.3f} s",
          flush=True)
    if trace:
        pairs = {}
        for vi in set(order[s - 1] for s in rec.prof_steps):
            sp = ref_raster.preprocess(raw, views[vi])
            pairs[vi] = ref_raster.blended_pairs(sp,
                                                 ref_raster.tile_lists(sp))
        steps = [order[s - 1] for s in rec.prof_steps]
        readings["work"] = counts.distill_step(
            config, views[0], [pairs[v] for v in steps])
        print(f"[portbench] {cell}: blended pairs of the profiled views "
              f"{pairs}", flush=True)
    checks, ok = program.checks(numbers, workload["limits"])
    return {"correct": ok, "attempted": rec.steps,
            "failed": 0 if ok else rec.steps,
            "e2e": {"distill_step_ms": step_ms, "setup_s": setup_s},
            "readings": readings, "profile": profile, "device": dev_info,
            "checks": checks}

