"""goi_tpu_torch.utils.profiling's spans and counters on the CPU.

Disarmed (no profiler active) the instrumented paths run exactly the
operations of a program with the instrumentation taken out, and record
nothing. Armed, under torch.profiler.profile, every span of a
distillation step, a viewer frame and a sharded step (a one-process
gloo group) appears once a unit as a host event that is not a user
annotation, nested as utils/profiling.py lists them; self times are
durations less the children's; the counters hold what the binning and
the blend produced; outputs and gradients are bit-identical armed and
disarmed."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import goi_tpu_torch.raster.cuda_blend as cuda_blend
from goi_tpu_torch.app.session import QuerySession
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.raster.render import RasterConfig, render
from goi_tpu_torch.semantic.codebook import SemanticDecoder
from goi_tpu_torch.train.distill import create_distill_state
from goi_tpu_torch.train.optim import OptimConfig
from goi_tpu_torch.utils import profiling
from goi_tpu_torch.viewer.web import orbit_view_camera

torch.set_num_threads(1)

# the package exports the function render under the module's name
render_mod = importlib.import_module("goi_tpu_torch.raster.render")

# explicit 'chain': the main path's reduce at a budget the CPU sorts fast
CFG = RasterConfig(max_instances=1 << 13, reduce="chain")
W, H, S, C, K = 48, 32, 8, 12, 6

STEP_PARENTS = {"render": "distill.step", "render.preprocess": "render",
                "render.binning": "render", "loss.forward": "distill.step",
                "distill.backward": "distill.step",
                "render.backward": "distill.backward",
                "blend.reduce": "render.backward", "optim": "distill.step",
                "distill.step": None}
FRAME_PARENTS = {"query.frame": None, "render": "query.frame",
                 "render.preprocess": "render", "render.binning": "render",
                 "query.overlay": "query.frame",
                 "query.to_host": "query.frame"}
DIST_PARENTS = {"dist.step": None, "render.binning": "dist.step",
                "dist.mean_over_data": "dist.step",
                "dist.allreduce": "dist.mean_over_data"}


def make_scene(seed=0, n=400):
    rng = np.random.default_rng(seed)
    scene = GaussianScene.create(
        rng.normal(0.0, 0.5, (n, 3)), rng.uniform(0.0, 1.0, (n, 3)),
        sem_dim=S, scales=np.full(n, 0.05, np.float32), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    return scene.replace(semantics=torch.randn((n, S), generator=gen),
                         opacity=torch.zeros((n, 1)))


def make_camera(azim=0.0):
    return orbit_view_camera({"w": W, "h": H, "radius": 3.0, "azim": azim},
                             50.0, "cpu")


def make_model(seed=0):
    gen = torch.Generator().manual_seed(seed)
    dec = SemanticDecoder.create(gen, dim_in=S, dim_out=K, device="cpu")
    lut = torch.randn((K, C), generator=gen)
    gt = torch.randn((C, H, W), generator=gen)
    return dec, lut, gt


def make_step(seed=0):
    dec, lut, gt = make_model(seed)
    state, step = create_distill_state(make_scene(seed), dec, lut,
                                       OptimConfig(semantic_finetune=True))
    return state, step, gt


def make_session(seed=0):
    dec, lut, _ = make_model(seed)
    sess = QuerySession(make_scene(seed), dec, lut, CFG, device="cpu")
    sess.set_text(torch.randn(C, generator=torch.Generator().manual_seed(9)))
    return sess


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh_registry():
    profiling.reset()
    yield
    profiling.reset()


TORCH_DIR = os.path.dirname(torch.__file__)
# the functions that reduce a tensor for a counter
COUNTING = {"_bin", "blend_tiles_cuda"}


class AtenOps(TorchDispatchMode):
    """Every aten operation run under it, with the function outside
    torch that issued it and its file."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        f = sys._getframe(1)
        while f is not None and f.f_code.co_filename.startswith(TORCH_DIR):
            f = f.f_back
        self.ops.append((str(func), f.f_code.co_name,
                         os.path.basename(f.f_code.co_filename)))
        return func(*args, **(kwargs or {}))


def counting_ops(ops):
    """The operations issued by the counting functions or the registry
    (autograd.Function.apply's own detach from blend_tiles_cuda left
    out: a view, no work)."""
    return [op for op in ops if op[0] != "aten.detach.default"
            and (op[1] in COUNTING or op[2] == "profiling.py")]


def run_paths():
    """A render with a backward, a train_step, a render_view frame."""
    scene = make_scene(1)
    scene = scene.replace(semantics=scene.semantics.requires_grad_())
    out = render(scene, make_camera(), torch.zeros(3), CFG)
    out["semantics"].square().sum().backward()
    state, step, gt = make_step(2)
    step(state, make_camera(0.3), gt, torch.zeros(3), CFG)
    make_session(3).render_view(make_camera(0.6), as_u8=True)


def test_disarmed_records_nothing_and_reduces_nothing(monkeypatch):
    """Outside a profiler: no span or counter call reaches the registry,
    no CUDA event is made, nothing synchronises, and no tensor operation
    is issued for a counter; under one the counters' operations run."""
    calls = []
    for name in ("open", "count"):
        real = getattr(profiling._REGISTRY, name)
        monkeypatch.setattr(profiling._REGISTRY, name,
                            lambda *a, _n=name, _r=real: (calls.append(_n),
                                                          _r(*a))[1])
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: calls.append("event"))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("sync"))
    assert not profiling.armed()
    assert profiling.span("render") is profiling.span("optim")
    with AtenOps() as off:
        run_paths()
    assert calls == [] and len(off.ops) > 100
    assert counting_ops(off.ops) == []
    assert profiling.snapshot() == {"units": {}, "spans": {},
                                    "counters": {}}
    assert profiling.records() == []
    with cpu_profile(), AtenOps() as on:
        run_paths()
    assert {op[1] for op in counting_ops(on.ops)} >= COUNTING
    assert "open" in calls and "count" in calls


def check_units(recs, unit, parents, n):
    """Each unit `unit` holds every span of `parents` once, under the
    parent named there, and carries the unit's id."""
    by_id = {r[1]: r for r in recs}
    units = [r for r in recs if r[0] == unit]
    assert len(units) == n
    for u in units:
        inside = [r for r in recs if r[3] == u[1]]
        assert sorted(r[0] for r in inside) == sorted(parents), u
        for name, _, parent, _ in inside:
            want = parents[name]
            assert (by_id[parent][0] if parent is not None else None) \
                == want, (name, want)


def host_events(prof, names):
    return [e for e in prof.events() if e.name in names]


def test_armed_step_and_frame_spans_nest_once_per_unit():
    state, step, gt = make_step()
    sess = make_session()
    with cpu_profile() as prof:
        for i in range(2):
            state, _ = step(state, make_camera(0.2 * i), gt, torch.zeros(3),
                            CFG)
        for i in range(3):
            sess.render_view(make_camera(0.5 + 0.1 * i), as_u8=True)
    recs = profiling.records()
    check_units(recs, "distill.step", STEP_PARENTS, 2)
    check_units(recs, "query.frame", FRAME_PARENTS, 3)
    names = set(STEP_PARENTS) | set(FRAME_PARENTS)
    events = host_events(prof, names)
    got = {n: sum(e.name == n for e in events) for n in names}
    assert got == {n: 2 * (n in STEP_PARENTS) + 3 * (n in FRAME_PARENTS)
                   for n in names}
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               and not e.is_user_annotation for e in events)
    # the host ranges nest as the registry's parents do
    for child, parent in (("render.backward", "distill.backward"),
                          ("blend.reduce", "render.backward"),
                          ("render.binning", "render")):
        for c in host_events(prof, {child}):
            assert any(p.time_range.start <= c.time_range.start
                       and c.time_range.end <= p.time_range.end
                       for p in host_events(prof, {parent})), child
    snap = profiling.snapshot()
    assert snap["units"] == {"distill.step": 2, "query.frame": 3}
    assert snap["spans"]["render"]["calls"] == 5
    assert snap["spans"]["render.backward"]["calls"] == 2


def test_armed_sharded_step_spans_nest_once_per_unit():
    import torch.distributed as dist

    from goi_tpu_torch.core.camera import stack_cameras
    from goi_tpu_torch.dist import (make_sharded_distill_step, shard_batch,
                                    shard_scene)
    from goi_tpu_torch.dist.mesh import make_mesh
    from goi_tpu_torch.dist.multihost import free_port
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, device="cpu")
        dec, lut, gt = make_model()
        init_fn, step_fn = make_sharded_distill_step(
            OptimConfig(semantic_finetune=True), CFG, mesh=mesh)
        state = init_fn(shard_scene(make_scene(), mesh), dec, lut)
        cams, gts = shard_batch(mesh, stack_cameras([make_camera()]),
                                gt[None])
        with cpu_profile():
            for _ in range(2):
                state, _ = step_fn(state, cams, gts, torch.zeros(3))
    finally:
        dist.destroy_process_group()
    recs = profiling.records()
    dist_recs = [r for r in recs if r[0] in DIST_PARENTS]
    check_units(dist_recs, "dist.step", DIST_PARENTS, 2)
    snap = profiling.snapshot()
    assert snap["units"] == {"dist.step": 2}
    mean = snap["spans"]["dist.mean_over_data"]
    assert mean["self_host_ms"] == pytest.approx(
        mean["host_ms"] - snap["spans"]["dist.allreduce"]["host_ms"])


def test_self_time_is_duration_less_children():
    import time
    with cpu_profile():
        with profiling.span("distill.step"):
            time.sleep(0.002)
            with profiling.span("render"):
                time.sleep(0.002)
                with profiling.span("render.preprocess"):
                    time.sleep(0.003)
                with profiling.span("render.binning"):
                    time.sleep(0.001)
            with profiling.span("optim"):
                time.sleep(0.001)
        with profiling.span("distill.step"):
            with profiling.span("optim"):
                time.sleep(0.001)
    snap = profiling.snapshot()
    sp = snap["spans"]
    assert snap["units"] == {"distill.step": 2}
    assert sp["optim"]["calls"] == 2 and sp["render"]["calls"] == 1
    for k in ("host", "device"):
        tot, own = f"{k}_ms", f"self_{k}_ms"
        assert sp["render"][own] == pytest.approx(
            sp["render"][tot] - sp["render.preprocess"][tot]
            - sp["render.binning"][tot], abs=1e-9)
        assert sp["distill.step"][own] == pytest.approx(
            sp["distill.step"][tot] - sp["render"][tot] - sp["optim"][tot],
            abs=1e-9)
        assert sp["render.preprocess"][own] == sp["render.preprocess"][tot]
        # self times add up to the roots' durations
        assert sum(v[own] for v in sp.values()) == pytest.approx(
            sp["distill.step"][tot], abs=1e-9)
    # on the CPU the device is the host
    assert all(v["device_ms"] == v["host_ms"] for v in sp.values())
    assert sp["render.preprocess"]["host_ms"] >= 3.0
    assert 2.0 <= sp["optim"]["host_ms"]


def test_a_unit_inside_another_counts_apart_and_a_unit_joins_itself():
    """A unit opened inside another unit (the viewer's frame inside a RES
    request) is a unit of its own and owns its spans; a unit's span
    opened while that unit is open (predict_mask's request inside the
    caller's) joins it: no call, no unit, its spans the open unit's."""
    with cpu_profile():
        with profiling.span("res.request"):
            with profiling.span("query.frame"):
                with profiling.span("render"):
                    pass
            with profiling.span("res.request"):
                with profiling.span("res.host"):
                    pass
        with profiling.span("res.request"):
            with profiling.span("res.host"):
                pass
    snap = profiling.snapshot()
    recs = profiling.records()
    assert [r[0] for r in recs] == ["render", "query.frame", "res.host",
                                    "res.request", "res.host",
                                    "res.request"]
    (_, render_id, render_parent, render_unit), \
        (_, frame_id, frame_parent, frame_unit), \
        (_, _, host_parent, host_unit), (_, outer, outer_parent, _), \
        (_, _, host2_parent, host2_unit), (_, second, _, _) = recs
    assert outer_parent is None
    assert (frame_parent, frame_unit) == (outer, frame_id)
    assert (render_parent, render_unit) == (frame_id, frame_id)
    assert (host_parent, host_unit) == (outer, outer)
    assert (host2_parent, host2_unit) == (second, second)
    assert snap["units"] == {"res.request": 2, "query.frame": 1}
    sp = snap["spans"]
    assert sp["res.request"]["calls"] == 2
    assert sp["query.frame"]["calls"] == 1 and sp["res.host"]["calls"] == 2
    # the outer request's self time leaves out the frame and its own host
    # work; the frame's, its render
    assert sp["query.frame"]["self_host_ms"] == pytest.approx(
        sp["query.frame"]["host_ms"] - sp["render"]["host_ms"], abs=1e-9)
    assert sum(v["self_host_ms"] for v in sp.values()) == pytest.approx(
        sp["res.request"]["host_ms"], abs=1e-9)


def test_counters_hold_the_binning_and_the_blend(monkeypatch):
    """binning.kept and binning.sorted_slots are the chunked binning's
    last tile end and budget; blend.walked and blend.blended raw's own
    count channels, summed; host ints and device scalars add up."""
    raws, binnings = [], []
    real_composite = cuda_blend.composite
    real_bin = render_mod.bin_splats_chunked

    def composite(raw, bg, s):
        raws.append((raw.detach().clone(), s))
        return real_composite(raw, bg, s)

    def bin_chunked(*a, **k):
        b = real_bin(*a, **k)
        binnings.append(b)
        return b

    monkeypatch.setattr(cuda_blend, "composite", composite)
    monkeypatch.setattr(render_mod, "bin_splats_chunked", bin_chunked)
    scene = make_scene()
    with cpu_profile():
        for azim in (0.0, 0.7):
            render(scene, make_camera(azim), torch.zeros(3), CFG)
    c = profiling.snapshot()["counters"]
    assert len(raws) == len(binnings) == 2
    assert c["binning.sorted_slots"] == 2 * CFG.max_instances
    assert c["binning.kept"] == sum(int(b.tile_end[-1]) for b in binnings)
    assert c["blend.walked"] == sum(float(r[..., 5 + s].double().sum())
                                    for r, s in raws)
    assert c["blend.blended"] == sum(float(r[..., 6 + s].double().sum())
                                     for r, s in raws)
    assert 0 < c["binning.kept"] <= c["binning.sorted_slots"]
    assert 0 < c["blend.blended"] <= c["blend.walked"]
    assert isinstance(c["binning.kept"], int)
    assert isinstance(c["blend.walked"], float)


@pytest.mark.parametrize("value", [3, torch.tensor(3, dtype=torch.int32),
                                   torch.tensor(3.0)])
def test_count_accumulates_only_while_armed(value):
    profiling.count("blend.walked", value)
    assert profiling.snapshot()["counters"] == {}
    with cpu_profile():
        profiling.count("blend.walked", value)
        profiling.count("blend.walked", value)
    total = profiling.snapshot()["counters"]["blend.walked"]
    assert total == 6 and type(total) is type(value if isinstance(
        value, int) else value.item())


def train_twice(seed):
    state, step, gt = make_step(seed)
    aux = []
    for i in range(2):
        state, a = step(state, make_camera(0.3 * i), gt, torch.zeros(3), CFG)
        aux.append(a)
    opt = state.opt_scene.state[state.scene.semantics]
    return ([state.scene.semantics, state.lut, opt["exp_avg"],
             opt["exp_avg_sq"]] + list(state.decoder.parameters())
            + [a[k] for a in aux for k in sorted(a)])


def render_grads(seed):
    scene = make_scene(seed)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in scene.params().items()}
    scene = scene.with_params(params)
    out = render(scene, make_camera(0.4), torch.zeros(3), CFG)
    w = torch.linspace(-1.0, 1.0, out["semantics"].numel()).reshape(
        out["semantics"].shape)
    ((out["semantics"] * w).sum() + out["render"].sum()).backward()
    return [out["render"], out["semantics"]] + [p.grad for p in
                                                params.values()]


@pytest.mark.parametrize("path", ["train_step", "render_backward",
                                  "render_view"])
def test_outputs_and_gradients_bit_identical_armed_and_disarmed(path):
    def go():
        if path == "train_step":
            return train_twice(4)
        if path == "render_backward":
            return render_grads(5)
        return [torch.as_tensor(make_session(6).render_view(
            make_camera(0.9), as_u8=True))]

    off = go()
    with cpu_profile():
        on = go()
    assert profiling.snapshot()["units"] or path == "render_backward"
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert (a is None and b is None) or torch.equal(a, b)
