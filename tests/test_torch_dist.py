"""goi_tpu_torch.dist in four gloo processes on the CPU, against
goi_tpu.dist on the conftest's virtual CPU devices (pallas backend in
interpret mode, as tests/test_sharded_render.py runs it) and against the
port's own one-process render() and train_step.

One launch of four workers (tests/torch_dist_worker.py, joined through
init_multihost's GOI_COORD / GOI_NUM_PROCS / GOI_PROC_ID variables) runs
every case; the JAX side and the port's one-process references run here
meanwhile. The workers read their inputs from an .npz this module writes
from numpy seeds and write their outputs back the same way.

Tolerances, from the JAX test each case mirrors: frames 3e-5 against
render() (test_sharded_forward_matches_single_device) and 5e-5 against
goi_tpu's pallas frames (test_sharded_pallas_backend_interpret);
gradients within the flip budget of
test_sharded_chunked_gradients_match_single_device (at most 0.5% of the
elements past 5e-7 + 2e-4 |a|, none past 5e-5). The JAX package has no
test of its sharded distillation step, so the port's is held to its
one-process train_step at tests/test_torch_train.py's tolerances (loss
terms rtol 1e-5, gradients 2e-3 / 2e-4).

On the CPU the port's sharded frame is bit-equal to its render() on
these scenes: the row0 shift of mean2d (y - row0 * 16) is exact for
every splat here. It need not be in general (a far splat's shift
rounds), hence the tolerance on the card.
"""

import datetime
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from goi_tpu.dist.mesh import make_mesh as j_make_mesh
from goi_tpu.dist.mesh import shard_scene as j_shard_scene
from goi_tpu.dist.render import render_sharded as j_render_sharded
from goi_tpu.raster import RasterConfig as JConfig
from goi_tpu_torch import interop
from goi_tpu_torch.dist import init_multihost
from goi_tpu_torch.dist.multihost import free_port, spawn, wait_all
from goi_tpu_torch.raster.render import RasterConfig, render
from goi_tpu_torch.train.distill import create_distill_state, distill_loss
from goi_tpu_torch.train.optim import OptimConfig, set_scheduled_lr
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
CFG = RasterConfig(max_instances=1 << 14)
JCFG = JConfig(max_instances=1 << 14, backend="pallas")
IMAGES = ("render", "semantics", "depth", "alpha")
# the starved instance budgets of the overflow case, over all four ranks
# (tests/torch_dist_worker.py runs the same)
STARVED = (1024, 512)
TERMS = ("lab", "sl", "sl1", "recc", "total")
ALL_ON = dict(position_finetune=True, feature_finetune=True,
              opacity_finetune=True, scaling_finetune=True,
              rotation_finetune=True, semantic_finetune=True)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _scene_fields(name, js):
    out = {f"{name}_{k}": np.asarray(getattr(js, k))
           for k in js.PARAM_FIELDS + ("valid",)}
    out[f"{name}.sh"] = np.array([js.active_sh_degree, js.max_sh_degree])
    return out


def _camera_fields(name, cams):
    one = not isinstance(cams, list)
    cams = [cams] if one else cams
    out = {f"{name}.{k}": np.stack([np.asarray(getattr(c, k)) for c in cams])
           for k in ("world_view", "full_proj", "camera_center", "tan_fovx",
                     "tan_fovy")}
    if one:
        out = {k: v[0] for k, v in out.items()}
    out[f"{name}.size"] = np.array([cams[0].width, cams[0].height])
    return out


def _inputs():
    """The seeded scenes and cameras of the JAX tests mirrored."""
    rng = np.random.default_rng(13)
    a = make_random_scene(n=256, seed=0, capacity=256)
    b = make_random_scene(n=256, seed=2, capacity=256)
    c = make_random_scene(n=2048, seed=5, capacity=2048)
    c = c.replace(scaling=jnp.full_like(c.scaling, float(np.log(0.01))))
    cams = dict(a=make_test_camera(width=64, height=64),
                b=make_test_camera(width=64, height=80),
                c=make_test_camera(width=64, height=256),
                d=[make_test_camera(width=32, height=32, angle=t)
                   for t in (0.3, 0.9)])
    data = dict(_scene_fields("a", a), **_scene_fields("b", b),
                **_scene_fields("c", c))
    for k, v in cams.items():
        data.update(_camera_fields(f"cam_{k}", v))
    data["tgt_a"] = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                                 (3, 64, 64)))
    data["gts"] = rng.normal(0, 1, (2, 16, 32, 32)).astype(np.float32)
    data["dec.w"] = rng.normal(0, 0.3, (8, 10)).astype(np.float32)
    data["dec.b"] = rng.normal(0, 0.1, 8).astype(np.float32)
    data["lut"] = (0.1 * rng.normal(0, 1, (8, 16))).astype(np.float32)
    return (a, b, c), cams, data


def _jax_refs(scenes, cams, tgt):
    """goi_tpu's sharded render on make_mesh(1, 4) (and (1, 2))."""
    a, b, c = scenes
    bg = jnp.zeros(3)
    mesh = j_make_mesh(1, WORLD)
    sh_a = j_shard_scene(a, mesh)
    refs = {"gather": jax.jit(lambda s: j_render_sharded(
        s, cams["a"], bg, JCFG, mesh))(sh_a)}
    for reduce in ("chain", "scatter"):
        cfg = JConfig(max_instances=1 << 14, backend="pallas", reduce=reduce)

        def loss(params, cfg=cfg):
            out = j_render_sharded(a.with_params(params), cams["a"], bg, cfg,
                                   mesh)
            return jnp.mean(out["render"] * tgt) + jnp.mean(out["semantics"])

        refs[f"grad_{reduce}"] = jax.jit(jax.grad(loss))(sh_a.params())
    refs["autopad"] = jax.jit(lambda s: j_render_sharded(
        s, cams["b"], bg, JCFG, mesh))(j_shard_scene(b, mesh))
    refs["rows_probe"] = jax.jit(lambda s: j_render_sharded(
        s, cams["a"], bg, JCFG, mesh, exchange="rows",
        exchange_cap=a.capacity))(sh_a)
    for d in (2, 4):
        m = j_make_mesh(1, d)
        refs[f"memory{d}"] = jax.jit(lambda s, m=m, d=d: j_render_sharded(
            s, cams["c"], bg, JCFG, m, exchange="rows",
            exchange_cap=c.capacity // d))(j_shard_scene(c, m))
    for small in STARVED:
        cfg = JConfig(max_instances=small, backend="pallas")
        refs[f"overflow_{small}"] = jax.jit(lambda s, cfg=cfg:
                                            j_render_sharded(
            s, cams["a"], bg, cfg, mesh))(sh_a)
    return refs


def _grads(scene, cam, cfg, loss):
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in scene.params().items()}
    out = render(scene.with_params(leaves), cam, torch.zeros(3), cfg)
    loss(out).backward()
    return {k: v.grad.numpy() for k, v in leaves.items()}, out


def _distill_reference(a, cams, data, n_cams):
    """The port's one-process step on the first n_cams cameras: train_step
    itself for one camera, its loss averaged over the batch for more."""
    dec = interop.decoder_from_numpy([data["dec.w"]], [data["dec.b"]],
                                     device="cpu")
    state, train_step = create_distill_state(
        a, dec, torch.as_tensor(data["lut"]), OptimConfig(**ALL_ON))
    bg = torch.zeros(3)
    gts = torch.as_tensor(data["gts"])
    if n_cams == 1:
        state, aux = train_step(state, cams[0], gts[0], bg, CFG)
        terms = [float(aux[k]) for k in TERMS]
    else:
        outs = [distill_loss(state, cam, gt, bg, CFG)
                for cam, gt in zip(cams[:n_cams], gts)]
        (sum(loss for loss, _ in outs) / n_cams).backward()
        set_scheduled_lr(state.opt_scene, state.step)
        for o in (state.opt_scene, state.opt_decoder, state.opt_lut):
            o.step()
        terms = [float(sum(aux[k].detach() for _, aux in outs)) / n_cams
                 for k in TERMS]
    grads = {k: v.grad.numpy() for k, v in state.scene.params().items()}
    grads.update(dec_w=state.decoder.weights[0].grad.numpy(),
                 lut=state.lut.grad.numpy())
    params = {k: v.detach().numpy() for k, v in state.scene.params().items()}
    params["lut"] = state.lut.detach().numpy()
    return np.array(terms), grads, params


def _sweep_models(root):
    """Five model directories with one seeded test render and its ground
    truth each, for eval_sweep --skip_render."""
    from goi_tpu_torch.utils.image import save_image
    rng = np.random.default_rng(3)
    models = []
    for i in range(5):
        for kind in ("renders", "gt"):
            d = root / f"model{i}" / "test" / "ours_1" / kind
            d.mkdir(parents=True)
            save_image(rng.uniform(0, 1, (3, 16, 16)).astype(np.float32),
                       str(d / "00000.png"))
        models.append(str(root / f"model{i}"))
    return models


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the four workers, compute the references meanwhile, then
    gather every rank's outputs."""
    tmp = tmp_path_factory.mktemp("dist")
    scenes, cams, data = _inputs()
    data["sweep.models"] = np.array(_sweep_models(tmp))
    data["sweep.out"] = np.array(str(tmp / "sweep_results.json"))
    np.savez(tmp / "inputs.npz", **data)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = spawn([sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
                   str(tmp / "inputs.npz"), str(tmp)], WORLD,
                  env=dict(env, PYTHONPATH=str(ROOT)), stdout=logs)
    try:
        jax_refs = _jax_refs(scenes, cams, jnp.asarray(data["tgt_a"]))
        a, b, c = (to_torch_scene(s) for s in scenes)
        tcams = {k: (to_torch_camera(v) if not isinstance(v, list)
                     else [to_torch_camera(x) for x in v])
                 for k, v in cams.items()}
        tgt = torch.tensor(data["tgt_a"])

        def loss(o):
            return torch.mean(o["render"] * tgt) + torch.mean(o["semantics"])

        refs = {"render_a": render(a, tcams["a"], torch.zeros(3), CFG),
                "render_b": render(b, tcams["b"], torch.zeros(3), CFG),
                "render_c": render(c, tcams["c"], torch.zeros(3), CFG)}
        for reduce in ("chain", "scatter"):
            refs[f"grad_{reduce}"], _ = _grads(
                a, tcams["a"], RasterConfig(max_instances=1 << 14,
                                            reduce=reduce), loss)
        refs["distill1"] = _distill_reference(a, tcams["d"], data, 1)
        refs["distill2"] = _distill_reference(a, tcams["d"], data, 2)
    finally:
        codes = wait_all(procs, timeout=300)
        for log in logs:
            log.close()
    for r, code in enumerate(codes):
        assert code == 0, (tmp / f"rank{r}.log").read_text()
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    sweep = json.loads((tmp / "sweep_results.json").read_text())
    return dict(ranks=ranks, jax=jax_refs, port=refs, data=data,
                sweep=sweep)


def _shards(ranks, key, parts=WORLD):
    """The model shards of ranks 0..parts-1 joined along rows."""
    return np.concatenate([ranks[r][key] for r in range(parts)])


def _flip_budget(a, b, name, max_abs=5e-5):
    """test_sharded_chunked_gradients_match_single_device's bar."""
    a, b = np.asarray(a), np.asarray(b)
    d = np.abs(a - b)
    frac = np.mean(d > 5e-7 + 2e-4 * np.abs(a))
    assert frac <= 0.005, (name, frac)
    np.testing.assert_allclose(a, b, rtol=0, atol=max_abs, err_msg=name)


def _frames(got, prefix, want, tol, exact=False):
    for r, out in enumerate(got):
        for k in IMAGES:
            a, b = out[f"{prefix}.{k}"], np.asarray(want[k])
            assert a.shape == b.shape, (k, a.shape, b.shape)
            if exact:
                np.testing.assert_array_equal(a, b, err_msg=f"rank {r} {k}")
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                       err_msg=f"rank {r} {k}")


def test_gather_forward_matches_goi_tpu_and_render(run):
    """The 'gather' exchange: every rank's frame bit-equal to render()'s
    (within 3e-5 stated) and within 5e-5 of goi_tpu's sharded pallas
    frame; the gathered radii equal."""
    ranks = run["ranks"]
    _frames(ranks, "gather", run["port"]["render_a"], 3e-5, exact=True)
    _frames(ranks, "gather", run["jax"]["gather"], 5e-5)
    for out in ranks:
        np.testing.assert_array_equal(out["gather.radii"],
                                      np.asarray(run["jax"]["gather"]
                                                 ["radii"]))


@pytest.mark.parametrize("reduce", ["chain", "scatter"])
def test_sharded_gradients_match(reduce, run):
    """Gradients through the splat gather and its backward (the ranks'
    gradients summed to the owner), with the 'chain' and the 'scatter'
    reduce, against render()'s and goi_tpu's sharded ones."""
    want_port = run["port"][f"grad_{reduce}"]
    want_jax = run["jax"][f"grad_{reduce}"]
    for k in want_port:
        got = _shards(run["ranks"], f"grad_{reduce}.{k}")
        _flip_budget(want_port[k], got, f"{reduce} {k} vs render")
        _flip_budget(np.asarray(want_jax[k]), got, f"{reduce} {k} vs jax")


def test_nondivisible_rows_auto_pad(run):
    """5 tile rows over 4 ranks: padded with rows below the frame."""
    ranks = run["ranks"]
    assert ranks[0]["autopad.render"].shape == (3, 80, 64)
    _frames(ranks, "autopad", run["port"]["render_b"], 3e-5)
    _frames(ranks, "autopad", run["jax"]["autopad"], 5e-5)


def test_rows_exchange_forward_and_gradients(run):
    """exchange='rows' at the cap of a lossless probe (demand <= cap, the
    probe's demand equal to goi_tpu's): the frame and the gradients as
    the 'gather' exchange's."""
    ranks = run["ranks"]
    demand, cap = ranks[0]["rows.demand_cap"]
    assert demand <= cap
    assert cap == int(run["jax"]["rows_probe"]["exchange_demand"])
    _frames(ranks, "rows", run["port"]["render_a"], 3e-5)
    _frames(ranks, "rows", run["jax"]["gather"], 5e-5)
    want = run["port"]["grad_scatter"]
    for k in want:
        _flip_budget(want[k], _shards(ranks, f"grad_rows.{k}"), k)


def test_rows_exchange_overflow_reports_demand(run):
    """exchange_cap=8: the demand is reported above the cap and the frame
    completes from the truncated rows."""
    for out in run["ranks"]:
        demand, cap = out["rows8.demand_cap"]
        assert cap == 8 and demand > 8
        assert tuple(out["rows8.shape"]) == (3, 64, 64)


def test_rows_exchange_rows_shrink_with_ranks(run):
    """test_rows_exchange_memory_scales_inverse_with_devices at D = 2 and
    D = 4 (four ranks): the received rows per rank shrink by at least 30%
    when D doubles and stay under 0.6 N at D = 4; each D's lossless
    probe demands what goi_tpu's does, and its frame is render()'s."""
    ranks = run["ranks"]
    n = 2048
    rows = {}
    for d in (2, 4):
        demand, cap, per_rank = ranks[0][f"memory{d}.demand_cap"]
        assert demand <= cap and per_rank == d * cap
        assert cap == int(run["jax"][f"memory{d}"]["exchange_demand"])
        rows[d] = per_rank
        _frames(ranks, f"memory{d}", run["port"]["render_c"], 3e-5)
    assert rows[4] <= 0.7 * rows[2], rows
    assert rows[4] < 0.6 * n, rows


@pytest.mark.parametrize("small", STARVED)
def test_overflow_detected_and_regrown(small, run):
    """A starved budget (`small` over 4 ranks): num_slots above
    local_budget, as goi_tpu's; regrown to the demand, within budget and
    render()'s frame again."""
    ranks = run["ranks"]
    demand, budget, demand2, budget2 = ranks[0][f"overflow_{small}.slots"]
    assert budget == small // WORLD and demand > budget
    assert demand == int(run["jax"][f"overflow_{small}"]["num_slots"])
    assert demand2 <= budget2
    _frames(ranks, f"overflow_{small}", run["port"]["render_a"], 3e-5)


def test_frame_gradient_is_not_scaled_by_ranks(run):
    """gather_frame_rows: the slabs joined in rank order, and the gradient
    of a loss every rank computes alike is this rank's slab of it, not D
    times it, with no collective in the backward (the worker makes every
    torch.distributed collective raise during the backward)."""
    w = np.arange(2 * 12 * 4, dtype=np.float32).reshape(2, 12, 4) + 1
    slabs = [np.arange(24, dtype=np.float32).reshape(2, 3, 4) + 100 * r
             for r in range(WORLD)]
    for r, out in enumerate(run["ranks"]):
        np.testing.assert_array_equal(out["trap.frame"],
                                      np.concatenate(slabs, axis=1))
        np.testing.assert_array_equal(out["trap.grad"],
                                      w[:, 3 * r:3 * r + 3])


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_sharded_distill_step_matches_train_step(mesh, run):
    """One make_sharded_distill_step step (every scene attribute trained)
    on the (1, 4) mesh with one camera against train_step, and on the
    (2, 2) mesh with two cameras against the one-process step on their
    mean loss: loss terms rtol 1e-5, every gradient 2e-3 / 2e-4, and the
    updated parameters equal wherever the gradient is past the 2e-4
    atol (Adam's first step moves a parameter by lr * sign(g), so a
    gradient within rounding of 0 may move it either way)."""
    nd, nm = mesh
    terms, grads, params = run["port"][f"distill{nd}"]
    ranks = run["ranks"]
    tag = f"distill{nd}{nm}"
    for r, out in enumerate(ranks):
        assert tuple(out[f"{tag}.coords"]) == divmod(r, nm)
        np.testing.assert_allclose(out[f"{tag}.terms"], terms, rtol=1e-5)
    for d in range(nd):
        group = ranks[d * nm:(d + 1) * nm]
        for k, want in grads.items():
            if k in ("dec_w", "lut"):
                got = [out[f"{tag}.grad.{k}"] for out in group]
                assert all(np.array_equal(g, got[0]) for g in got)
                got = got[0]
            else:
                got = _shards(group, f"{tag}.grad.{k}", nm)
            np.testing.assert_allclose(got, want, err_msg=k, **GRAD_TOL)
        for k, want in params.items():
            got = (group[0][f"{tag}.param.lut"] if k == "lut"
                   else _shards(group, f"{tag}.param.{k}", nm))
            moved = np.abs(grads[k]) > GRAD_TOL["atol"]
            np.testing.assert_allclose(got[moved], want[moved], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_multihost_helpers(run):
    """local_camera_indices strides the cameras over the ranks;
    scene_sharding, shard_scene_global and interop.scene_shard_from_numpy
    give each rank rows [r N / 4, (r + 1) N / 4), copied: a shard keeps
    no reference to the whole scene's storage."""
    data = run["data"]
    for r, out in enumerate(run["ranks"]):
        assert list(out["helpers.cams"]) == list(range(r, 10, WORLD))
        assert list(out["helpers.rows"]) == [64 * r, 64 * (r + 1)]
        assert bool(out["helpers.same_rows"][0])
        assert bool(out["helpers.own_storage"][0])
        np.testing.assert_array_equal(out["helpers.xyz_rows"],
                                      data["a_xyz"][64 * r:64 * (r + 1)])
        np.testing.assert_array_equal(out["helpers.replicated"], data["lut"])


def test_spawn_joins_the_ranks_and_kills_at_the_timeout(tmp_path):
    """spawn gives rank r GOI_PROC_ID=r, LOCAL_RANK=r and one coordinator;
    wait_all returns the exit codes, None for a rank killed at its
    timeout."""
    code = ("import os, sys, time; e = os.environ; "
            "print(e['GOI_COORD'], e['GOI_NUM_PROCS'], e['LOCAL_RANK']); "
            "r = int(e['GOI_PROC_ID']); time.sleep(60 * (r == 2)); "
            "sys.exit(r)")
    logs = [open(tmp_path / f"{r}.log", "w") for r in range(3)]
    codes = wait_all(spawn([sys.executable, "-c", code], 3, stdout=logs),
                     timeout=5)
    for f in logs:
        f.close()
    assert codes == [0, 1, None]
    lines = [(tmp_path / f"{r}.log").read_text().split() for r in range(2)]
    assert lines[0][0] == lines[1][0].strip()
    assert lines[0][0].startswith("127.0.0.1:")
    assert [x[1:] for x in lines] == [["3", "0"], ["3", "1"]]


def test_scale_budget_and_eval_sweep(run):
    """goi_tpu_torch.scale's probed budget covers every rank's demand
    and its rank counts divide the tile rows; goi_tpu_torch.eval_sweep
    in the group scores each model on one rank and rank 0 joins all five
    into sweep_results.json."""
    for out in run["ranks"]:
        per_rank, demand = out["scale.budget"]
        assert demand <= per_rank
        assert list(out["scale.counts"]) == [1, 2, 4]
    sweep = run["sweep"]
    models = [str(m) for m in run["data"]["sweep.models"]]
    assert sorted(sweep["scenes"]) == sorted(models)
    psnr = [sweep["scenes"][m]["PSNR"] for m in models]
    assert np.isfinite(psnr).all()
    np.testing.assert_allclose(sweep["mean"]["PSNR"], np.mean(psnr),
                               rtol=1e-6)


def test_init_multihost_raises_when_the_group_cannot_form():
    """A coordinator that nobody serves: init_multihost raises after its
    timeout and leaves no group (it never carries on as one process)."""
    with pytest.raises(RuntimeError):
        init_multihost(f"127.0.0.1:{free_port()}", 2, 1, device="cpu",
                       timeout=datetime.timedelta(seconds=2))
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        init_multihost("127.0.0.1:1", 2, 5, device="cpu")


def test_init_multihost_without_variables_is_one_process(monkeypatch):
    for k in ("GOI_COORD", "GOI_NUM_PROCS", "GOI_PROC_ID", "RANK",
              "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert init_multihost(device="cpu") is False
    assert not dist.is_initialized()


def test_render_batch_takes_a_stacked_camera():
    """render_batch renders a stack_cameras batch as it renders the list;
    stack_cameras refuses cameras of different sizes."""
    from goi_tpu_torch.dist import stack_cameras
    from goi_tpu_torch.raster.render import render_batch
    ts = to_torch_scene(make_random_scene(n=200, seed=4))
    cams = [to_torch_camera(make_test_camera(width=48, height=32, angle=a))
            for a in (0.1, 0.7)]
    stacked = stack_cameras(cams)
    assert stacked.world_view.shape == (2, 4, 4) and stacked.width == 48
    a = render_batch(ts, stacked, torch.zeros(3), CFG)
    b = render_batch(ts, cams, torch.zeros(3), CFG)
    for k in IMAGES + ("radii", "num_slots"):
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError):
        stack_cameras([cams[0], to_torch_camera(make_test_camera(32, 32))])
