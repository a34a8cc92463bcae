"""Worker process for tests/test_torch_dist.py: one rank of a four-process
gloo group on the CPU. It joins through init_multihost's GOI_COORD /
GOI_NUM_PROCS / GOI_PROC_ID variables, runs every case of the test on
the inputs of the .npz named by argv[1] and writes its outputs to
<argv[2]>/rank<r>.npz. Imports only torch and goi_tpu_torch."""

import sys

import numpy as np
import torch
import torch.distributed as dist

from goi_tpu_torch import eval_sweep, interop, scale
from goi_tpu_torch.core.camera import stack_cameras
from goi_tpu_torch.dist import (init_multihost, local_camera_indices,
                                make_global_mesh, make_mesh,
                                make_sharded_distill_step, render_sharded,
                                scene_sharding, shard_batch, shard_scene,
                                shard_scene_global)
from goi_tpu_torch.dist import collectives
from goi_tpu_torch.dist.multihost import replicate_to_global, shard_rows_global
from goi_tpu_torch.raster.render import RasterConfig
from goi_tpu_torch.train.optim import OptimConfig

torch.set_num_threads(1)

CFG = RasterConfig(max_instances=1 << 14)
IMAGES = ("render", "semantics", "depth", "alpha")
ALL_ON = dict(position_finetune=True, feature_finetune=True,
              opacity_finetune=True, scaling_finetune=True,
              rotation_finetune=True, semantic_finetune=True)
COMMS = ("all_gather", "all_gather_into_tensor", "all_to_all_single",
         "all_reduce", "reduce_scatter", "reduce_scatter_tensor",
         "broadcast", "send", "recv")


def scene(inp, name):
    fields = {k[len(name) + 1:]: inp[k] for k in inp.files
              if k.startswith(name + "_")}
    return interop.scene_from_numpy(
        fields, active_sh_degree=int(inp[f"{name}.sh"][0]),
        max_sh_degree=int(inp[f"{name}.sh"][1]), device="cpu")


def camera(inp, name, i=None):
    f = {k: inp[f"{name}.{k}"] if i is None else inp[f"{name}.{k}"][i]
         for k in ("world_view", "full_proj", "camera_center", "tan_fovx",
                   "tan_fovy")}
    w, h = inp[f"{name}.size"]
    return interop.camera_from_numpy(**f, width=int(w), height=int(h),
                                     device="cpu")


def frame(out, prefix, res):
    for k in IMAGES:
        out[f"{prefix}.{k}"] = res[k].detach().numpy()


def sharded_grads(shard, cam, cfg, mesh, tgt, **kw):
    """The shard's gradients of the JAX test's loss mean(render * tgt) +
    mean(semantics) through render_sharded."""
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in shard.params().items()}
    res = render_sharded(shard.with_params(leaves), cam, torch.zeros(3), cfg,
                         mesh, **kw)
    (torch.mean(res["render"] * tgt) + torch.mean(res["semantics"])) \
        .backward()
    return {k: v.grad.numpy() for k, v in leaves.items()}, res


def main(inp_path, out_dir):
    assert init_multihost(device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 4
    inp = np.load(inp_path)
    out = {}
    bg = torch.zeros(3)
    mesh = make_mesh(1, 4, device="cpu")
    a, cam_a = scene(inp, "a"), camera(inp, "cam_a")
    tgt = torch.as_tensor(inp["tgt_a"])
    sh_a = shard_scene(a, mesh)

    # the 'gather' exchange: frame and gradients with both reduces
    res = render_sharded(sh_a, cam_a, bg, CFG, mesh)
    frame(out, "gather", res)
    out["gather.radii"] = res["radii"].numpy()
    for reduce in ("chain", "scatter"):
        cfg = RasterConfig(max_instances=1 << 14, reduce=reduce)
        g, _ = sharded_grads(sh_a, cam_a, cfg, mesh, tgt)
        out.update({f"grad_{reduce}.{k}": v for k, v in g.items()})

    # 5 tile rows over 4 ranks
    b, cam_b = scene(inp, "b"), camera(inp, "cam_b")
    frame(out, "autopad", render_sharded(shard_scene(b, mesh), cam_b, bg,
                                         CFG, mesh))

    # the 'rows' exchange after a lossless probe, and a starved cap
    probe = render_sharded(sh_a, cam_a, bg, CFG, mesh, exchange="rows",
                           exchange_cap=sh_a.capacity)
    cap = int(probe["exchange_demand"])
    g, res = sharded_grads(sh_a, cam_a, CFG, mesh, tgt, exchange="rows",
                           exchange_cap=cap)
    frame(out, "rows", res)
    out.update({f"grad_rows.{k}": v for k, v in g.items()})
    out["rows.demand_cap"] = np.array([int(res["exchange_demand"]),
                                       res["exchange_cap"]])
    res = render_sharded(sh_a, cam_a, bg, CFG, mesh, exchange="rows",
                         exchange_cap=8)
    out["rows8.demand_cap"] = np.array([int(res["exchange_demand"]),
                                        res["exchange_cap"]])
    out["rows8.shape"] = np.array(res["render"].shape)

    # received rows per rank at D = 2 (the 'model' axis of a (2, 2)
    # mesh) and D = 4
    c, cam_c = scene(inp, "c"), camera(inp, "cam_c")
    mesh22 = make_mesh(2, 2, device="cpu")
    for d, m in ((2, mesh22), (4, mesh)):
        sh = shard_scene(c, m)
        probe = render_sharded(sh, cam_c, bg, CFG, m, exchange="rows",
                               exchange_cap=c.capacity // d)
        cap = int(probe["exchange_demand"])
        res = render_sharded(sh, cam_c, bg, CFG, m, exchange="rows",
                             exchange_cap=cap)
        out[f"memory{d}.demand_cap"] = np.array(
            [int(res["exchange_demand"]), cap,
             res["exchange_rows_per_device"]])
        frame(out, f"memory{d}", res)

    # a starved budget: overflow reported, then regrown, at two budgets
    for small in (1024, 512):
        res = render_sharded(sh_a, cam_a, bg,
                             RasterConfig(max_instances=small), mesh)
        demand = int(res["num_slots"])
        grown = RasterConfig(max_instances=4 * (-(-demand // 256) * 256))
        res2 = render_sharded(sh_a, cam_a, bg, grown, mesh)
        out[f"overflow_{small}.slots"] = np.array(
            [demand, res["local_budget"], int(res2["num_slots"]),
             res2["local_budget"]])
        frame(out, f"overflow_{small}", res2)

    # the frame gradient of a replicated loss: this rank's slab of it,
    # with no collective in the backward
    x = (torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
         + 100 * rank).requires_grad_(True)
    w = torch.arange(2 * 12 * 4, dtype=torch.float32).reshape(2, 12, 4) + 1
    full = collectives.gather_frame_rows(x, mesh.group("model"))
    saved = {k: getattr(dist, k) for k in COMMS if hasattr(dist, k)}

    def forbidden(*args, **kwargs):
        raise AssertionError("the frame's backward communicated")

    try:
        for k in saved:
            setattr(dist, k, forbidden)
        (full * w).sum().backward()
    finally:
        for k, f in saved.items():
            setattr(dist, k, f)
    out["trap.frame"] = full.detach().numpy()
    out["trap.grad"] = x.grad.numpy()

    # one sharded distillation step on the (1, 4) and (2, 2) meshes
    weights = [inp["dec.w"]]
    biases = [inp["dec.b"]]
    for (nd, nm), m in (((1, 4), mesh), ((2, 2), mesh22)):
        init_fn, step_fn = make_sharded_distill_step(
            OptimConfig(**ALL_ON), CFG, mesh=m)
        state = init_fn(shard_scene(a, m),
                        interop.decoder_from_numpy(weights, biases,
                                                   device="cpu"),
                        torch.as_tensor(inp["lut"]))
        cams = stack_cameras([camera(inp, "cam_d", i) for i in range(nd)])
        c_b, g_b = shard_batch(m, cams, inp["gts"][:nd])
        state, aux = step_fn(state, c_b, g_b, bg)
        tag = f"distill{nd}{nm}"
        out[f"{tag}.terms"] = np.array([float(aux[k]) for k in
                                        ("lab", "sl", "sl1", "recc",
                                         "total")])
        out[f"{tag}.slots"] = np.array([int(aux["num_slots"])])
        for k, v in state.scene.params().items():
            out[f"{tag}.grad.{k}"] = v.grad.numpy()
            out[f"{tag}.param.{k}"] = v.detach().numpy()
        out[f"{tag}.grad.dec_w"] = state.decoder.weights[0].grad.numpy()
        out[f"{tag}.grad.lut"] = state.lut.grad.numpy()
        out[f"{tag}.param.lut"] = state.lut.detach().numpy()
        out[f"{tag}.coords"] = np.array([m.index("data"), m.index("model")])

    # the multi-process helpers
    gm = make_global_mesh(1, 4, device="cpu")
    out["helpers.cams"] = np.array(local_camera_indices(10))
    rows = scene_sharding(gm).rows(a.capacity)
    out["helpers.rows"] = np.array([rows.start, rows.stop])
    glob = shard_scene_global(a, gm)
    fields = {k: inp[f"a_{k}"] for k in a.PARAM_FIELDS + ("valid",)}
    own = interop.scene_shard_from_numpy(
        fields, rank, world, "cpu", active_sh_degree=a.active_sh_degree,
        max_sh_degree=a.max_sh_degree)
    out["helpers.same_rows"] = np.array([all(
        torch.equal(getattr(glob, k), getattr(own, k))
        and torch.equal(getattr(glob, k), getattr(sh_a, k))
        for k in a.PARAM_FIELDS + ("valid",))])
    out["helpers.own_storage"] = np.array([all(
        getattr(glob, k).untyped_storage().data_ptr()
        != getattr(a, k).untyped_storage().data_ptr()
        for k in a.PARAM_FIELDS + ("valid",))])
    out["helpers.xyz_rows"] = shard_rows_global(inp["a_xyz"], gm).numpy()
    out["helpers.replicated"] = replicate_to_global(inp["lut"], gm).numpy()

    # the entry points' pieces: scale.py's probed budget holds the
    # demand; eval_sweep strides the models over the ranks
    budget = scale.sharded_budget(sh_a, cam_a, mesh)
    res = render_sharded(sh_a, cam_a, bg, RasterConfig(max_instances=budget),
                         mesh)
    out["scale.budget"] = np.array([budget // world, int(res["num_slots"])])
    out["scale.counts"] = np.array(scale.rank_counts(world, 64))
    models = [str(m) for m in inp["sweep.models"]]
    eval_sweep.main(["-m", *models, "--skip_render", "--device", "cpu",
                     "--out", str(inp["sweep.out"])])
    assert dist.is_initialized()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
