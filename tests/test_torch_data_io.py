"""The port's config, readers, dataset loaders, kNN and Scene against
goi_tpu's, on the synthetic files of tests/test_data_io.py and
tests/test_readers_shard_gaps.py: CameraInfo fields and points equal,
camera matrices within 1e-6, Scene creation (points, colours, kNN
scales) within 1e-5 relative, checkpoints and cfg_args.json loading
across packages, and mean_knn_dist2 within 1e-5 of the peak."""

import dataclasses
import json
import os
from argparse import ArgumentParser

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.configs import params as jparams
from goi_tpu.data import dataset as jdataset
from goi_tpu.data import readers as jreaders
from goi_tpu.data.colmap import read_model as j_read_model
from goi_tpu.data.scene import Scene as JScene
from goi_tpu.knn.knn import mean_knn_dist2 as j_knn
from goi_tpu_torch.configs import params as tparams
from goi_tpu_torch.data import dataset as tdataset
from goi_tpu_torch.data import readers as treaders
from goi_tpu_torch.data.colmap import read_model as t_read_model
from goi_tpu_torch.data.scene import Scene as TScene
from goi_tpu_torch.knn.knn import mean_knn_dist2 as t_knn
from tests.test_data_io import _make_colmap_scene
from tests.test_readers_shard_gaps import _write_scannet

torch.set_num_threads(1)

SCALE_RTOL = 1e-5


def _same_infos(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for f in dataclasses.fields(x):
            vx, vy = getattr(x, f.name), getattr(y, f.name)
            if isinstance(vx, np.ndarray):
                assert np.array_equal(vx, vy), f.name
            else:
                assert vx == vy, f.name


def _same_scene_info(js, ts):
    _same_infos(js.train_cameras, ts.train_cameras)
    if js.test_cameras:
        _same_infos(js.test_cameras, ts.test_cameras)
    assert ts.ply_path == js.ply_path
    assert ts.nerf_normalization["radius"] == js.nerf_normalization["radius"]
    np.testing.assert_array_equal(ts.nerf_normalization["translate"],
                                  js.nerf_normalization["translate"])
    for k in ("points", "colors"):
        np.testing.assert_array_equal(ts.point_cloud[k], js.point_cloud[k])


def _same_cameras(jinfos, tinfos, resolution=-1):
    jc = jdataset.build_cameras(jinfos, resolution)
    tc = tdataset.build_cameras(tinfos, resolution, device="cpu")
    for a, b in zip(jc, tc):
        assert (a.width, a.height) == (b.width, b.height)
        for k in ("world_view", "full_proj", "camera_center", "tan_fovx",
                  "tan_fovy"):
            np.testing.assert_allclose(getattr(b, k).numpy(),
                                       np.asarray(getattr(a, k)), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("eval_split", [False, True])
def test_colmap_binary_reader_matches_goi_tpu(tmp_path, eval_split):
    root = str(tmp_path / "scene")
    _make_colmap_scene(root)
    js = jreaders.load_scene_info(root, eval_split=eval_split)
    ts = treaders.load_scene_info(root, eval_split=eval_split)
    assert len(ts.test_cameras) == (1 if eval_split else 0)
    _same_scene_info(js, ts)
    _same_cameras(js.train_cameras, ts.train_cameras)
    # the points3D.ply cache written by one package is read by the other
    assert os.path.exists(ts.ply_path)


def test_colmap_text_reader_matches_goi_tpu(tmp_path):
    sparse = str(tmp_path / "sparse0")
    os.makedirs(sparse)
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# comment\n1 SIMPLE_PINHOLE 64 48 60.0 32 24\n"
                "2 PINHOLE 64 48 61.0 59.0 32 24\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        # an image with no 2D points has an empty points line
        f.write("# c\n1 0.9 0.1 0.2 0.3 0.5 0 2 1 a.png\n1.0 2.0 5 3 4 -1\n"
                "2 1 0 0 0 0 0 1 2 b.png\n\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        f.write("1 0.1 0.2 0.3 10 20 30 0.5 1 0\n"
                "2 -1 2 -3 1 2 3 0.25 1 0 2 1\n")
    (jc, ji, jp), (tc, ti, tp) = j_read_model(sparse), t_read_model(sparse)
    assert jc.keys() == tc.keys() and ji.keys() == ti.keys()
    for k in jc:
        assert jc[k][:4] == tc[k][:4]
        np.testing.assert_array_equal(jc[k].params, tc[k].params)
    for k in ji:
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(ji[k], f),
                                          getattr(ti[k], f))
        assert (ji[k].name, ji[k].camera_id) == (ti[k].name, ti[k].camera_id)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a, b)


def test_quaternions_round_trip_as_goi_tpu():
    from goi_tpu.data.colmap import qvec2rotmat as jq2r
    from goi_tpu.data.colmap import rotmat2qvec as jr2q
    from goi_tpu_torch.data.colmap import qvec2rotmat, rotmat2qvec
    q = np.random.default_rng(0).normal(0, 1, 4)
    q /= np.linalg.norm(q)
    np.testing.assert_array_equal(qvec2rotmat(q), jq2r(q))
    np.testing.assert_array_equal(rotmat2qvec(qvec2rotmat(q)),
                                  jr2q(jq2r(q)))
    np.testing.assert_allclose(np.abs(rotmat2qvec(qvec2rotmat(q))),
                               np.abs(q), atol=1e-12)


def _make_blender(root):
    from PIL import Image
    os.makedirs(os.path.join(root, "train"))
    os.makedirs(os.path.join(root, "test"))
    for split, n in (("train", 3), ("test", 2)):
        frames = []
        for i in range(n):
            Image.new("RGBA", (32, 24), (50, 100, 150, 255)).save(
                os.path.join(root, f"{split}/r_{i}.png"))
            c2w = np.eye(4)
            c2w[2, 3] = 3.0 + i * 0.1
            c2w[0, 3] = 0.2 * i
            frames.append({"file_path": f"{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.7, "frames": frames}, f)


@pytest.mark.parametrize("eval_split", [False, True])
def test_blender_reader_matches_goi_tpu(tmp_path, eval_split):
    root = str(tmp_path / "blender")
    _make_blender(root)
    # the first reader writes the random points3d.ply; both read it
    js = jreaders.load_scene_info(root, eval_split=eval_split,
                                  load_sem=False)
    ts = treaders.load_scene_info(root, eval_split=eval_split,
                                  load_sem=False)
    assert len(ts.train_cameras) == (3 if eval_split else 5)
    _same_scene_info(js, ts)
    _same_cameras(js.train_cameras, ts.train_cameras)


def test_scannet_reader_matches_goi_tpu(tmp_path):
    root, w, h, fx = _write_scannet(tmp_path)
    for kw in ({}, {"eval_split": True, "llffhold": 2}):
        js = jreaders.read_scannet_scene(root, **kw)
        ts = treaders.read_scannet_scene(root, **kw)
        _same_scene_info(js, ts)
        _same_cameras(js.train_cameras, ts.train_cameras)
    ts = treaders.load_scene_info(root)        # the dispatch to ScanNet
    assert [c.uid for c in ts.train_cameras] == [0, 24, 32, 8]


def test_dataset_loaders_match_goi_tpu(tmp_path):
    root = str(tmp_path / "scene")
    _make_colmap_scene(root)
    info = treaders.load_scene_info(root)
    for res in (1, 2, -1):
        np.testing.assert_array_equal(
            tdataset.load_image(info.train_cameras[0], res),
            jdataset.load_image(info.train_cameras[0], res))
    assert tdataset.resolve_resolution(3200, 1800) == \
        jdataset.resolve_resolution(3200, 1800) == (1600, 900)
    fm = np.random.default_rng(0).normal(0, 1, (4, 6, 8)).astype(np.float32)
    torch.save(torch.as_tensor(fm).half(), str(tmp_path / "a.pt"))
    np.save(str(tmp_path / "b.npy"), fm)
    for p in ("a.pt", "b.npy", "b.pt"):    # b.pt falls back to b.npy
        got = tdataset.load_feature_map(str(tmp_path / p))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            got, jdataset.load_feature_map(str(tmp_path / p)))
    assert tdataset.load_feature_map(str(tmp_path / "none.pt")) is None
    assert tdataset.load_feature_map(None) is None


def test_scene_from_points_matches_goi_tpu_and_loads_across(tmp_path):
    root = str(tmp_path / "scene")
    _make_colmap_scene(root)
    jmp = jparams.ModelParams(source_path=root, eval=True,
                              model_path=str(tmp_path / "jmodel"))
    tmp = tparams.ModelParams(source_path=root, eval=True,
                              model_path=str(tmp_path / "tmodel"))
    js, ts = JScene(jmp), TScene(tmp, device="cpu")
    assert int(ts.gaussians.num_valid) == int(js.gaussians.num_valid) == 13
    assert ts.cameras_extent == js.cameras_extent
    np.testing.assert_array_equal(ts.gaussians.xyz.numpy(),
                                  np.asarray(js.gaussians.xyz))
    np.testing.assert_allclose(ts.gaussians.features_dc.numpy(),
                               np.asarray(js.gaussians.features_dc),
                               rtol=1e-6)
    np.testing.assert_allclose(ts.gaussians.get_scaling().numpy(),
                               np.asarray(js.gaussians.get_scaling()),
                               rtol=SCALE_RTOL)
    with open(os.path.join(tmp.model_path, "cameras.json")) as f:
        tcams = json.load(f)
    with open(os.path.join(jmp.model_path, "cameras.json")) as f:
        assert tcams == json.load(f)

    # the port's checkpoint loads in goi_tpu at -1 (the latest), and
    # goi_tpu's in the port
    ts.save(3)
    ts.save(7)
    back = JScene(dataclasses.replace(jmp, model_path=tmp.model_path),
                  load_iteration=-1)
    assert back.loaded_iter == 7
    np.testing.assert_array_equal(np.asarray(back.gaussians.xyz),
                                  ts.gaussians.xyz.numpy())
    js.save(5)
    fwd = TScene(dataclasses.replace(tmp, model_path=jmp.model_path),
                 load_iteration=-1, device="cpu")
    assert fwd.loaded_iter == 5
    np.testing.assert_array_equal(fwd.gaussians.scaling.numpy(),
                                  np.asarray(js.gaussians.scaling))


def test_cfg_args_round_trip_across_packages(tmp_path):
    for mod in (tparams, jparams):
        parser = ArgumentParser()
        mod.add_params(parser, mod.ModelParams, "model")
        mod.add_params(parser, mod.PipelineParams, "pipe")
        args = parser.parse_args(["-s", "/data/x", "--sh_degree", "2",
                                  "--white_background", "-r", "4",
                                  "--debug"])
        mp = mod.extract_params(args, mod.ModelParams)
        pp = mod.extract_params(args, mod.PipelineParams)
        assert (mp.source_path, mp.sh_degree, mp.white_background,
                mp.resolution, pp.debug) == ("/data/x", 2, True, 4, True)
        d = str(tmp_path / mod.__name__)
        mod.save_params(d, mp, pp)
        other = jparams if mod is tparams else tparams
        assert dataclasses.asdict(other.load_saved_params(
            d, other.ModelParams)) == dataclasses.asdict(mp)
        assert dataclasses.asdict(other.load_saved_params(
            d, other.PipelineParams)) == dataclasses.asdict(pp)
    assert tparams.load_saved_params(str(tmp_path / "none"),
                                     tparams.ModelParams) == \
        tparams.ModelParams()


def test_optim_config_has_goi_tpu_fields_and_flags():
    from goi_tpu.train.optim import OptimConfig as JOptim
    from goi_tpu_torch.train.optim import OptimConfig
    assert [(f.name, f.default) for f in dataclasses.fields(OptimConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(JOptim)]
    parser = ArgumentParser()
    tparams.add_params(parser, OptimConfig, "opt")
    cfg = tparams.extract_params(parser.parse_args(
        ["--iterations", "12", "--densify_grad_threshold", "0.001"]),
        OptimConfig)
    assert (cfg.iterations, cfg.densify_grad_threshold) == (12, 0.001)


@pytest.mark.parametrize("n", [300, 6000])
def test_mean_knn_dist2_matches_goi_tpu(n):
    """Brute force at n <= 4096, the Morton-window passes above; the
    self-inclusive 3-NN (a zero among the three)."""
    pts = np.random.default_rng(n).normal(0, 1, (n, 3)).astype(np.float32)
    got = t_knn(torch.as_tensor(pts)).numpy()
    want = np.asarray(j_knn(jnp.asarray(pts)))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if n <= 4096:
        d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
        two = np.sort(d2, axis=1)[:, 1:3].sum(1) / 3
        np.testing.assert_allclose(got, two, rtol=1e-4, atol=1e-7)
