"""The port's entry points (python -m goi_tpu_torch.{train,render,
metrics,eval_seg}) on the CPU, mirroring tests/test_cli_workflows.py on
its 64x48 synthetic COLMAP scene: the train -> render -> metrics chain
writes the root CLIs' artifact set and a triplet goi_tpu loads; on one
goi_tpu-trained model directory the port's render PNGs match the root
render.py's within 1 LSB and its metrics the root metrics.py's within
1e-4; eval_seg's numbers equal the root CLI's on the same masks."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from tests.test_data_io import _make_colmap_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _artifacts(model):
    return sorted(os.path.relpath(os.path.join(d, f), model)
                  for d, _, fs in os.walk(model) for f in fs
                  if not f.startswith("events.out.tfevents"))


def test_port_train_render_metrics_chain(tmp_path, capsys):
    from goi_tpu_torch.configs.params import ModelParams
    from goi_tpu_torch.data.scene import Scene
    from goi_tpu_torch.metrics import evaluate
    from goi_tpu_torch.render import main as render_main
    from goi_tpu_torch.train.__main__ import main as train_main

    root = str(tmp_path / "scene")
    model = str(tmp_path / "model")
    _make_colmap_scene(root)
    # distillation starts from a pre-trained 3DGS at iteration 1
    Scene(ModelParams(source_path=root, model_path=model, eval=True),
          device="cpu").save(1)
    train_main(["-s", root, "-m", model, "--iterations", "12",
                "--ape_dim", "8", "--tab_len", "8", "--eval",
                "--test_iterations", "12", "--save_iterations", "12",
                "--quiet"] + CPU)
    out = capsys.readouterr().out
    assert "Evaluating test: PSNR" in out
    assert "[goi_tpu_torch.train] " in out
    render_main(["-m", model, "--iteration", "12"] + CPU)
    res = evaluate([model], device="cpu")[model]
    vals = res["ours_12"]
    assert np.isfinite(vals["PSNR"]) and 0.0 <= vals["SSIM"] <= 1.0
    assert vals["LPIPS"] is None or vals["LPIPS"] >= 0
    assert _artifacts(model) == [
        "cameras.json", "cfg_args.json", "per_view.json",
        "point_cloud/iteration_1/point_cloud.ply",
        "point_cloud/iteration_12/LUT.npy",
        "point_cloud/iteration_12/point_cloud.ply",
        "point_cloud/iteration_12/semantic_MLP.pt", "results.json",
        "test/ours_12/gt/00000.png", "test/ours_12/renders/00000.png"] + [
        f"train/ours_12/{d}/{i:05d}.png" for d in ("gt", "renders")
        for i in range(3)]
    with open(os.path.join(model, "per_view.json")) as f:
        assert list(json.load(f)["ours_12"]["PSNR"]) == ["00000.png"]
    # the tensorboard run directory, where tensorboard imports
    events = [f for f in os.listdir(model) if f.startswith("events.out")]
    try:
        import torch.utils.tensorboard  # noqa: F401
    except ImportError:
        assert not events
    else:
        assert len(events) == 1

    # the triplet loads in goi_tpu
    from goi_tpu.data.scene import Scene as JScene
    from goi_tpu.configs.params import load_saved_params
    from goi_tpu.configs.params import ModelParams as JParams
    jmp = load_saved_params(model, JParams)
    assert jmp.model_path == model and jmp.tab_len == 8
    js = JScene(jmp, load_iteration=-1)
    assert js.loaded_iter == 12 and int(js.gaussians.num_valid) == 13
    dec, lut = JScene.load_semantics(
        os.path.join(model, "point_cloud", "iteration_12"))
    assert lut.shape == (8, 8)
    assert dec(np.zeros((2, 10), np.float32)).shape == (2, 8)


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """A model directory trained by the root train.py (goi_tpu)."""
    tmp = tmp_path_factory.mktemp("jax_model")
    root, model = str(tmp / "scene"), str(tmp / "model")
    _make_colmap_scene(root)
    from goi_tpu.configs.params import ModelParams
    from goi_tpu.data.scene import Scene
    Scene(ModelParams(source_path=root, model_path=model, eval=True)).save(1)
    import train as train_cli
    train_cli.main(["-s", root, "-m", model, "--iterations", "3",
                    "--ape_dim", "8", "--tab_len", "8", "--eval",
                    "--test_iterations", "3", "--save_iterations", "3"])
    return model


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.int16)


def test_port_render_and_metrics_match_root_clis(jax_model, tmp_path):
    import metrics as metrics_cli
    import render as render_cli
    from goi_tpu_torch.metrics import evaluate
    from goi_tpu_torch.render import main as render_main

    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    shutil.copytree(jax_model, ours)
    shutil.copytree(jax_model, theirs)
    render_main(["-m", ours, "--iteration", "3"] + CPU)
    render_cli.main(["-m", theirs, "--iteration", "3"])
    names = [os.path.relpath(os.path.join(d, f), theirs)
             for d, _, fs in os.walk(theirs) for f in fs
             if f.endswith(".png")]
    assert len(names) == 8
    for n in names:
        a, b = _pixels(os.path.join(ours, n)), _pixels(os.path.join(theirs, n))
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, n
    evaluate([theirs], device="cpu")
    with open(os.path.join(theirs, "results.json")) as f:
        got = json.load(f)
    metrics_cli.evaluate([theirs])
    with open(os.path.join(theirs, "results.json")) as f:
        want = json.load(f)
    assert got.keys() == want.keys() == {"ours_3"}
    for k in ("PSNR", "SSIM"):
        np.testing.assert_allclose(got["ours_3"][k], want["ours_3"][k],
                                   rtol=1e-4, err_msg=k)
    assert got["ours_3"]["LPIPS"] == want["ours_3"]["LPIPS"]


def _masks(tmp_path):
    """m360 mask folders: per prompt, GT boxes and predicted boxes (one
    view predicted at half resolution: resized to the GT's by both)."""
    eval_root, saving_root = tmp_path / "gt", tmp_path / "pred"
    rng = np.random.default_rng(0)
    for prompt in ("chair", "table", "lamp"):
        mdir = eval_root / "room" / prompt / "masks"
        pdir = saving_root / "room" / prompt
        mdir.mkdir(parents=True)
        pdir.mkdir(parents=True)
        for view in ("v0", "v1"):
            gt = np.zeros((32, 48), np.uint8)
            x0, y0 = rng.integers(0, 20, 2)
            gt[y0:y0 + 12, x0:x0 + 20] = 255
            size = (16, 24) if view == "v1" else (32, 48)
            pred = (rng.uniform(0, 1, size) > 0.7).astype(np.uint8) * 255
            Image.fromarray(gt).save(mdir / f"{view}.png")
            Image.fromarray(pred).save(pdir / f"{view}.png")
    return str(eval_root), str(saving_root)


def test_port_eval_seg_equals_root_cli(tmp_path):
    import eval_seg as eval_cli
    from goi_tpu_torch.eval_seg import main

    e, s = _masks(tmp_path)
    args = ["-e", e, "-s", s, "--scene_list", "room", "-d", "m360"]
    got = main(args + CPU)
    want = eval_cli.main(args)
    np.testing.assert_array_equal(got, want)


def test_port_eval_seg_replica_equals_root_cli(tmp_path):
    """The Replica top-7 protocol: per-view label maps and a
    top_list.json of (class_name, id) entries."""
    import eval_seg as eval_cli
    from goi_tpu_torch.eval_seg import main

    rng = np.random.default_rng(1)
    sem = tmp_path / "data" / "office0" / "test" / "sem"
    sem.mkdir(parents=True)
    top = {}
    for view in ("frame_000", "frame_001"):
        lab = rng.integers(0, 4, (24, 32)).astype(np.uint8)
        Image.fromarray(lab).save(sem / f"{view}.png")
        top[f"{view}.png"] = [{"class_name": c, "id": i}
                              for i, c in ((1, "sofa"), (3, "rug"))]
        for c, i in (("sofa", 1), ("rug", 3)):
            pdir = tmp_path / "pred" / "office0" / c
            pdir.mkdir(parents=True, exist_ok=True)
            pred = ((lab == i) ^ (rng.uniform(0, 1, lab.shape) > 0.9))
            Image.fromarray(pred.astype(np.uint8) * 255).save(
                pdir / f"rgb_{view.split('_')[1]}.png")
    with open(tmp_path / "data" / "office0" / "test" / "top_list.json",
              "w") as f:
        json.dump(top, f)
    args = ["-e", str(tmp_path / "data"), "-s", str(tmp_path / "pred"),
            "--scene_list", "office0", "-d", "replica"]
    np.testing.assert_array_equal(main(args + CPU), eval_cli.main(args))


def test_entry_points_run_as_modules(tmp_path):
    """python -m runs each entry point; asked for a card where there is
    none, an entry point stops instead of running on the CPU."""
    e, s = _masks(tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "goi_tpu_torch.eval_seg", "-e", e, "-s", s,
         "--scene_list", "room"] + CPU, cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line, = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("[goi_tpu_torch.eval_seg] ")]
    summary = json.loads(line.split("] ", 1)[1])
    assert 0.0 <= summary["miou"] <= 1.0 and summary["device"] == "cpu"
    for name in ("train", "render", "metrics"):
        proc = subprocess.run(
            [sys.executable, "-m", f"goi_tpu_torch.{name}", "--help"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0 and "--device" in proc.stdout, name
    import torch
    if not torch.cuda.is_available():
        from goi_tpu_torch.eval_seg import main
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(["-e", e, "-s", s, "--device", "cuda"])


def test_logging_and_profiling_utils(tmp_path, monkeypatch):
    """pca_visualize against goi_tpu's; the TensorBoard logger writes a
    run directory, or does nothing where tensorboard does not import;
    the step timer and the profiler trace on the CPU."""
    from goi_tpu.utils.logging import pca_visualize as j_pca
    from goi_tpu_torch.utils import logging as tlog
    from goi_tpu_torch.utils.profiling import StepTimer, trace

    feats = np.random.default_rng(0).normal(0, 1, (6, 12, 10)).astype(
        np.float32)
    got = tlog.pca_visualize(feats)
    assert got.shape == (12, 10, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, j_pca(feats), atol=1e-6)

    tb = tlog.TensorBoardLogger(str(tmp_path / "tb"))
    tb.scalar("a", 1.5, 1)
    tb.histogram("h", np.arange(5.0), 1)
    tb.image("i", np.zeros((3, 4, 4), np.float32), 1)
    tb.close()
    try:
        import torch.utils.tensorboard  # noqa: F401
    except ImportError:
        assert tb.writer is None
    else:
        assert os.listdir(tmp_path / "tb")
    import builtins
    real_import = builtins.__import__

    def no_tensorboard(name, *a, **k):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    off = tlog.TensorBoardLogger(str(tmp_path / "off"))
    off.scalar("a", 1.0, 1)
    off.close()
    assert off.writer is None and not (tmp_path / "off").exists()
    monkeypatch.undo()

    timer = StepTimer()
    for _ in range(3):
        with timer:
            sum(range(1000))
    assert timer.ms > 0 and timer.fps > 0
    with trace(str(tmp_path / "prof")):
        import torch
        torch.ones(8).sum()
    assert os.listdir(tmp_path / "prof")
