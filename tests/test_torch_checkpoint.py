"""The port's checkpoints (goi_tpu_torch/train/checkpoint.py), as
tests/test_checkpoint.py holds goi_tpu's: a DistillState and an
RGBTrainState round-trip with bit-equal tensors (scene, decoder, LUT,
Adam moments and step counts, densify stats, the xyz schedule) through
torch.load(weights_only=True), and the next step from the restored
state equals the next step from the original."""

import numpy as np
import pytest
import torch

from goi_tpu_torch.raster.render import RasterConfig
from goi_tpu_torch.semantic.codebook import SemanticDecoder
from goi_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from goi_tpu_torch.train.distill import DistillState, create_distill_state
from goi_tpu_torch.train.optim import ExponLR, OptimConfig
from goi_tpu_torch.train.rgb import RGBTrainState, create_rgb_trainer
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene

torch.set_num_threads(1)

CFG = RasterConfig(max_instances=1 << 12)


def _assert_opt_equal(a, b):
    if a is None:
        assert b is None
        return
    assert len(a.param_groups) == len(b.param_groups)
    for ga, gb in zip(a.param_groups, b.param_groups):
        assert {k: v for k, v in ga.items() if k != "params"} == \
            {k: v for k, v in gb.items() if k != "params"}
        for pa, pb in zip(ga["params"], gb["params"]):
            assert torch.equal(pa, pb) and pb.requires_grad
            sa, sb = a.state[pa], b.state[pb]
            assert sorted(sa) == sorted(sb)
            for k in sa:
                assert torch.equal(sa[k], sb[k]), k


def _assert_scene_equal(a, b):
    for k in a.PARAM_FIELDS + ("valid",):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert (a.active_sh_degree, a.max_sh_degree) == \
        (b.active_sh_degree, b.max_sh_degree)


def test_distill_state_roundtrip(tmp_path):
    scene = to_torch_scene(make_random_scene(n=80, seed=0))
    gen = torch.Generator().manual_seed(0)
    decoder = SemanticDecoder.create(gen, dim_in=10, dim_out=8,
                                     device="cpu")
    lut = torch.randn((8, 16), generator=gen) * 0.1
    # position finetune too, so a scheduled group goes through the file
    state, train_step = create_distill_state(
        scene, decoder, lut, OptimConfig(position_finetune=True))
    cam = to_torch_camera(make_test_camera(width=32, height=32))
    gt = torch.randn((16, 32, 32), generator=gen)
    bg = torch.zeros(3)
    for _ in range(3):
        state, _ = train_step(state, cam, gt, bg, CFG)

    path = save_checkpoint(str(tmp_path / "ckpt.pt"), state)
    torch.load(path, weights_only=True)
    restored = load_checkpoint(path, device="cpu")
    assert isinstance(restored, DistillState)
    assert restored.step == state.step == 3
    _assert_scene_equal(state.scene, restored.scene)
    for a, b in zip(list(state.decoder.parameters()) + [state.lut],
                    list(restored.decoder.parameters()) + [restored.lut]):
        assert torch.equal(a, b) and b.requires_grad
    assert restored.decoder.norm_output == state.decoder.norm_output
    for name in ("opt_scene", "opt_decoder", "opt_lut"):
        _assert_opt_equal(getattr(state, name), getattr(restored, name))
    sched = restored.opt_scene.param_groups[0]["schedule"]
    assert isinstance(sched, ExponLR)
    assert sched == state.opt_scene.param_groups[0]["schedule"]
    assert not restored.scene.opacity.requires_grad

    # training resumes identically from the restored state
    s1, aux1 = train_step(state, cam, gt, bg, CFG)
    s2, aux2 = train_step(restored, cam, gt, bg, CFG)
    assert float(aux1["total"]) == float(aux2["total"])
    _assert_scene_equal(s1.scene, s2.scene)
    assert torch.equal(s1.lut, s2.lut)


@pytest.mark.parametrize("densified", [False, True])
def test_rgb_state_roundtrip(tmp_path, densified):
    target = to_torch_scene(make_random_scene(n=100, seed=2))
    cam = to_torch_camera(make_test_camera(width=32, height=32))
    bg = torch.zeros(3)
    from goi_tpu_torch.raster.render import render
    with torch.no_grad():
        gt = render(target, cam, bg, CFG)["render"]
    init_fn, step_fn, densify_fn = create_rgb_trainer(
        OptimConfig(position_lr_max_steps=50), CFG)
    state = init_fn(to_torch_scene(make_random_scene(n=90, seed=3,
                                                     capacity=140)))
    for _ in range(3):
        state, _ = step_fn(state, cam, gt, bg)
    if densified:
        state, info = densify_fn(state, torch.Generator().manual_seed(0),
                                 extent=1.0)
        assert int(info["n_clone"]) + int(info["n_split"]) > 0
        state, _ = step_fn(state, cam, gt, bg)
    assert state.stats.denom.any()

    path = save_checkpoint(str(tmp_path / "rgb.pt"), state)
    restored = load_checkpoint(path, device="cpu")
    assert isinstance(restored, RGBTrainState)
    assert restored.step == state.step
    _assert_scene_equal(state.scene, restored.scene)
    _assert_opt_equal(state.opt, restored.opt)
    for k in ("xyz_grad_accum", "denom", "max_radii"):
        assert torch.equal(getattr(state.stats, k),
                           getattr(restored.stats, k)), k

    s1, aux1 = step_fn(state, cam, gt, bg)
    s2, aux2 = step_fn(restored, cam, gt, bg)
    assert float(aux1["loss"]) == float(aux2["loss"])
    assert float(aux1["gnorm"]) == float(aux2["gnorm"])
    _assert_scene_equal(s1.scene, s2.scene)
    _assert_opt_equal(s1.opt, s2.opt)
    assert np.isfinite(float(aux2["loss"]))


def test_checkpoint_refuses_other_states(tmp_path):
    with pytest.raises(TypeError, match="no checkpoint format"):
        save_checkpoint(str(tmp_path / "x.pt"), object())
