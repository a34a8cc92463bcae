"""A run with the timed path broken underneath must come out not
correct. Each cell runs at a tiny size on the CPU (the harness's look
for a card skipped, the port's kernels replaced by their plain
versions), once sound and once with each fault the cell can have: a
step that returns its state unchanged, half of the batch left out of
the loss (the mean over the rest), a frame altered where it is made."""

import contextlib

import pytest
import torch

import portbench.run as run

TINY = {"scene": {"n_gaussians": 3000}, "views": {"width": 64, "height": 48}}
DISTILL = {"profile_after": 2, "profile_steps": 2, "span_steps": 1}
QUERY = {"profile_after": 2, "profile_frames": 2, "compared_frames": 3,
         "path": {"period": 12, "radius": 4.5, "elev": -15.0,
                  "elev_amp": 10.0, "width": 64, "height": 48}}
SEED = 2_718_281_829


def tiny(cell, params):
    return run.run_cell(cell, SEED, 1.5, False, device="cpu",
                        overrides={"config": TINY,
                                   "workload": {"params": params}})


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def no_update(self, closure=None):
    return None


def half_batch_loss(loss_fn):
    def loss(decoder, lut, sem, gt, anneal_t):
        half = sem.shape[0] // 2
        return loss_fn(decoder, lut, sem[:half], gt[:half], anneal_t)
    return loss


def altered_frame(frame_fn):
    def frame(*a, **kw):
        img = frame_fn(*a, **kw)
        band = img.shape[0] // 8
        img = img.clone()
        img[:band] = 255 - img[:band]
        return img
    return frame


def worst(res):
    return max(v["value"] / v["limit"] for v in res["checks"].values())


@pytest.fixture(scope="module")
def sound_distill():
    return tiny("scannet-1m.distill", DISTILL)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_distill_fault_is_not_correct(fault, sound_distill):
    import goi_tpu_torch.train.distill as distill
    if fault == "state_unchanged":
        ctx = patched(torch.optim.Adam, "step", no_update)
    else:
        ctx = patched(distill, "distillation_loss",
                      half_batch_loss(distill.distillation_loss))
    with ctx:
        res = tiny("scannet-1m.distill", DISTILL)
    assert res["correct"] is False
    assert worst(res) > 10 * worst(sound_distill)


def test_query_altered_frame_is_not_correct():
    import goi_tpu_torch.app.session as session
    sound = tiny("scannet-1m.query", QUERY)
    with patched(session, "_frame", altered_frame(session._frame)):
        res = tiny("scannet-1m.query", QUERY)
    assert res["correct"] is False
    assert worst(res) > 10 * worst(sound)


def dp_run(fault):
    """Rank 0's result of a tiny four-process (gloo) run of the
    data-parallel cell."""
    import sys
    import tempfile
    from pathlib import Path

    from goi_tpu_torch.dist.multihost import spawn, wait_all
    worker = Path(__file__).with_name("dp_worker.py")
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(Path(tmp) / f"rank{r}.log", "w+") for r in range(4)]
        procs = spawn([sys.executable, str(worker), fault, str(SEED)], 4,
                      stdout=logs)
        codes = wait_all(procs, timeout=600)
        logs[0].seek(0)
        last = logs[0].read().splitlines()[-1]
        for f in logs:
            f.close()
    assert codes == [0, 0, 0, 0], codes
    import json
    return json.loads(last)


def test_dp_exchange_left_out_is_not_correct():
    sound, broken = dp_run("none"), dp_run("no_exchange")
    assert sound["checks"]["rank_spread"]["value"] == 0.0
    assert broken["correct"] is False
    assert broken["checks"]["rank_spread"]["value"] > 0.0
    for k in ("loss1_gap", "grad1_gap", "change_gap"):
        assert broken["checks"][k]["value"] > 10 * sound["checks"][k]["value"]
