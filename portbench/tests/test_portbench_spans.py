"""The readers of the port's own spans and counters (portbench/spanread.py
and the metrics that use it), on the CPU: a traced tiny run of the
distillation and viewer cells gives every one of them a finite value,
over as many units as the cell profiles; an untraced run leaves the
registry empty and every reader None; a program without the registry
gives None, not an error."""

import json
import math
import time
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

import portbench.run as run
from portbench import spanread

ROOT = Path(__file__).resolve().parents[2]
TINY = {"scene": {"n_gaussians": 3000}, "views": {"width": 64, "height": 48}}
DISTILL = {"profile_after": 2, "profile_steps": 2, "span_steps": 1}
QUERY = {"profile_after": 2, "profile_frames": 3, "compared_frames": 3,
         "path": {"period": 12, "radius": 4.5, "elev": -15.0,
                  "elev_amp": 10.0, "width": 64, "height": 48}}
SEED = 3_141_592_653
CELLS = {"scannet-1m.distill": (DISTILL, "distill.step", "profile_steps"),
         "m360-garden.distill": (DISTILL, "distill.step", "profile_steps"),
         "scannet-1m.query": (QUERY, "query.frame", "profile_frames")}


def span_metrics(cell):
    """The metrics of `cell` whose readers read the port's registry."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [])
            and "spanread" in (ROOT / "portbench" / "metrics"
                               / f"{m['name']}.py").read_text()]


def tiny(cell, trace):
    from goi_tpu_torch.utils import profiling
    profiling.reset()
    params = CELLS[cell][0]
    return run.run_cell(cell, SEED, 1.0, trace, device="cpu",
                        overrides={"config": TINY,
                                   "workload": {"params": params}})


def test_every_cell_has_its_span_metrics():
    assert {c: len(span_metrics(c)) for c in CELLS} == {
        "scannet-1m.distill": 9, "m360-garden.distill": 9,
        "scannet-1m.query": 4}
    assert len(span_metrics("m360-garden.distill-dp4")) == 2


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_run_reads_every_span_metric(cell):
    from goi_tpu_torch.utils import profiling
    res = tiny(cell, True)
    params, unit, key = CELLS[cell]
    snap = profiling.snapshot()
    assert snap["units"] == {unit: params[key]}
    for name in span_metrics(cell):
        assert name in res["metrics"], name
        assert math.isfinite(res["metrics"][name]["value"]), name
    m = res["metrics"]
    if unit == "distill.step":
        pre = "m360-garden." if cell.startswith("m360") else ""
        assert m[f"{pre}distill.step.preprocess_ms"]["value"] \
            + m[f"{pre}distill.step.binning_ms"]["value"] \
            <= m[f"{pre}distill.step.render_ms"]["value"]
        assert m[f"{pre}distill.step.reduce_ms"]["value"] \
            <= m[f"{pre}distill.step.render_bwd_ms"]["value"]
        assert 0 < m[f"{pre}distill.step.binning_kept_share"]["value"] <= 100
    else:
        assert 0 < m["query.frame.blend_useful_share"]["value"] <= 100


@pytest.mark.parametrize("cell", ["scannet-1m.distill", "scannet-1m.query"])
def test_untraced_run_leaves_the_registry_empty(cell):
    from goi_tpu_torch.utils import profiling
    res = tiny(cell, False)
    assert profiling.snapshot() == {"units": {}, "spans": {},
                                    "counters": {}}
    readings = {"steps": 1, "frames": 1}
    for name in span_metrics(cell):
        assert run.reader(name).read(readings) is None, name
    assert res["correct"] in (True, False)


def test_dp4_readers_divide_by_the_steps():
    """The four-card readers over two synthetic dist.step units."""
    from goi_tpu_torch.utils import profiling
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.span("dist.step"):
                with profiling.span("dist.mean_over_data"):
                    time.sleep(0.002)
                    with profiling.span("dist.allreduce"):
                        time.sleep(0.001)
    snap = profiling.snapshot()["spans"]
    r = {"chips": 4}
    assert run.reader("dp4.step.allreduce_ms").read(r) == pytest.approx(
        snap["dist.allreduce"]["device_ms"] / 2)
    grad = run.reader("dp4.step.grad_copy_ms").read(r)
    assert grad == pytest.approx(
        snap["dist.mean_over_data"]["self_device_ms"] / 2)
    assert grad >= 2.0
    # a reading of another cell's units gives nothing
    assert run.reader("distill.step.render_ms").read(r) is None
    profiling.reset()


def test_a_program_without_the_registry_reads_none(monkeypatch):
    from goi_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "snapshot")
    for name in span_metrics("scannet-1m.distill") + span_metrics(
            "scannet-1m.query"):
        assert run.reader(name).read({"steps": 1}) is None, name
    assert spanread.snapshot({}) is None
