"""Each input generator gives the same inputs for one seed and others
for another, at the sizes of the configuration (scaled down)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.reference.distill import view_order

PB = Path(__file__).resolve().parents[1]
SEEDS = (3_000_000_019, 3_000_000_021)   # past 2**31, as the driver's are


def config(name="scannet-1m"):
    c = json.loads((PB / "configs" / f"{name}.json").read_text())
    c["scene"]["n_gaussians"] = 500
    c["views"].update(width=40, height=24)
    return c


def same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def reservoir(seed, n, k):
    r = inputs.Reservoir(seed, k)
    for i in range(n):
        r.offer(i, str(i))
    return r.items()


def draws(seed, name):
    c = config(name)
    q = json.loads((PB / "workloads" / "scannet-1m.query.json").read_text())
    views = inputs.training_views(c["views"], seed)
    maps, protos = inputs.feature_maps(c["maps"], views, seed, "cpu")
    spec = dict(q["params"]["query"], dim_in=10, tab_len=300)
    return {
        "scene": inputs.make_scene(c["scene"], seed, "cpu"),
        "views": views, "maps": maps,
        "path": inputs.orbit_path(q["params"]["path"], seed),
        "order": view_order(seed, len(views), 20, 1),
        "query": inputs.query_model(spec, protos, seed, "cpu"),
        "sample": inputs.sample_indices(seed, 200, 6),
        "reservoir": list(reservoir(seed, 200, 6)),
    }


@pytest.mark.parametrize("name", ["scannet-1m", "m360-garden"])
def test_one_seed_same_inputs_another_seed_others(name):
    a, b, c = draws(SEEDS[0], name), draws(SEEDS[0], name), \
        draws(SEEDS[1], name)
    for k in a:
        assert same(a[k], b[k]), k
        assert not same(a[k], c[k]), k


def test_prototypes_are_the_maps_first_draw():
    c = config()
    views = inputs.training_views(c["views"], SEEDS[0])
    _, protos = inputs.feature_maps(c["maps"], views, SEEDS[0], "cpu")
    assert torch.equal(protos, inputs.prototypes(c["maps"], SEEDS[0], "cpu"))


def test_sizes_do_not_depend_on_the_seed():
    a, c = draws(SEEDS[0], "scannet-1m"), draws(SEEDS[1], "scannet-1m")
    for k in ("xyz", "semantics", "features_rest"):
        assert a["scene"][k].shape == c["scene"][k].shape
    assert [m.shape for m in a["maps"]] == [m.shape for m in c["maps"]]
    assert len(a["path"]) == len(c["path"])
    assert sorted(a["order"][0] + a["order"][1]) != [] and \
        sorted(sum(a["order"][:8], [])) == list(range(8))
    assert a["sample"][-1] == c["sample"][-1] == 199
    assert len(a["reservoir"]) == len(c["reservoir"]) == 6
    assert a["reservoir"][-1] == c["reservoir"][-1] == 199


def test_reservoir_draws_every_answer_alike():
    """Over many seeds each of the first 49 answers is drawn about as
    often as any other (k - 1 = 5 of 49), and the last always."""
    hits = np.zeros(50)
    for seed in range(2000):
        got = reservoir(3_000_000_000 + seed, 50, 6)
        assert got == {i: str(i) for i in got}
        hits[list(got)] += 1
    assert hits[-1] == 2000
    share = hits[:-1] / 2000
    assert np.all(np.abs(share - 5 / 49) < 0.035), share
