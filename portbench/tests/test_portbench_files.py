"""Every file the harness finds by name: BENCHMARK.json, the
configurations, the cells and the metric readers, held to the rules the
harness relies on."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "goi_tpu"}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert all(line(w) for w in b["command"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_and_cells_exist():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        assert line(c["why"]) and line(c["source"])
    used = set()
    pairs = set()
    for w in b["workloads"]:
        f = json.loads((PB / "workloads" / f"{w['name']}.json").read_text())
        for k in ("config", "traffic", "chips", "why"):
            assert f[k] == w[k], (w["name"], k)
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert (PB / "drivers" / f"{f['driver']}.py").exists()
        assert w["chips"] in (1, 4) and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(configs)
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    b = bench()
    for w in b["workloads"]:
        def mine(m):
            return "workloads" not in m or w["name"] in m["workloads"]
        e2e = [m["name"] for m in b["end_to_end"] if mine(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(mine(m) for m in b["per_layer"])


def test_per_layer_readers_and_moves():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = [w["name"] for w in b["workloads"]]
    layers = {}
    for m in b["per_layer"]:
        path = PB / "metrics" / f"{m['name']}.py"
        src = path.read_text()
        tree = ast.parse(src)
        consts = {t.targets[0].id: t.value.value for t in tree.body
                  if isinstance(t, ast.Assign)
                  and isinstance(t.value, ast.Constant)}
        assert consts["LAYER"] == m["layer"] and consts["MOVES"] == \
            m["moves"] and consts["SOURCE"] == m["source"], m["name"]
        assert any(isinstance(t, ast.FunctionDef) and t.name == "read"
                   for t in tree.body)
        assert line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        # every cell of the metric reports the end-to-end metric it moves
        mv = e2e[m["moves"]]
        for c in m.get("workloads", cells):
            assert c in cells
            assert "workloads" not in mv or c in mv["workloads"]
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_and_no_program_in_the_reference(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    if "reference" in path.parts or "work" in path.parts:
        assert "goi_tpu_torch" not in tops, path


def test_forbidden_names_are_whole_top_level_names():
    import importlib.util
    spec = importlib.util.spec_from_file_location("pb_run", PB / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    tops = {m.split(".")[0] for m in ("goi_tpu_torch.raster", "jaxlib.x",
                                      "goi_tpu", "numpy")}
    assert sorted(tops & set(run.FORBIDDEN)) == ["goi_tpu", "jaxlib"]
