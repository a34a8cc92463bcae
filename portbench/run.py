"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. The cell's file portbench/workloads/
<cell>.json names its configuration (portbench/configs/<config>.json),
its driver (portbench/drivers/<driver>.py), its traffic, its chips, the
limits of its correctness check and, under "metric_names", the names
it gives the driver's end-to-end numbers where they are its own. The
metrics it prints are those that BENCHMARK.json lists for it, the
per-layer ones each read by portbench/metrics/<metric>.py. The last line of standard output is one
JSON object: correct, attempted, failed, metrics, device, with --trace 1
also breakdown, and last the numbers compared with their limits, which
also end standard error. Without enough CUDA devices, without the
program, or with JAX loaded once the window has closed, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "goi_tpu")
RANK_TIMEOUT_S = 1150

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels into build/goi_tpu_torch itself)."""
    cache = ROOT / "build" / "portbench"
    for var, sub in (("CUDA_CACHE_PATH", "nv"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> tuple:
    """(workload, configuration) of the cell `name`."""
    wl = load_json(HERE / "workloads" / f"{name}.json")
    return wl, load_json(HERE / "configs" / f"{wl['config']}.json")


def cell_metrics(name: str, bench: dict) -> tuple:
    """(end-to-end, per-layer) metric entries of BENCHMARK.json that the
    cell reports."""
    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def reader(metric: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}",
        HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: dict = None,
             bench: dict = None) -> dict:
    """Run the cell and return its result (the JSON object that main
    prints). `overrides` replaces entries of the configuration and the
    workload ({"config": {...}, "workload": {...}}): the CPU tests run a
    cell at a tiny size through it."""
    wl, cfg = load_cell(name)
    for key, part in (overrides or {}).items():
        target = cfg if key == "config" else wl
        for k, v in part.items():
            target[k] = dict(target[k], **v) if isinstance(v, dict) \
                and isinstance(target.get(k), dict) else v
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    e2e, per_layer = cell_metrics(name, bench)
    driver_path = HERE / "drivers" / f"{wl['driver']}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_driver_{wl['driver']}", driver_path)
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    out = driver.run(cell=name, workload=wl, config=cfg, seed=seed,
                     seconds=seconds, trace=trace, device=device,
                     t_start=T_START)
    if out is None:            # a rank other than 0 of a multi-card cell
        return None
    res = {"correct": out["correct"], "attempted": out["attempted"],
           "failed": out["failed"]}
    units = {m["name"]: m["unit"] for m in e2e + per_layer}
    if trace:
        got = {}
        for m in per_layer:
            v = reader(m["name"]).read(out["readings"])
            if v is not None and math.isfinite(v):
                got[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
        res["metrics"] = got
    else:
        # a cell may report a driver's number under a name of its own
        names = wl.get("metric_names", {})
        got = {names.get(k, k): v for k, v in out["e2e"].items()}
        res["metrics"] = {m["name"]: {"value": float(got[m["name"]]),
                                      "unit": m["unit"]}
                          for m in e2e if m["name"] in got}
    res["device"] = dict(out["device"])
    if trace and out.get("profile"):
        from portbench.trace import breakdown
        res["device"].update(busy_s=out["profile"]["busy_s"],
                             window_s=out["profile"]["window_s"])
        res["breakdown"] = breakdown(out["profile"])
    res["checks"] = out["checks"]
    return res


def launch(argv, chips: int) -> int:
    """Start one process of this run a card (the port's spawn: a free
    loopback port, GOI_* variables, card r for rank r), wait for all,
    and print rank 0's result as this process's."""
    import tempfile
    from goi_tpu_torch.dist.multihost import spawn, wait_all
    env = dict(os.environ, PORTBENCH_T0=repr(
        time.time() - (time.perf_counter() - T_START)))
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(Path(tmp) / f"rank{r}.log", "w+") for r in range(chips)]
        procs = spawn([sys.executable, str(HERE / "run.py"), *argv], chips,
                      env=env, stdout=logs)
        codes = wait_all(procs, timeout=RANK_TIMEOUT_S)
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read().splitlines())
            f.close()
    for r, (code, lines) in enumerate(zip(codes, outs)):
        if r == 0 or code != 0:
            body = lines[:-1] if r == 0 and code == 0 else lines
            print("\n".join(f"[rank {r}] {x}" for x in body[-200:]),
                  file=sys.stderr if code else sys.stdout, flush=True)
    if any(c != 0 for c in codes) or not outs[0]:
        print(f"[portbench] rank exit codes {codes}", file=sys.stderr)
        return 1
    res = json.loads(outs[0][-1])
    return finish(res)


def finish(res: dict) -> int:
    bad = loaded_forbidden()
    if bad:
        print(f"[portbench] loaded after the window: {bad}", file=sys.stderr)
        return 3
    for k, v in res["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    wl, _ = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[portbench] {args.workload} needs {wl['chips']} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    if importlib.util.find_spec("goi_tpu_torch") is None:
        print("[portbench] the program (goi_tpu_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    rank = os.environ.get("GOI_PROC_ID")
    if wl["chips"] > 1 and rank is None:
        return launch(argv, wl["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    if res is None:            # a rank other than 0
        bad = loaded_forbidden()
        if bad:
            print(f"[portbench] loaded after the window: {bad}",
                  file=sys.stderr)
            return 3
        return 0
    return finish(res)


if __name__ == "__main__":
    sys.exit(main())
