"""The program's side of a cell: the port's objects made from the cell's
seeded inputs, and the comparison of what it produced with the
reference's.

Nothing here is timed; the drivers call the port's entries themselves.
"""

from __future__ import annotations

import statistics

import torch


def build_kernels(names, device) -> None:
    """Compile (or find in build/goi_tpu_torch) the port's kernels the
    cell runs, all at once, before anything is timed."""
    if torch.device(device).type == "cuda":
        from goi_tpu_torch.raster import _nvcc
        _nvcc.build(names)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phases(marks) -> str:
    """'name s, ...' of the seconds between successive (name, time)."""
    return ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s"
                     for a, b in zip(marks, marks[1:]))


def scene(raw: dict):
    """The port's GaussianScene of the raw seeded parameters (all valid,
    every SH degree active)."""
    from goi_tpu_torch.core.scene import GaussianScene
    n = raw["xyz"].shape[0]
    return GaussianScene(
        xyz=raw["xyz"], features_dc=raw["features_dc"],
        features_rest=raw["features_rest"], semantics=raw["semantics"],
        scaling=raw["scaling"], rotation=raw["rotation"],
        opacity=raw["opacity"],
        valid=torch.ones(n, dtype=torch.bool, device=raw["xyz"].device),
        active_sh_degree=raw["sh_degree"], max_sh_degree=raw["sh_degree"])


def camera(view: dict, device):
    """The port's Camera of a view of portbench.inputs."""
    from goi_tpu_torch.core.camera import Camera

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return Camera(world_view=t(view["world_view"]),
                  full_proj=t(view["full_proj"]),
                  camera_center=t(view["center"]),
                  tan_fovx=t(view["tan_fovx"]), tan_fovy=t(view["tan_fovy"]),
                  width=view["width"], height=view["height"])


def device_info(device, chips: int) -> dict:
    """The result's device: platform, the card's name, the cards used,
    and the peak of memory allocated on this process's card."""
    info = {"platform": "gpu" if torch.device(device).type == "cuda"
            else "cpu", "kind": "", "count": chips, "memory_peak_bytes": 0}
    if info["platform"] == "gpu":
        info["kind"] = torch.cuda.get_device_name(0)
        info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    return info


def leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference leaf's norm and the
    median leaf's. Leaves whose reference norm is under a thousandth of
    the median leaf's are left out."""
    nr = {k: float(torch.linalg.norm(v.double())) for k, v in ref.items()}
    med = statistics.median(nr.values())
    worst = 0.0
    for k, v in prog.items():
        if nr[k] < 1e-3 * med:
            continue
        gap = abs(float(torch.linalg.norm(v.double())) - nr[k])
        worst = max(worst, gap / max(nr[k], med))
    return worst


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's relative gap of norms (for the earlier lines)."""
    return {k: abs(float(torch.linalg.norm(prog[k].double()))
                   - float(torch.linalg.norm(ref[k].double())))
            / max(float(torch.linalg.norm(ref[k].double())), 1e-30)
            for k in ref}


def training_numbers(prog: dict, ref: dict) -> dict:
    """loss1_gap: the relative gap of the first step's loss (the later
    steps' losses follow Adam's first step, +-lr a value whatever the
    gradient's size, so a gradient near 0 whose sign rounding decides
    moves them: they are printed, and change_gap holds the steps);
    grad1_gap and change_gap: leaf_gap of the first gradient and of the
    change of the parameters over the first steps."""
    loss = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    change = {k: prog["end"][k] - prog["start"][k] for k in prog["end"]}
    ref_change = {k: ref["end"][k] - ref["start"][k] for k in ref["end"]}
    return {"loss1_gap": loss,
            "grad1_gap": leaf_gap(prog["grad1"], ref["grad1"]),
            "change_gap": leaf_gap(change, ref_change)}


def frame_numbers(frames: list, refs: list, levels: int) -> dict:
    """frame_mismatch: the worst frame's share of pixels whose colour is
    off the reference's by more than `levels` of 255 in some channel."""
    worst = 0.0
    for f, r in zip(frames, refs):
        d = (torch.as_tensor(f).to(r.device).int() - r.int()).abs()
        worst = max(worst, float((d.amax(-1) > levels).float().mean()))
    return {"frame_mismatch": worst}


def checks(numbers: dict, limits: dict) -> tuple:
    """({name: {value, limit}}, every number finite and within its limit)."""
    out = {k: {"value": float(v), "limit": float(limits[k])}
           for k, v in numbers.items()}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"]
             for v in out.values())
    return out, ok
