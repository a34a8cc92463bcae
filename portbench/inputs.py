"""Seeded inputs of a cell, made on the device from --seed.

Everything here is plain PyTorch and numpy and imports nothing of the
program: the scene's raw parameters, the training views, the APE-like
feature maps, the viewer's orbit path, and the query cell's decoder,
codebook and text embedding. Each input draws from a torch.Generator
on the device of its own stream of the seed, in a few large calls, so
that the same seed gives the same inputs and one input never shifts
another. The sizes come from the configuration's file; only the values
depend on the seed, so every seed asks for the same work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814

# one stream of the seed per input
STREAMS = {"scene": 1, "views": 2, "maps": 3, "path": 4, "query": 5,
           "sample": 6}


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed of `name`'s stream, from a seed of any size."""
    return (int(seed) * 1_000_003 + STREAMS[name] * 7919) % (2 ** 63 - 1)


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, name))
    return g


def make_scene(spec: dict, seed: int, device) -> dict:
    """Raw (pre-activation) Gaussian parameters of `spec` (the
    configuration's "scene"): positions N(center, std) per axis, colours
    uniform as the SH DC term, higher SH N(0, rest_std), semantics
    N(0, sem_std), log-scales of a log-uniform scale in [lo, hi] (the
    same on the three axes with "isotropic", else drawn per axis),
    quaternions N(0, 1), opacity logits logit(opacity_base) + N(0, 1)
    times opacity_std."""
    n, s = spec["n_gaussians"], spec["sem_dim"]
    n_rest = (spec["sh_degree"] + 1) ** 2 - 1
    g = generator(seed, "scene", device)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    center = torch.tensor(spec["xyz_center"], device=device)
    std = torch.tensor(spec["xyz_std"], device=device)
    lo, hi = (math.log(v) for v in spec["scale_range"])
    axes = 1 if spec["isotropic"] else 3
    log_scale = (lo + (hi - lo) * rand(n, axes)).expand(n, 3).contiguous()
    base = math.log(spec["opacity_base"] / (1.0 - spec["opacity_base"]))
    return {
        "xyz": center + std * randn(n, 3),
        "features_dc": ((rand(n, 1, 3) - 0.5) / SH_C0),
        "features_rest": spec["rest_std"] * randn(n, n_rest, 3),
        "semantics": spec["sem_std"] * randn(n, s),
        "scaling": log_scale,
        "rotation": randn(n, 4),
        "opacity": base + spec["opacity_std"] * randn(n, 1),
        "sh_degree": spec["sh_degree"],
    }


def projection(znear: float, zfar: float, fovx: float, fovy: float):
    """The 3DGS perspective matrix (column-vector form)."""
    top = math.tan(fovy / 2) * znear
    right = math.tan(fovx / 2) * znear
    p = np.zeros((4, 4))
    p[0, 0] = znear / right
    p[1, 1] = znear / top
    p[3, 2] = 1.0
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    return p


def camera(w2c: np.ndarray, fovx: float, fovy: float, width: int,
           height: int, znear: float = 0.01, zfar: float = 100.0) -> dict:
    """A view as plain numbers: world->view (4, 4), projection @ it, the
    camera centre, the half-angle tangents and the size."""
    w2c = np.asarray(w2c, np.float64)
    full = projection(znear, zfar, fovx, fovy) @ w2c
    return {"world_view": np.float32(w2c), "full_proj": np.float32(full),
            "center": np.float32(np.linalg.inv(w2c)[:3, 3]),
            "tan_fovx": math.tan(fovx / 2), "tan_fovy": math.tan(fovy / 2),
            "width": int(width), "height": int(height)}


def look_at(eye, target, fovx, fovy, width, height) -> dict:
    """x right, y down, z forward (COLMAP's convention), up = +y."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    r = np.stack([right, down, fwd])
    w2c = np.eye(4)
    w2c[:3, :3] = r
    w2c[:3, 3] = -r @ eye
    return camera(w2c, fovx, fovy, width, height)


def training_views(spec: dict, seed: int) -> list:
    """`spec["n"]` views on a circle of `radius` at height `eye_y`,
    looking at `target`, evenly spaced from a seeded start angle."""
    rng = np.random.default_rng(stream_seed(seed, "views"))
    a0 = float(rng.uniform(0.0, 2 * math.pi))
    fovx = spec["fovx"]
    fovy = 2 * math.atan(spec["height"] / (spec["width"] / math.tan(fovx / 2)))
    views = []
    for i in range(spec["n"]):
        a = a0 + 2 * math.pi * i / spec["n"]
        eye = [spec["radius"] * math.sin(a), spec["eye_y"],
               -spec["radius"] * math.cos(a)]
        views.append(look_at(eye, spec["target"], fovx, fovy,
                             spec["width"], spec["height"]))
    return views


def feature_maps(spec: dict, views: list, seed: int, device) -> list:
    """One (channels, H, W) APE-like map a view: `prototypes` N(0, 1)
    prototypes laid out by a label map of `cell` x `cell` pixel blocks,
    plus N(0, noise) a pixel (so that every pixel's feature is
    distinct). Returns (maps, prototypes)."""
    g = generator(seed, "maps", device)
    c, k, cell = spec["channels"], spec["prototypes"], spec["cell"]
    protos = torch.randn((k, c), generator=g, device=device)
    maps = []
    for v in views:
        h, w = v["height"], v["width"]
        lab = torch.randint(0, k, ((h + cell - 1) // cell,
                                   (w + cell - 1) // cell),
                            generator=g, device=device)
        lab = lab.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
        fm = protos[lab[:h, :w]].permute(2, 0, 1).contiguous()
        fm += spec["noise"] * torch.randn(fm.shape, generator=g,
                                          device=device)
        maps.append(fm)
    return maps, protos


def prototypes(spec: dict, seed: int, device) -> torch.Tensor:
    """feature_maps' prototypes alone (its stream's first draw)."""
    g = generator(seed, "maps", device)
    return torch.randn((spec["prototypes"], spec["channels"]), generator=g,
                       device=device)


def orbit_path(spec: dict, seed: int) -> list:
    """The viewer's orbit requests, one a frame, periodic in `period`
    frames: azimuth a full turn a period from a seeded start (the
    direction seeded too), elevation `elev` + `elev_amp` sin(2 pi i /
    period) from a seeded phase. Each is the query of a /frame
    request: elev, azim, radius, w, h, scale."""
    rng = np.random.default_rng(stream_seed(seed, "path"))
    a0 = float(rng.uniform(-180.0, 180.0))
    sign = 1.0 if rng.uniform() < 0.5 else -1.0
    phase = float(rng.uniform(0.0, 2 * math.pi))
    p = spec["period"]
    out = []
    for i in range(p):
        azim = (a0 + sign * 360.0 * i / p + 180.0) % 360.0 - 180.0
        elev = spec["elev"] + spec["elev_amp"] * math.sin(
            2 * math.pi * i / p + phase)
        out.append({"elev": elev, "azim": azim, "radius": spec["radius"],
                    "w": spec["width"], "h": spec["height"], "scale": 1.0})
    return out


def query_model(spec: dict, protos: torch.Tensor, seed: int, device):
    """The query cell's trained-model stand-ins: a 1-layer decoder
    (dim_in -> tab_len, Xavier-uniform weights, zero bias), a codebook
    whose rows are a seeded prototype each plus N(0, code_noise), and
    the aligned text embedding text_scale * the unit vector of one
    seeded prototype, minus text_bias * the unit mean of the unit
    codebook rows. Returns (weight, bias, lut, text)."""
    g = generator(seed, "query", device)
    d_in, k = spec["dim_in"], spec["tab_len"]
    bound = math.sqrt(6.0 / (d_in + k))
    weight = (torch.rand((k, d_in), generator=g, device=device) * 2 - 1) \
        * bound
    bias = torch.zeros(k, device=device)
    which = torch.randint(0, protos.shape[0], (k,), generator=g,
                          device=device)
    lut = protos[which] + spec["code_noise"] * torch.randn(
        (k, protos.shape[1]), generator=g, device=device)
    target = int(torch.randint(0, protos.shape[0], (1,), generator=g,
                               device=device))
    unit = protos[target] / torch.linalg.norm(protos[target])
    rows = lut / torch.linalg.norm(lut, dim=1, keepdim=True)
    mean = rows.mean(0)
    text = spec["text_scale"] * unit - spec["text_bias"] * mean \
        / torch.linalg.norm(mean)
    return weight, bias, lut, text


def sample_indices(seed: int, total: int, k: int) -> list:
    """k distinct indices of range(total), drawn from the seed, with the
    last one always in (the latest answer of the window)."""
    rng = np.random.default_rng(stream_seed(seed, "sample"))
    k = min(k, total)
    picks = set(rng.choice(total - 1, k - 1, replace=False).tolist()) \
        if k > 1 else set()
    return sorted(picks | {total - 1})


class Reservoir:
    """k answers of a stream whose length is known only at its end,
    drawn from the seed: the last (the latest answer of the window)
    always, and k - 1 of the others by reservoir sampling, each as
    likely as any other."""

    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng(stream_seed(seed, "sample"))
        self.slots, self.seen, self.k = [], 0, k
        self.last = None

    def offer(self, index: int, item) -> None:
        if self.last is not None and self.k > 1:
            if len(self.slots) < self.k - 1:
                self.slots.append(self.last)
            else:
                j = int(self.rng.integers(0, self.seen + 1))
                if j < self.k - 1:
                    self.slots[j] = self.last
            self.seen += 1
        self.last = (index, item)

    def items(self) -> dict:
        """{index: item} of the sample."""
        return dict(sorted(self.slots + ([self.last] if self.last else [])))
