"""PLY point-cloud I/O, bit-compatible with the reference's format.

Binary-little-endian PLY with float32 vertex properties
  x y z nx ny nz f_dc_0..2 f_rest_0..(3*((deg+1)^2-1)-1) sem_0..(S-1)
  opacity scale_0..2 rot_0..3
(ref:scene/gaussian_model.py:255-358). A dependency-free numpy codec;
files written here load in goi_tpu and the reverse.
"""

from __future__ import annotations

import io
from typing import Dict, List, Tuple

import numpy as np
import torch

_PLY_TO_NUMPY = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NUMPY_TO_PLY = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int",
                 "u4": "uint", "i1": "char", "i2": "short", "u2": "ushort"}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the first 'vertex' element into {property_name: (N,) array}.
    binary_little_endian and ascii, scalar properties only (list
    properties, used for faces, are skipped)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:header_end].decode("ascii", errors="replace")
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    cur = None
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = (parts[1], int(parts[2]), [])
            elements.append(cur)
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                cur[2].append(("__list__", parts[-1]))
            else:
                cur[2].append((parts[2], _PLY_TO_NUMPY[parts[1]]))

    if fmt not in ("binary_little_endian", "ascii"):
        raise ValueError(f"{path}: unsupported PLY format {fmt}")

    out: Dict[str, np.ndarray] = {}
    offset = 0
    for name, count, props in elements:
        if any(p[0] == "__list__" for p in props):
            if name == "vertex":
                raise ValueError("list properties on vertex unsupported")
            break  # faces etc. come after vertices; stop parsing
        dtype = np.dtype([(p, "<" + t) for p, t in props])
        if fmt == "binary_little_endian":
            arr = np.frombuffer(body, dtype=dtype, count=count,
                                offset=offset)
            offset += dtype.itemsize * count
        else:
            text = body.decode("ascii")
            rows = text.split("\n")[: count]
            flat = np.loadtxt(io.StringIO("\n".join(rows)), ndmin=2)
            arr = np.zeros(count, dtype)
            for i, (p, _) in enumerate(props):
                arr[p] = flat[:, i]
        if name == "vertex":
            for p, _ in props:
                out[p] = np.ascontiguousarray(arr[p])
            break
    return out


def write_ply(path: str, props: Dict[str, np.ndarray],
              faces: np.ndarray = None) -> None:
    """Write a binary_little_endian PLY with one 'vertex' element whose
    properties appear in dict insertion order; optional (F, 3) triangle
    'face' element."""
    names = list(props)
    n = len(props[names[0]])
    dtype = np.dtype(
        [(k, "<" + np.dtype(props[k].dtype).str[-2:]) for k in names])
    arr = np.empty(n, dtype)
    for k in names:
        v = np.asarray(props[k])
        if v.shape != (n,):
            raise ValueError(f"property {k} has shape {v.shape}")
        arr[k] = v
    lines = ["ply", "format binary_little_endian 1.0",
             f"element vertex {n}"]
    for k in names:
        lines.append(
            f"property {_NUMPY_TO_PLY[np.dtype(props[k].dtype).str[-2:]]} {k}")
    if faces is not None:
        lines += [f"element face {len(faces)}",
                  "property list uchar int vertex_indices"]
    lines.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        f.write(arr.tobytes())
        if faces is not None:
            fdtype = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
            farr = np.empty(len(faces), fdtype)
            farr["n"] = 3
            farr["idx"] = np.asarray(faces, np.int32)
            f.write(farr.tobytes())


# ---------------------------------------------------------------------------
# GaussianScene <-> PLY (reference checkpoint layout)
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_gaussians_ply(path: str, scene) -> None:
    """Serialize a GaussianScene in the reference's property order
    (ref:scene/gaussian_model.py:255-289). Only valid rows are written.
    f_dc/f_rest are flattened channel-major, i.e.
    f_rest_k = coeff[k % M, k // M] for M = (deg+1)^2 - 1."""
    valid = _np(scene.valid)
    xyz = _np(scene.xyz).astype(np.float32)[valid]
    f_dc = _np(scene.features_dc).astype(np.float32)[valid]      # (n,1,3)
    f_rest = _np(scene.features_rest).astype(np.float32)[valid]  # (n,M,3)
    sems = _np(scene.semantics).astype(np.float32)[valid]
    opa = _np(scene.opacity).astype(np.float32)[valid]
    scale = _np(scene.scaling).astype(np.float32)[valid]
    rot = _np(scene.rotation).astype(np.float32)[valid]

    n = xyz.shape[0]
    props: Dict[str, np.ndarray] = {}
    for i, k in enumerate("xyz"):
        props[k] = xyz[:, i]
    for k in ("nx", "ny", "nz"):
        props[k] = np.zeros(n, np.float32)
    dc_flat = f_dc.transpose(0, 2, 1).reshape(n, -1)
    for i in range(dc_flat.shape[1]):
        props[f"f_dc_{i}"] = np.ascontiguousarray(dc_flat[:, i])
    rest_flat = f_rest.transpose(0, 2, 1).reshape(n, -1)
    for i in range(rest_flat.shape[1]):
        props[f"f_rest_{i}"] = np.ascontiguousarray(rest_flat[:, i])
    for i in range(sems.shape[1]):
        props[f"sem_{i}"] = np.ascontiguousarray(sems[:, i])
    props["opacity"] = opa[:, 0]
    for i in range(scale.shape[1]):
        props[f"scale_{i}"] = np.ascontiguousarray(scale[:, i])
    for i in range(rot.shape[1]):
        props[f"rot_{i}"] = np.ascontiguousarray(rot[:, i])
    write_ply(path, props)


def _sorted_names(v, prefix):
    return sorted((k for k in v if k.startswith(prefix)),
                  key=lambda s: int(s.split("_")[-1]))


def load_gaussians_ply(path: str, *, sh_degree: int | None = None,
                       sem_dim: int = 10, capacity: int | None = None,
                       device="cuda"):
    """Load a reference-format Gaussian PLY into a GaussianScene
    (ref:scene/gaussian_model.py:307-358). Missing sem_* properties load
    as zeros; sh_degree None infers the degree from the f_rest_* count."""
    from goi_tpu_torch.core.scene import GaussianScene

    v = read_ply(path)
    n = len(v["x"])
    xyz = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    opa = v["opacity"].astype(np.float32)[:, None]
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], 1).astype(np.float32)
    rest_names = _sorted_names(v, "f_rest_")
    if sh_degree is None:
        sh_degree = int(round((len(rest_names) / 3 + 1) ** 0.5)) - 1
    m = (sh_degree + 1) ** 2 - 1
    if len(rest_names) != 3 * m:
        raise ValueError(f"{path}: {len(rest_names)} f_rest properties, "
                         f"SH degree {sh_degree} needs {3 * m}")
    if m:
        rest = np.stack([v[k] for k in rest_names], 1).astype(np.float32)
        f_rest = rest.reshape(n, 3, m).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    sem_names = _sorted_names(v, "sem_")
    sems = np.zeros((n, sem_dim), np.float32)
    if len(sem_names) == sem_dim:
        sems = np.stack([v[k] for k in sem_names], 1).astype(np.float32)
    scales = np.stack([v[k] for k in _sorted_names(v, "scale_")],
                      1).astype(np.float32)
    rots = np.stack([v[k] for k in _sorted_names(v, "rot_")],
                    1).astype(np.float32)

    cap = capacity or n

    def t(a, fill=0.0):
        if cap != a.shape[0]:
            w = [(0, cap - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            a = np.pad(a, w, constant_values=fill)
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    valid = np.zeros(cap, bool)
    valid[:n] = True
    return GaussianScene(
        xyz=t(xyz),
        features_dc=t(f_dc[:, :, None].transpose(0, 2, 1)),
        features_rest=t(f_rest),
        semantics=t(sems),
        scaling=t(scales, -10.0),
        rotation=t(rots),
        opacity=t(opa, -20.0),
        valid=torch.as_tensor(valid, device=device),
        active_sh_degree=sh_degree,
        max_sh_degree=sh_degree,
    )
