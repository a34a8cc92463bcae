"""Build and load the hand-written CUDA kernels of raster/csrc.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on
first use with nvcc into `build/goi_tpu_torch/lib<name>-<hash>.so` at
the root of the checkout (the hash is of the source, the csrc headers
and the source's nvcc flags, so an edited source or a changed flag
never loads a stale library), then loaded with ctypes. Wrappers pass
pointers from `tensor.data_ptr()` and PyTorch's current stream; every C
entry point returns `cudaGetLastError()` and `check` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build" / "goi_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# -fmad=false: every product is rounded on its own, as the plain PyTorch
# versions round them, so threshold tests (alpha >= 1/255, T < 1e-4)
# decide the same way in a kernel and in its plain version. blend_bwd.cu
# writes its walk with intrinsics nvcc never contracts and lets its
# gradient math use FMA; density_grid.cu and distill_loss.cu have no
# threshold to keep.
CONTRACT = {"blend_bwd", "density_grid", "distill_loss"}


def flags(name: str) -> list:
    """nvcc flags of csrc/<name>.cu."""
    return NVCC_FLAGS + ["-fmad=true" if name in CONTRACT else "-fmad=false"]

_loaded: dict = {}


def is_cuda(t: torch.Tensor) -> bool:
    """The device check every wrapper makes: kernel for a CUDA tensor,
    plain version for a CPU tensor."""
    return t.is_cuda


CUDA_NVCC = "/usr/local/cuda/bin/nvcc"


def nvcc() -> str:
    path = shutil.which("nvcc") or CUDA_NVCC
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found (PATH or {CUDA_NVCC}): the CUDA kernels of "
            f"goi_tpu_torch/raster/csrc cannot be built")
    return path


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, of every
    header in csrc (a source may include any of them) and of its flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    digest = h.hexdigest()
    return BUILD / f"lib{name}-{digest[:12]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (Popen, tmp, out) or None when
    the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)


def build(names) -> None:
    """Compile the named sources, one nvcc process each, all at once."""
    jobs = [j for j in (_start_build(n) for n in names) if j is not None]
    try:
        for job in jobs:
            _finish_build(job)
    finally:
        for proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built if needed, with
    argtypes set from `signatures` {function: [ctypes types]}."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
