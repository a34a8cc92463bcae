"""The port stands alone: no file of goi_tpu_torch/ nor chip_smoke.py
imports jax or the JAX package, and a kernel wrapper handed a CUDA
tensor launches its kernel or raises (never a silent plain fallback).
The guards walk every module of the package, so new modules are covered
when they are added."""

import ast
from pathlib import Path

import pytest
import torch

from goi_tpu_torch.raster import _nvcc, cuda_blend, cuda_trace, gather, reduce

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "goi_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "goi_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_port_imports_no_jax_and_no_goi_tpu():
    assert len(FILES) > 20
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in FILES for line, mod in _imports(p) if _forbidden(mod)]
    assert not bad, "\n".join(bad)


def test_guard_catches_forbidden_imports(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import jax.numpy as jnp\nfrom goi_tpu.core import ply\n"
                 "import goi_tpu_torch\nimportlib.import_module('jax')\n")
    found = [m for _, m in _imports(p) if _forbidden(m)]
    assert found == ["jax.numpy", "goi_tpu.core", "jax"]


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """Every tensor passes the wrapper's device check as a CUDA tensor,
    and no built library or nvcc is to be found."""
    monkeypatch.setattr(_nvcc, "is_cuda", lambda t: True)
    monkeypatch.setattr(_nvcc, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_nvcc, "_loaded", {})
    monkeypatch.setattr(_nvcc.shutil, "which", lambda name: None)
    monkeypatch.setattr(_nvcc, "CUDA_NVCC", str(tmp_path / "no-nvcc"))


def test_gather_wrapper_raises_without_library(no_library):
    before = gather.monotone_gather.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gather.monotone_gather(torch.ones(3, 8),
                               torch.arange(8, dtype=torch.int32))
    assert gather.monotone_gather.launches == before


def test_blend_wrapper_raises_without_library(no_library):
    before = cuda_blend.blend_fwd.launches
    feat = torch.zeros(20, 16)
    se = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_blend.blend_fwd(feat, se, se + 16, 1)
    with pytest.raises(ValueError, match="sem_dim"):
        cuda_blend.blend_fwd(torch.zeros(21, 16), se, se + 16, 1)
    assert cuda_blend.blend_fwd.launches == before


def test_blend_bwd_wrapper_raises_without_library(no_library):
    before = cuda_blend.blend_bwd.launches
    feat = torch.zeros(20, 16)
    se = torch.zeros(1, dtype=torch.int32)
    raw = torch.zeros(1, 256, 17)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_blend.blend_bwd(feat, se, se + 16, raw, raw, 1)
    with pytest.raises(ValueError, match="raw and grad"):
        cuda_blend.blend_bwd(feat, se, se + 16, raw[:, :, :5], raw, 1)
    assert cuda_blend.blend_bwd.launches == before


def test_prefix_wrapper_raises_without_library(no_library):
    before = reduce.prefix_blocks.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        reduce.prefix_blocks(torch.zeros(512, 4))
    with pytest.raises(TypeError):
        reduce.prefix_blocks(torch.zeros(512, 4, dtype=torch.float64))
    assert reduce.prefix_blocks.launches == before


def test_trace_wrapper_raises_without_library(no_library):
    before = cuda_trace.trace_fwd.launches
    feat = torch.zeros(20, 16)
    se = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_trace.trace_fwd(feat, se, se + 16, torch.zeros(1, 256, 11), 1)
    with pytest.raises(ValueError, match="sem_dim"):
        cuda_trace.trace_fwd(torch.zeros(21, 16), se, se + 16,
                             torch.zeros(1, 256, 11), 1)
    with pytest.raises(ValueError, match="0..31"):
        cuda_trace.trace_fwd(feat, se, se + 16, torch.zeros(1, 256, 33), 1)
    assert cuda_trace.trace_fwd.launches == before


def test_prefix_boundary_wrapper_raises_without_library(no_library):
    before = reduce.prefix_boundary.launches
    p = torch.tensor([0, 3, 512], dtype=torch.int64)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        reduce.prefix_boundary(torch.zeros(512, 4), p)
    with pytest.raises(TypeError):
        reduce.prefix_boundary(torch.zeros(512, 4), p.int())
    assert reduce.prefix_boundary.launches == before


def test_mono_rows_wrapper_raises_without_library(no_library):
    before = gather.mono_rows.launches
    idx = torch.arange(8, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gather.mono_rows(torch.ones(8, 3), idx)
    with pytest.raises(TypeError):
        gather.mono_rows(torch.ones(8, 3), idx.long())
    with pytest.raises(ValueError):
        gather.mono_rows(torch.ones(8), idx)
    assert gather.mono_rows.launches == before


def _atomic_float_sums(path: Path):
    """Calls that sum with float atomics on CUDA: index_add(_),
    scatter_add(_), index_put(_) with accumulate=True and
    scatter_reduce(_) with a sum."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = getattr(node.func, "attr", getattr(node.func, "id", ""))
        base = name.rstrip("_")
        kw = {k.arg: k.value for k in node.keywords}
        if base in ("index_add", "scatter_add"):
            yield node.lineno, name
        elif base == "index_put" and isinstance(
                kw.get("accumulate"), ast.Constant) \
                and kw["accumulate"].value:
            yield node.lineno, name
        elif base == "scatter_reduce" and any(
                isinstance(a, ast.Constant) and a.value == "sum"
                for a in list(node.args) + list(kw.values())):
            yield node.lineno, name


def test_port_sums_without_float_atomics():
    """No module of the port sums through float atomics, so every
    backward gives the same bits on the card."""
    bad = [f"{p.relative_to(ROOT)}:{line} calls {name}"
           for p in FILES for line, name in _atomic_float_sums(p)]
    assert not bad, "\n".join(bad)


def test_atomic_guard_catches_accumulating_calls(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("a.index_add_(0, i, v)\nb.scatter_add(0, i, v)\n"
                 "c.index_put_((i,), v, accumulate=True)\n"
                 "d.scatter_reduce_(0, i, v, 'sum')\n"
                 "e.index_put_((i,), v)\nf.scatter_reduce_(0, i, v, 'amax')\n")
    assert [n for _, n in _atomic_float_sums(p)] == [
        "index_add_", "scatter_add", "index_put_", "scatter_reduce_"]
