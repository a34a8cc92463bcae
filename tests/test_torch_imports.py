"""The port stands alone: no file of goi_tpu_torch/ nor chip_smoke.py
imports jax or the JAX package, and a kernel wrapper handed a CUDA
tensor launches its kernel or raises (never a silent plain fallback).
The guards walk every module of the package, so new modules are covered
when they are added."""

import ast
import re
from pathlib import Path

import pytest
import torch

from goi_tpu_torch.export import mesh as export_mesh
from goi_tpu_torch.raster import _nvcc, cuda_blend, cuda_trace, gather, reduce

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "goi_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_smoke_dist.py"]


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


# modules of the data/CLI slice, named so that the guards above are seen
# to cover them (and the native loader's source is the port's own copy)
SLICE_MODULES = (
    "_cli.py", "configs/params.py", "data/colmap.py", "data/readers.py",
    "data/dataset.py", "data/scene.py", "knn/knn.py", "eval/metrics.py",
    "eval/lpips.py", "native/loader.py", "utils/logging.py",
    "utils/profiling.py", "train/__main__.py", "render.py", "metrics.py",
    "eval_seg.py", "examples/rehearsal.py")
# modules of the RGB-training and OSH slice
RGB_SLICE_MODULES = (
    "train/optim.py", "train/densify.py", "train/rgb.py",
    "train/checkpoint.py", "interop.py", "query/osh.py", "app/session.py",
    "examples/full_pipeline_demo.py")
# modules of the query-app slice
APP_SLICE_MODULES = (
    "utils/pose.py", "app/orbit.py", "app/orbit_ngp.py", "app/dbscan.py",
    "query/align.py", "query/text_encoder.py", "utils/image.py",
    "raster/render.py", "viewer/__init__.py", "viewer/web.py",
    "viewer/app.py", "viewer/server.py", "viewer/__main__.py")
# modules of the export slice
EXPORT_SLICE_MODULES = (
    "export/__init__.py", "export/marching.py", "export/mesh.py",
    "export/texture.py")
# modules of the frozen-tower slice
TOWER_SLICE_MODULES = (
    "query/_nn.py", "query/clip_text.py", "query/bert.py", "query/swin.py",
    "query/deform_attn.py", "query/grounding.py", "query/sam.py",
    "query/res.py")
# modules of the SDS guidance and edit-session slice
EDIT_SLICE_MODULES = (
    "guidance/__init__.py", "guidance/sd_torch.py", "guidance/sds.py",
    "guidance/samplers.py", "app/edit.py")
# modules of the distribution slice, and the functions that slice added
# to modules of earlier slices
DIST_SLICE_MODULES = (
    "dist/__init__.py", "dist/mesh.py", "dist/multihost.py",
    "dist/collectives.py", "dist/render.py", "dist/shard.py", "scale.py",
    "eval_sweep.py", "examples/main_path_hash.py")
DIST_SLICE_FUNCTIONS = {
    "raster/cuda_blend.py": ("pack", "reduce_rows", "reduce_inputs"),
    "raster/render.py": ("_bin_and_blend", "suggest_budgets"),
    "core/camera.py": ("stack_cameras", "unstack_cameras"),
    "interop.py": ("scene_shard_from_numpy",)}
_GOI_TPU_NAME = re.compile(r"goi_tpu(?!_torch)\b")


def _strings_naming_goi_tpu(path: Path):
    """String constants, docstrings aside, that name the JAX package (a
    path or module of it)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs and _GOI_TPU_NAME.search(node.value):
            yield node.lineno, node.value


def test_slice_modules_are_guarded_and_read_no_goi_tpu_file():
    port = ROOT / "goi_tpu_torch"
    assert {port / m for m in SLICE_MODULES + RGB_SLICE_MODULES
            + APP_SLICE_MODULES + EXPORT_SLICE_MODULES
            + TOWER_SLICE_MODULES + EDIT_SLICE_MODULES
            + DIST_SLICE_MODULES + tuple(DIST_SLICE_FUNCTIONS)} <= set(FILES)
    for m, names in DIST_SLICE_FUNCTIONS.items():
        tree = ast.parse((port / m).read_text())
        defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        assert set(names) <= defined, (m, set(names) - defined)
    bad = [f"{p.relative_to(ROOT)}:{line} names {text!r}"
           for p in FILES if p.is_relative_to(port)
           for line, text in _strings_naming_goi_tpu(p)]
    assert not bad, "\n".join(bad)
    from goi_tpu_torch.native import loader
    assert loader.SRC == port / "native" / "colmap_native.cpp"
    assert loader.SRC.exists()
    assert loader.BUILD == _nvcc.BUILD == ROOT / "build" / "goi_tpu_torch"


def test_string_guard_catches_goi_tpu_paths(tmp_path):
    p = tmp_path / "x.py"
    p.write_text('"""goi_tpu/ in a docstring is fine."""\n'
                 'a = "goi_tpu/native/colmap_native.cpp"\n'
                 'b = "goi_tpu_torch/native/colmap_native.cpp"\n'
                 'c = "goi_tpu.data"\n')
    assert [t for _, t in _strings_naming_goi_tpu(p)] == [
        "goi_tpu/native/colmap_native.cpp", "goi_tpu.data"]


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


def test_expand_gather_wrapper_raises_without_library(no_library):
    before = gather.expand_gather.launches
    base = torch.arange(8) * 2
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gather.expand_gather(torch.ones(3, 8), base, 20)
    with pytest.raises(TypeError):
        gather.expand_gather(torch.ones(3, 8), base.int(), 20)
    assert gather.expand_gather.launches == before


def test_nvcc_flags_name_the_library():
    """A library's file name hashes its flags: a source built with other
    flags never loads a stale library."""
    assert "-fmad=true" in _nvcc.flags("blend_bwd")
    assert "-fmad=false" in _nvcc.flags("blend_fwd")
    path = _nvcc._lib_path("blend_fwd")
    _nvcc.CONTRACT.add("blend_fwd")
    try:
        assert _nvcc._lib_path("blend_fwd") != path
    finally:
        _nvcc.CONTRACT.discard("blend_fwd")
    assert _nvcc._lib_path("blend_fwd") == path


def test_blend_wrapper_raises_without_library(no_library):
    before = cuda_blend.blend_fwd.launches
    feat = torch.zeros(20, 16)
    se = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_blend.blend_fwd(feat, se, se + 16, 1)
    # any width is taken: padded to an instance up to S_MAX, in channel
    # groups past it; a negative width names itself
    for s_dim in (11, cuda_blend.S_MAX + 1):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_blend.blend_fwd(torch.zeros(10 + s_dim, 16), se, se + 16, 1)
    with pytest.raises(ValueError, match="sem_dim"):
        cuda_blend.blend_fwd(torch.zeros(9, 16), se, se + 16, 1)
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
    s_over = cuda_blend.S_MAX + 1
    wide = torch.zeros(1, 256, s_over + 7)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_blend.blend_bwd(torch.zeros(10 + s_over, 16), se, se + 16,
                             wide, wide, 1)
    with pytest.raises(ValueError, match="raw and grad"):
        cuda_blend.blend_bwd(torch.zeros(10 + s_over, 16), se, se + 16,
                             raw, raw, 1)
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
    # past S_MAX semantic channels the trace runs in channel groups
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_trace.trace_fwd(torch.zeros(11 + cuda_blend.S_MAX, 16), se,
                             se + 16, torch.zeros(1, 256, 11), 1)
    # lift widths up to SA_MAX = 127 fields are taken, past it the error
    # names the bound and the reference backend
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_trace.trace_fwd(feat, se, se + 16,
                             torch.zeros(1, 256, cuda_trace.SA_MAX), 1)
    with pytest.raises(ValueError, match=r"0\.\.126.*reference"):
        cuda_trace.trace_fwd(feat, se, se + 16,
                             torch.zeros(1, 256, cuda_trace.SA_MAX + 1), 1)
    assert cuda_trace.trace_fwd.launches == before


def test_prefix_boundary_wrapper_raises_without_library(no_library):
    before = reduce.prefix_boundary.launches
    p = torch.tensor([0, 3, 512], dtype=torch.int64)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        reduce.prefix_boundary(torch.zeros(512, 4), p)
    with pytest.raises(TypeError):
        reduce.prefix_boundary(torch.zeros(512, 4), p.int())
    assert reduce.prefix_boundary.launches == before


def test_owner_sums_wrapper_raises_without_library(no_library):
    before = reduce.owner_sums.launches
    p = torch.tensor([0, 3, 512], dtype=torch.int64)
    inner, tot = torch.zeros(1024, 4), torch.zeros(1, 4)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        reduce.owner_sums(inner, p, tot, 512, indexed=True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        reduce.owner_sums(inner[p], p, tot, 512, indexed=False)
    with pytest.raises(TypeError):
        reduce.owner_sums(inner, p.int(), tot, 512, indexed=True)
    assert reduce.owner_sums.launches == before


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


def test_density_grid_wrapper_raises_without_library(no_library):
    before = export_mesh.mixture_grid.launches
    packed = torch.zeros(5, export_mesh.PACK)
    axes = torch.linspace(-1, 1, 4)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        export_mesh.mixture_grid(packed, axes)
    with pytest.raises(TypeError):
        export_mesh.mixture_grid(packed.double(), axes)
    with pytest.raises(ValueError):
        export_mesh.mixture_grid(torch.zeros(5, 10), axes)
    assert export_mesh.mixture_grid.launches == before


def test_export_modules_need_neither_imageio_nor_sklearn():
    """The card machine has neither: the export writes its PNG with PIL
    and inpaints by scipy's cKDTree."""
    files = [ROOT / "goi_tpu_torch" / m for m in EXPORT_SLICE_MODULES]
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for line, mod in _imports(p)
           if mod.split(".")[0] in ("imageio", "sklearn")]
    assert not bad, "\n".join(bad)


def test_tower_modules_need_no_regex_and_default_to_the_card():
    """The card machine has no `regex`: the towers import it only inside
    a try whose ImportError falls back to the ASCII pattern. Every public
    entry point of the slice that takes a device defaults to "cuda" (the
    building blocks inside the towers take their tower's)."""
    import inspect

    from goi_tpu_torch import interop
    from goi_tpu_torch.query import (_nn, bert, clip_text, deform_attn,
                                     grounding, res, sam, swin)
    for m in TOWER_SLICE_MODULES:
        tree = ast.parse((ROOT / "goi_tpu_torch" / m).read_text())
        guarded = {id(n) for t in ast.walk(tree) if isinstance(t, ast.Try)
                   for b in t.body for n in ast.walk(b)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import) and any(
                    a.name == "regex" for a in node.names):
                assert id(node) in guarded, f"{m}:{node.lineno}"
    checked = []
    for mod in (_nn, bert, clip_text, deform_attn, grounding, res, sam,
                swin, interop):
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) \
                    != mod.__name__ or not callable(obj):
                continue
            dev = inspect.signature(obj).parameters.get("device")
            if dev is not None and dev.default is not inspect.Parameter.empty:
                assert dev.default == "cuda", f"{mod.__name__}.{name}"
                checked.append(name)
    assert {"CLIPTextTransformer", "BertModel", "SwinBackbone",
            "MSDeformAttn", "GroundingDINO", "SAM", "clip_text_from_numpy",
            "grounding_from_numpy", "sam_from_numpy"} <= set(checked)
    enc = inspect.signature(clip_text.TorchCLIPTextEncoder.from_npz)
    assert enc.parameters["device"].default == "cuda"


def test_edit_slice_entry_points_default_to_the_card():
    """The SD modules and loaders take a device that defaults to "cuda";
    the edit session runs on its scene's device."""
    import inspect

    from goi_tpu_torch import interop
    from goi_tpu_torch.guidance import sd_torch
    for obj in (sd_torch.UNet2DCondition, sd_torch.AutoencoderKL,
                sd_torch.alphas_cumprod, sd_torch.TorchDiffusionBackend
                .from_npz, interop.sd_from_numpy):
        dev = inspect.signature(obj).parameters["device"]
        assert dev.default == "cuda", obj


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


def test_distill_loss_wrapper_raises_without_library(no_library):
    """The loss's row path on a tensor the device check calls CUDA
    launches its kernel or raises; it never runs the composition."""
    from goi_tpu_torch.semantic import losses
    from goi_tpu_torch.semantic.codebook import SemanticDecoder
    before = losses.loss_rows_cuda.launches
    dec = SemanticDecoder.create(torch.Generator().manual_seed(0), dim_in=10,
                                 dim_out=12, device="cpu")
    lut, sem, gt = torch.ones(12, 16), torch.ones(40, 10), torch.ones(40, 16)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        losses.distillation_loss(dec, lut, sem, gt, 1.0)
    with pytest.raises(TypeError):
        losses.distillation_loss(dec, lut.double(), sem, gt, 1.0)
    # any number of codes reaches the kernel: past FUSED_MAX_K the decoder
    # runs in PyTorch and the second row kernel reads its logits
    wide = SemanticDecoder.create(torch.Generator().manual_seed(0),
                                  dim_in=10, dim_out=600, device="cpu")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        losses.distillation_loss(wide, torch.ones(600, 16), sem, gt, 1.0)
    with pytest.raises(ValueError, match="K <= 320"):
        losses.loss_rows_cuda(sem, wide.weights[0], None, torch.ones(600, 16),
                              gt, 1.0, grad_x=True, grad_w=True,
                              grad_lut=True)
    assert losses.loss_rows_cuda.launches == before
