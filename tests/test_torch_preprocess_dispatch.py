"""raster/preprocess.py's choice between the kernel and the composition,
the kernel wrapper's checks and the counters, on the CPU.

`preprocess` takes the kernel (csrc/preprocess.cu) for CUDA tensors when
no gradient has to flow through the geometry, else the composition
`preprocess_plain`. Here the preprocess module's `_nvcc` is replaced by
one whose `is_cuda` is always true and `preprocess_cuda` by a recorder
that runs the composition, so the rule is read on CPU tensors; the rest
of the render (binning, blend) keeps the real device check. The
wrapper's own checks run with the real `_nvcc` and raise before any
library is loaded. The kernel against the composition, bit for bit, is
tests/test_torch_cuda.py's (card only)."""

import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from goi_tpu_torch.core.camera import Camera
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.raster import _nvcc
from goi_tpu_torch.raster.render import RasterConfig, render
from goi_tpu_torch.utils import profiling

torch.set_num_threads(1)

pre = importlib.import_module("goi_tpu_torch.raster.preprocess")

N, W, H = 300, 48, 32
CFG = RasterConfig(max_instances=1 << 13, reduce="chain")
GEOMETRY = ("xyz", "scaling", "rotation", "opacity", "features_dc",
            "features_rest")
CAMERA = ("world_view", "full_proj", "camera_center", "tan_fovx",
          "tan_fovy")


def make_scene(seed=0, n=N, sh_degree=3):
    rng = np.random.default_rng(seed)
    scene = GaussianScene.create(
        rng.normal(0.0, 0.5, (n, 3)), rng.uniform(0.0, 1.0, (n, 3)),
        sh_degree=sh_degree, sem_dim=4,
        scales=rng.uniform(0.02, 0.08, n).astype(np.float32), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    return scene.replace(
        active_sh_degree=sh_degree,
        features_rest=0.1 * torch.randn(scene.features_rest.shape,
                                        generator=gen),
        rotation=torch.randn((n, 4), generator=gen),
        opacity=torch.randn((n, 1), generator=gen),
        semantics=torch.randn((n, 4), generator=gen))


def make_camera():
    return Camera.look_at([0.4, 0.3, -3.0], [0, 0, 0], [0, 1, 0], 0.9, 0.65,
                          W, H, device="cpu")


def dense_camera():
    """make_camera() in the kernel's layout, as the dispatch hands it on
    (its camera_center is a strided view)."""
    return pre._dense(make_scene(), make_camera())[1]


def options(n=N, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return {"override_color": torch.rand((n, 3), generator=gen),
            "cov3d_precomp": 1e-3 * torch.rand((n, 6), generator=gen)}


def with_grad(scene, cam, name):
    """(scene, cam, kwargs) with the input `name` requiring grad."""
    kw = {}
    if name in GEOMETRY:
        scene = scene.replace(
            **{name: getattr(scene, name).clone().requires_grad_()})
    elif name in CAMERA:
        cam = dataclasses.replace(
            cam, **{name: getattr(cam, name).clone().requires_grad_()})
    else:
        kw[name] = options()[name].requires_grad_()
    return scene, cam, kw


@pytest.fixture
def as_cuda(monkeypatch):
    """The preprocess module sees every tensor as a CUDA tensor, and its
    kernel wrapper is a recorder that runs the composition with no
    gradient through it; returns the recorded calls."""
    calls = []

    def recorder(scene, cam, **kw):
        calls.append(kw)
        with torch.no_grad():
            sp = pre.preprocess_plain(scene, cam, **kw)
        # as the wrapper: the semantics outside the kernel, differentiable
        return dataclasses.replace(
            sp, semantics=scene.get_semantics(kw["semantic_masks"]))

    monkeypatch.setattr(pre, "_nvcc", types.SimpleNamespace(
        is_cuda=lambda t: True))
    monkeypatch.setattr(pre, "preprocess_cuda", recorder)
    return calls


@pytest.fixture(autouse=True)
def fresh_registry():
    profiling.reset()
    yield
    profiling.reset()


def assert_splats_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and torch.equal(x, y), f.name


def test_no_grad_takes_the_kernel(as_cuda):
    scene = make_scene()
    scene = scene.replace(**{k: getattr(scene, k).requires_grad_()
                             for k in GEOMETRY})
    cam = make_camera()
    with torch.no_grad():
        got = pre.preprocess(scene, cam)
    assert len(as_cuda) == 1
    assert_splats_equal(got, pre.preprocess_plain(scene, cam))


def test_semantics_alone_requiring_grad_takes_the_kernel(as_cuda):
    scene = make_scene()
    scene = scene.replace(semantics=scene.semantics.requires_grad_())
    masks = torch.rand(N, generator=torch.Generator().manual_seed(3))
    got = pre.preprocess(scene, make_camera(), semantic_masks=masks)
    assert len(as_cuda) == 1
    assert not got.mean2d.requires_grad
    # the semantics stay a PyTorch expression: their gradient flows
    got.semantics.sum().backward()
    assert torch.equal(scene.semantics.grad,
                       masks[:, None].expand(N, 4).contiguous())


@pytest.mark.parametrize("name", GEOMETRY + CAMERA
                         + ("override_color", "cov3d_precomp"))
def test_each_geometry_input_requiring_grad_takes_the_composition(
        as_cuda, name):
    scene, cam, kw = with_grad(make_scene(), make_camera(), name)
    got = pre.preprocess(scene, cam, **kw)
    assert as_cuda == []
    assert any(getattr(got, f).requires_grad
               for f in ("mean2d", "depth", "conic", "opacity", "color"))
    with torch.no_grad():
        pre.preprocess(scene, cam, **kw)
    assert len(as_cuda) == 1


def test_cpu_tensors_take_the_composition_without_the_library(monkeypatch):
    def no_library(*a, **k):
        raise AssertionError("the CPU path loaded a library")

    monkeypatch.setattr(_nvcc, "library", no_library)
    before = pre.preprocess_cuda.launches
    scene = make_scene()
    cam = make_camera()
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.no_grad():
            got = pre.preprocess(scene, cam, **options())
        grad_scene = scene.replace(xyz=scene.xyz.clone().requires_grad_())
        pre.preprocess(grad_scene, cam)
    assert_splats_equal(got, pre.preprocess_plain(scene, cam, **options()))
    assert pre.preprocess_cuda.launches == before
    # the counters count the paths taken on CUDA tensors only
    assert profiling.snapshot()["counters"] == {}


def test_dispatch_hands_the_kernel_contiguous_tensors(as_cuda, monkeypatch):
    seen = []
    record = pre.preprocess_cuda

    def check_dense(scene, cam, **kw):
        tensors = pre._kernel_tensors(scene, cam, kw["override_color"],
                                      kw["cov3d_precomp"])
        seen.append(all(t is None or t.is_contiguous()
                        for t, _ in tensors.values()))
        return record(scene, cam, **kw)

    monkeypatch.setattr(pre, "preprocess_cuda", check_dense)
    scene = make_scene()
    cam = make_camera()
    # column-major copies: the same values, not contiguous
    strided = scene.replace(xyz=scene.xyz.T.contiguous().T,
                            features_rest=scene.features_rest.transpose(
                                0, 1).contiguous().transpose(0, 1))
    cam_t = dataclasses.replace(
        cam, world_view=cam.world_view.T.contiguous().T)
    over = options()["override_color"]
    assert not strided.xyz.is_contiguous()
    got = pre.preprocess(strided, cam_t,
                         override_color=over.T.contiguous().T)
    assert seen == [True]
    assert_splats_equal(got, pre.preprocess_plain(scene, cam,
                                                  override_color=over))


def _bad_inputs(case):
    scene, cam, kw = make_scene(), dense_camera(), {}
    if case == "dtype":
        scene = scene.replace(xyz=scene.xyz.double())
    elif case == "valid_dtype":
        scene = scene.replace(valid=scene.valid.to(torch.uint8))
    elif case == "shape":
        scene = scene.replace(rotation=scene.rotation[:, :3].contiguous())
    elif case == "option_shape":
        kw["cov3d_precomp"] = options()["cov3d_precomp"][:, :5].contiguous()
    elif case == "camera_shape":
        cam = dataclasses.replace(cam, world_view=cam.world_view[:3])
    elif case == "contiguity":
        scene = scene.replace(xyz=scene.xyz.T.contiguous().T)
    elif case == "device":
        pass                      # every tensor on the CPU
    elif case == "sh_rows":
        scene = make_scene(sh_degree=1).replace(active_sh_degree=2)
    elif case == "sh_degree":
        scene = make_scene(sh_degree=3).replace(active_sh_degree=4)
    elif case == "frame":
        cam = dataclasses.replace(cam, width=0)
    return scene, cam, kw


REFUSED = {"dtype": (TypeError, "xyz must be torch.float32"),
           "valid_dtype": (TypeError, "valid must be torch.bool"),
           "shape": (ValueError, "rotation of shape"),
           "option_shape": (ValueError, "cov3d_precomp of shape"),
           "camera_shape": (ValueError, "world_view of shape"),
           "contiguity": (ValueError, "xyz must be contiguous"),
           "device": (ValueError, "xyz must be on the CUDA device"),
           "sh_rows": (ValueError, "SH degree"),
           "sh_degree": (ValueError, "SH degree"),
           "frame": (ValueError, "a frame of pixels")}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(case, monkeypatch):
    def no_library(*a, **k):
        raise AssertionError("a refused input reached the library")

    monkeypatch.setattr(_nvcc, "library", no_library)
    before = pre.preprocess_cuda.launches
    scene, cam, kw = _bad_inputs(case)
    exc, what = REFUSED[case]
    with pytest.raises(exc, match="preprocess kernel: " + what):
        pre.preprocess_cuda(scene, cam, **kw)
    assert pre.preprocess_cuda.launches == before


def test_wrapper_takes_override_color_past_the_sh_rows(monkeypatch,
                                                       tmp_path):
    """With override_color the SH are not read, so a degree past the
    rows passes the checks (and fails only for want of a library)."""
    monkeypatch.setattr(_nvcc, "is_cuda", lambda t: True)
    monkeypatch.setattr(_nvcc, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_nvcc, "_loaded", {})
    monkeypatch.setattr(_nvcc.shutil, "which", lambda name: None)
    monkeypatch.setattr(_nvcc, "CUDA_NVCC", str(tmp_path / "no-nvcc"))
    before = pre.preprocess_cuda.launches
    scene = make_scene(sh_degree=1).replace(active_sh_degree=2)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pre.preprocess_cuda(scene, dense_camera(),
                            override_color=options()["override_color"])
    with pytest.raises(ValueError, match="preprocess kernel"):
        pre.preprocess_cuda(scene, dense_camera())
    assert pre.preprocess_cuda.launches == before


def test_armed_counters_add_up_to_the_gaussians_rendered(as_cuda):
    scene = make_scene()
    geo = scene.replace(xyz=scene.xyz.clone().requires_grad_())
    sem = scene.replace(semantics=scene.semantics.clone().requires_grad_())
    cam = make_camera()
    bg = torch.zeros(3)
    render(sem, cam, bg, CFG)            # disarmed: counts nothing
    assert profiling.snapshot()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for s in (sem, geo, sem):
            render(s, cam, bg, CFG)
        with torch.no_grad():
            render(geo, cam, bg, CFG)
    c = profiling.snapshot()["counters"]
    assert c["preprocess.fused"] == 3 * N
    assert c["preprocess.plain"] == N
    assert c["preprocess.fused"] + c["preprocess.plain"] == 4 * N
    assert isinstance(c["preprocess.fused"], int)
    assert len(as_cuda) == 1 + 3
