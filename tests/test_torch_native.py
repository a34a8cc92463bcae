"""The port's native COLMAP parser (goi_tpu_torch/native): its own copy
of the C++ source builds with g++ into build/goi_tpu_torch/, and its
points and images equal the port's Python parser's and goi_tpu's native
parser's (the float32 path of the native points at rtol 1e-6, as
tests/test_native.py holds goi_tpu's)."""

import os
from pathlib import Path

import numpy as np
import pytest

from goi_tpu.native import loader as jloader
from goi_tpu_torch.data.colmap import (read_images_binary,
                                       read_points3d_binary)
from goi_tpu_torch.native import loader
from tests.test_data_io import _write_colmap_binary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def sparse_dir(tmp_path):
    d = str(tmp_path / "sparse")
    _write_colmap_binary(d, n_pts=500)
    return d


def test_native_builds_from_the_ports_copy():
    assert loader.native_available(), "g++ toolchain expected in this image"
    assert loader.SRC == Path(ROOT, "goi_tpu_torch", "native",
                              "colmap_native.cpp")
    lib = loader._lib_path()
    assert lib.parent == loader.BUILD
    assert loader.BUILD.relative_to(ROOT).parts == ("build", "goi_tpu_torch")
    assert lib.exists()


def test_native_points3d_matches_python_and_goi_tpu(sparse_dir):
    path = os.path.join(sparse_dir, "points3D.bin")
    py_xyz, py_rgb, py_err = read_points3d_binary(path)
    xyz, rgb, err = loader.read_points3d_binary_native(path)
    np.testing.assert_allclose(xyz, py_xyz, rtol=1e-6)
    np.testing.assert_array_equal(rgb, py_rgb)
    np.testing.assert_allclose(err, py_err, rtol=1e-6)
    for a, b in zip((xyz, rgb, err), jloader.read_points3d_binary_native(path)):
        np.testing.assert_array_equal(a, b)


def test_native_images_match_python_and_goi_tpu(sparse_dir):
    path = os.path.join(sparse_dir, "images.bin")
    py = read_images_binary(path)
    nat = loader.read_images_binary_native(path)
    jnat = jloader.read_images_binary_native(path)
    assert set(nat) == set(py) == set(jnat)
    for k in py:
        for other in (py[k], jnat[k]):
            np.testing.assert_array_equal(nat[k].qvec, other.qvec)
            np.testing.assert_array_equal(nat[k].tvec, other.tvec)
            assert (nat[k].name, nat[k].camera_id) == (other.name,
                                                       other.camera_id)
