"""goi_tpu_torch monotone_gather (its plain version, on the CPU) against
goi_tpu.raster.gather.monotone_gather (Pallas, interpret mode) on
tests/test_gather.py's four cases: bit-exact."""

import jax.numpy as jnp
import numpy as np
import torch

from goi_tpu.raster import gather as jg
from goi_tpu_torch.raster import gather as tg

torch.set_num_threads(1)


def _dense_monotone_idx(rng, n, m):
    counts = rng.integers(1, 6, n)
    stream = np.repeat(np.arange(n, dtype=np.int32), counts)
    if len(stream) >= m:
        return stream[:m]
    return np.pad(stream, (0, m - len(stream)), mode="edge")


def _both(table, idx, pad=True):
    tp = np.pad(table, ((0, 0), (0, jg.SPAN + 128))) if pad else table
    want = np.asarray(jg.monotone_gather(jnp.asarray(tp), jnp.asarray(idx)))
    got = tg.monotone_gather(torch.as_tensor(tp), torch.as_tensor(idx))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(got.numpy(), table[:, idx])
    return got.numpy()


def test_gather_matches_jax():
    rng = np.random.default_rng(0)
    n, m, c = 700, 3000, 12
    table = rng.normal(0, 1, (c, n)).astype(np.float32)
    _both(table, _dense_monotone_idx(rng, n, m))


def test_gather_bit_exact_on_integer_values():
    rng = np.random.default_rng(3)
    n, m = 1500, 4000
    table = np.stack([
        rng.integers(0, 1 << 23, n).astype(np.float32),
        rng.integers(0, 1024, n).astype(np.float32),
        rng.normal(0, 1, n).astype(np.float32) * 1e-3,
    ])
    idx = _dense_monotone_idx(rng, n, m)
    out = _both(table, idx)
    assert (out[0].astype(np.int32) == table[0, idx].astype(np.int32)).all()


def test_gather_unaligned_sizes():
    rng = np.random.default_rng(1)
    n, m, c = 1100, jg.BLOCK + 137, 7
    table = rng.normal(0, 1, (c, n)).astype(np.float32)
    _both(table, _dense_monotone_idx(rng, n, m))


def test_gather_near_table_end():
    rng = np.random.default_rng(2)
    n, c = jg.SPAN + 200, 5
    table = rng.normal(0, 1, (c, n)).astype(np.float32)
    idx = np.sort(rng.integers(n - 4, n, 2 * jg.BLOCK)).astype(np.int32)
    _both(table, idx, pad=False)


def test_gather_counts_only_kernel_launches():
    before = tg.monotone_gather.launches
    tg.monotone_gather(torch.ones(3, 10), torch.arange(10, dtype=torch.int32))
    assert tg.monotone_gather.launches == before   # CPU: plain version
