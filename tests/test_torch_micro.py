"""The micro-benchmark's block-windowed monotone row gather
(raster/gather.py `mono_rows`, the mono_rows kernel's plain version on
the CPU) against a numpy model of examples/micro_sortpayload.py
`_mono_kernel`: per block of B indices the window lo = min(idx[b B],
n - SPAN) and a one-hot (B x SPAN) product, so an index past the window
gives a zero row; and the port's micro-benchmark script end to end at a
tiny size on the CPU."""

import json

import numpy as np
import pytest
import torch

from goi_tpu_torch.examples import micro_sortpayload as micro
from goi_tpu_torch.raster import gather

torch.set_num_threads(1)


def mono_model(table, idx, blk, span):
    """_mono_kernel's arithmetic in numpy: the span-row window DMA and the
    one-hot matmul, block by block."""
    n = table.shape[0]
    out = np.zeros((idx.shape[0], table.shape[1]), np.float64)
    for b0 in range(0, idx.shape[0], blk):
        ib = idx[b0:b0 + blk]
        lo = min(ib[0], n - span)
        onehot = (ib[:, None] - lo) == np.arange(span)[None, :]
        out[b0:b0 + blk] = onehot @ table[lo:lo + span].astype(np.float64)
    return out.astype(np.float32)


@pytest.mark.parametrize("n,m,blk,span,jump", [
    (4000, 4096, 1024, 2048, False),   # the script's B and SPAN
    (300, 96, 8, 16, True),            # small windows: indices leave them
])
def test_mono_rows_plain_matches_onehot_model(n, m, blk, span, jump):
    rng = np.random.default_rng(n)
    idx = np.sort(rng.integers(0, n, m)).astype(np.int32)
    if jump:
        # a jump inside a block (its window starts at the block's first
        # index), and a block whose window is pinned at n - span
        idx[16:24] = np.sort(idx[16:24])
        idx[20:24] = idx[16] + span + np.arange(4)
        idx[16:] = np.maximum.accumulate(idx[16:])
        idx[-8:] = n - span - 2 + np.arange(8)
        idx = np.minimum(np.maximum.accumulate(idx), n - 1)
    table = rng.normal(0, 1, (n, 24)).astype(np.float32)
    want = mono_model(table, idx, blk, span)
    got = gather.mono_rows(torch.as_tensor(table), torch.as_tensor(idx),
                           blk, span).numpy()
    assert got.shape == (m, 24)
    np.testing.assert_array_equal(got, want)
    zero = ~want.any(axis=1)
    if jump:
        assert zero.any() and not zero.all()
        assert not got[zero].any()
    else:   # every index within its window: table[idx] itself
        np.testing.assert_array_equal(got, table[idx])


def test_micro_benchmark_runs_on_cpu(capsys):
    before = gather.mono_rows.launches
    out = micro.run(m=4096, n=3000, iters=1, device="cpu")
    keys = ["sort_2key_4ops_ms", "sort_2key_8ops_ms", "sort_2key_16ops_ms",
            "sort_2key_28ops_ms", "pack_gather_24col_ms",
            "mono_blockdiag_24col_ms"]
    assert [k for k in out if k.endswith("_ms")] == keys
    assert out["device"] == "cpu" and out["m"] == 4096
    assert all(out[k] > 0 for k in keys)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [next(iter(x)) for x in lines] == keys
    assert gather.mono_rows.launches == before   # plain version: no launch
    only = micro.run(m=2048, n=2500, iters=1, device="cpu", only=["mono"])
    assert list(only) == ["m", "n", "device", "mono_blockdiag_24col_ms"]


def test_micro_sort_step_is_a_stable_two_key_sort():
    """The composite key orders by (tile, depth) and keeps ties stable,
    the payload riding the permutation, as the JAX script's 2-key
    lax.sort does."""
    x = micro.make_inputs(2048, 1500, "cpu")
    step = micro.steps(x, 1500)["sort_2key_4ops_ms"]
    got = step(x["tile0"], 0).numpy()
    t, d = x["tile0"].numpy(), x["depth"].numpy()
    order = np.lexsort((np.arange(2048), d, t))
    want = t[order].astype(np.int64)
    for p in x["payload_f"][:2]:
        want = want + p.numpy()[order].astype(np.int32)
    np.testing.assert_array_equal(got, want)

