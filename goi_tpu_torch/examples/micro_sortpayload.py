"""How does a stable 2-key sort's cost on the card scale with its payload
count, and what do two 24-column row gathers at instance scale cost?

Counterpart of examples/micro_sortpayload.py (the JAX package's
micro-benchmark), with the same inputs from the same numpy seed and the
same JSON keys:

- sort_2key_{4,8,16,28}ops_ms: a stable sort on (tile, depth) carrying
  2, 6, 14 or 26 float payloads; here one int64 composite key (tile in
  the high 32 bits, depth in the low) and the payloads gathered by the
  sort's permutation;
- pack_gather_24col_ms: a random row gather of an (n, 24) table at
  instance scale (the blend's pack);
- mono_blockdiag_24col_ms: the same rows gathered by a sorted index
  through the hand-written block-windowed kernel
  (raster/gather.py `mono_rows`, csrc/mono_rows.cu).

Each step depends on the last through a carried int32 vector, as in the
JAX script's fori_loop; a figure is the mean over `--iters` steps timed
with CUDA events after one warm-up run.

    python -m goi_tpu_torch.examples.micro_sortpayload [--m M] [--n N]
        [--iters I] [--device cuda|cpu] [sort4|sort28|pack|mono ...]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from goi_tpu_torch.raster.gather import mono_rows

DEFAULT_M = 2_461_696   # instances (the JAX script's --m)
DEFAULT_N = 1_000_000   # table rows (its --n)
N_PAYLOADS = {"sort_2key_4ops_ms": 2, "sort_2key_8ops_ms": 6,
              "sort_2key_16ops_ms": 14, "sort_2key_28ops_ms": 26}


def make_inputs(m: int, n: int, device) -> dict:
    """The JAX script's inputs, drawn in its order from seed 0."""
    rng = np.random.default_rng(0)
    tile0 = rng.integers(0, 1025, m).astype(np.int32)
    depth = rng.integers(0, 2 ** 22, m).astype(np.int32)
    payload_f = [rng.normal(0, 1, m).astype(np.float32) for _ in range(26)]
    table = rng.normal(0, 1, (n, 24)).astype(np.float32)
    gid_rand = rng.integers(0, n, m).astype(np.int32)
    gstream = np.sort(rng.integers(0, n, m).astype(np.int32))

    def t(a):
        return torch.as_tensor(a, device=device)

    return dict(tile0=t(tile0), depth=t(depth),
                payload_f=[t(p) for p in payload_f], table=t(table),
                gid_rand=t(gid_rand), gstream=t(gstream))


def steps(x: dict, n: int) -> dict:
    """name -> step(c, i), each returning the next carried int32 vector."""
    depth64 = x["depth"].long()

    def sort_with(n_payload):
        def fn(c, i):
            key = ((c ^ (i & 1023)).long() << 32) | depth64
            key_sorted, perm = torch.sort(key, stable=True)
            acc = (key_sorted >> 32).to(torch.int32)
            for p in x["payload_f"][:n_payload]:
                acc = acc + p[perm].to(torch.int32)
            return acc
        return fn

    def pack_gather(c, i):
        g = torch.clamp(x["gid_rand"] ^ (i & 7), 0, n - 1)
        return c + x["table"][g.long()][:, 0].to(torch.int32)

    def mono(c, i):
        # shift the indices by a carried 0 or 1: still monotone, new
        # addresses, no re-sort
        idx = torch.clamp(x["gstream"] + (c[0] & 1), max=n - 1)
        return c + mono_rows(x["table"], idx)[:, 0].to(torch.int32)

    out = {name: sort_with(k) for name, k in N_PAYLOADS.items()}
    out["pack_gather_24col_ms"] = pack_gather
    out["mono_blockdiag_24col_ms"] = mono
    return out


def timed(step, init, iters: int, device) -> float:
    """Mean ms of one step over `iters` carried steps, after a warm-up
    run of the same loop."""
    def loop(c):
        for i in range(iters):
            c = step(c, i)
        return c

    cuda = torch.device(device).type == "cuda"
    c = loop(init)
    if cuda:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        loop(c)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters
    t0 = time.perf_counter()
    loop(c)
    return (time.perf_counter() - t0) * 1e3 / iters


def run(m: int = DEFAULT_M, n: int = DEFAULT_N, iters: int = 20,
        only=(), device="cuda") -> dict:
    """The benchmark's JSON dict; prints each figure as it is taken."""
    x = make_inputs(m, n, device)
    dev = torch.device(device)
    out = {"m": m, "n": n, "device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu"}
    for name, fn in steps(x, n).items():
        if only and not any(o in name for o in only):
            continue
        out[name] = timed(fn, x["tile0"], iters, device)
        print(json.dumps({name: out[name]}), flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=DEFAULT_M)
    ap.add_argument("--n", type=int, default=DEFAULT_N)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("only", nargs="*")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.m, args.n, args.iters, args.only, args.device),
                     indent=1))


if __name__ == "__main__":
    main()
