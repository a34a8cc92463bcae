"""Driver of the viewer cell.

One viewer orbits a queried scene: each frame is the call the query
app's /frame handler makes, QuerySession.render_view(cam, mode="image",
overlay=True, as_u8=True) with the camera of viewer/web.py's
orbit_view_camera, along the cell's seeded orbit path, with the APE
overlay of a seeded text embedding. The loop is closed, as the port's
viewers run it: one frame in flight, the next asked for as soon as the
last has come back, each frame timed from the request to the uint8
frame on the host, until the frame that ends past the window's close.
With --trace the profiler covers `profile_frames` frames of the window.
Once the window has closed, the plain reference renders a seeded
sample of the served frames (the last always in) from the same inputs
and the frames are compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs, program
from portbench.reference import orbit as ref_orbit
from portbench.reference import raster as ref_raster
from portbench.reference import semantic as ref_semantic
from portbench.trace import Profile
from portbench.work import counts

KERNELS = ("gather", "blend_fwd")


def run(*, cell, workload, config, seed, seconds, trace, device, t_start):
    from goi_tpu_torch.app.session import QuerySession
    from goi_tpu_torch.raster.render import RasterConfig, suggest_budgets
    from goi_tpu_torch.semantic.codebook import SemanticDecoder
    from goi_tpu_torch.viewer.web import orbit_view_camera
    traffic = workload["params"]
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    marks = [("start", t_start), ("imports", time.perf_counter())]
    program.build_kernels(KERNELS, device)
    marks.append(("build", time.perf_counter()))
    raw = inputs.make_scene(config["scene"], seed, device)
    protos = inputs.prototypes(config["maps"], seed, device)
    spec = dict(traffic["query"], dim_in=config["scene"]["sem_dim"],
                tab_len=config["codebook"]["tab_len"])
    weight, bias, lut, text = inputs.query_model(spec, protos, seed, device)
    path = inputs.orbit_path(traffic["path"], seed)
    fovy = traffic["fovy_deg"]
    scene = program.scene(raw)
    program.sync(device)
    marks.append(("inputs", time.perf_counter()))
    budget, _ = suggest_budgets(
        scene, [orbit_view_camera(q, fovy, device) for q in path])
    sess = QuerySession(scene, SemanticDecoder([weight.clone()],
                                               [bias.clone()]),
                        lut.clone(), RasterConfig(max_instances=budget),
                        sim_thresh=traffic["sim_thresh"],
                        white_background=True, device=device)
    sess.set_text(text.clone())

    def frame(i):
        return sess.render_view(orbit_view_camera(path[i % len(path)], fovy,
                                                  sess.device),
                                mode="image", overlay=True, as_u8=True)

    marks.append(("budget and session", time.perf_counter()))
    for i in range(traffic["warmup_frames"]):
        frame(i)
    keep = inputs.Reservoir(seed, traffic["compared_frames"])
    prof = Profile(device) if trace else None
    p_lo = traffic["profile_after"]
    p_hi = p_lo + traffic["profile_frames"]
    latency = []
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        i = len(latency)
        if prof is not None and i == p_lo:
            prof.start()
        ts = time.perf_counter()
        img = frame(i)
        te = time.perf_counter()
        if prof is not None and i == p_hi - 1:
            prof.stop(traffic["profile_frames"])
        latency.append(te - ts)
        keep.offer(i, img)
        if te >= end and (prof is None or i >= p_hi - 1):
            break
    t1 = time.perf_counter()
    setup_s = t0 - t_start
    marks.append(("warm-up frames", t0))
    print(f"[portbench] {cell}: set-up {program.phases(marks)}", flush=True)
    total = len(latency)
    kept = keep.items()
    lat_ms = np.asarray(latency) * 1e3
    p95 = float(np.percentile(lat_ms, 95))
    dev_info = program.device_info(device, 1)
    print(f"[portbench] {cell}: {total} frames in {t1 - t0:.3f} s "
          f"({len(path)}-frame path, budget {budget}); latency p50 "
          f"{np.percentile(lat_ms, 50):.3f} p95 {p95:.3f} max "
          f"{lat_ms.max():.3f} mean {lat_ms.mean():.3f} ms; set-up "
          f"{setup_s:.3f} s; peak {dev_info['memory_peak_bytes']} B",
          flush=True)
    quarters = [f"{np.percentile(q, 50):.2f}/{np.percentile(q, 95):.2f}"
                for q in np.array_split(lat_ms, 4) if q.size]
    print(f"[portbench] {cell}: latency p50/p95 by quarter of the window "
          f"{quarters} ms", flush=True)
    # the frames' mean time outside the profiled ones
    plain = np.delete(lat_ms, np.arange(p_lo, p_hi)) if trace else lat_ms
    readings = {"frame_ms": float(plain.mean()), "frames": total}
    profile = None
    if trace:
        profile = prof.result()
        readings["profile"] = profile
    del sess, scene
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    refs, work = [], []
    bg = torch.ones(3, device=device)
    for i in sorted(kept):
        view = ref_orbit.viewer_camera(path[i % len(path)], fovy)
        sp = ref_raster.preprocess(raw, view)
        out = ref_raster.render(sp, ref_raster.tile_lists(sp), bg=bg)
        refs.append(ref_semantic.query_frame(
            out["render"], out["semantics"], weight, bias, lut, text,
            thresh=traffic["sim_thresh"]))
    numbers = program.frame_numbers([kept[i] for i in sorted(kept)], refs,
                                    traffic["levels"])
    if trace:
        seen = {}
        for i in range(p_lo, p_hi):
            j = i % len(path)
            if j not in seen:
                view = ref_orbit.viewer_camera(path[j], fovy)
                sp = ref_raster.preprocess(raw, view)
                seen[j] = ref_raster.blended_pairs(
                    sp, ref_raster.tile_lists(sp))
            work.append(seen[j])
        readings["work"] = counts.query_frame(
            config, ref_orbit.viewer_camera(path[0], fovy), work)
    checks, ok = program.checks(numbers, workload["limits"])
    return {"correct": ok, "attempted": total,
            "failed": 0 if ok else len(kept),
            "e2e": {"query_frame_ms.p95": p95, "setup_s": setup_s},
            "readings": readings, "profile": profile, "device": dev_info,
            "checks": checks}
