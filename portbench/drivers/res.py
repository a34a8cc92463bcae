"""Driver of the RES cell.

One user refines an open-vocabulary query with the viewer's "RES
finetune": each request is what the query app's finetune op does up to
the hyperplane fit (viewer/app.py), QuerySession.render_view(cam,
overlay=False) of the current view, then TorchRESProvider.predict_mask
(GroundingDINO boxes, SAM box-prompted masks, the two re-rank cutoffs,
the union) to the boolean mask on the host, under the port's unit span
res.request. The requests walk the cell's seeded orbit view by view,
the prompts in turn from a seeded list of phrases of the
configuration's synthetic vocabulary. The loop is closed: the next
request is made when the last mask is back, each timed from the call to
the mask on the host, until the request that ends past the window's
close. The towers' weights are drawn on the device from the seed under
the official checkpoints' key names by the configuration's rule
(`gdino_init`, `sam_init`) and loaded into the port. The box threshold
is fixed once at set-up, midway between the detector's
`boxes_at_setup`-th and next score on the orbit's first view and
prompt, and holds for every request. With --trace the profiler covers
`profile_requests` requests of the window. Once the window has closed,
the plain reference (portbench/reference/towers.py) reruns a seeded
sample of the requests (the last always in) from the same view, prompt
and weights, and the port's outputs for them are compared with its.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from portbench import inputs, program
from portbench.reference import towers as ref_towers
from portbench.trace import Profile
from portbench.work import towers as work_towers

KERNELS = ("gather", "blend_fwd")
# the cell's own streams of the seed (portbench.inputs' formula)
STREAMS = {"towers": 7, "prompts": 8}


def stream_seed(seed: int, name: str) -> int:
    return (int(seed) * 1_000_003 + STREAMS[name] * 7919) % (2 ** 63 - 1)


def port_configs(config: dict) -> tuple:
    """The port's GroundingConfig and SAMConfig of the configuration's
    published widths and input rule."""
    from goi_tpu_torch.query.bert import BertConfig
    from goi_tpu_torch.query.grounding import GroundingConfig
    from goi_tpu_torch.query.sam import SAMConfig
    from goi_tpu_torch.query.swin import SwinConfig
    g, s = config["gdino"], config["sam"]
    sw, b = g["swin"], g["bert"]
    gcfg = GroundingConfig(
        d_model=g["hidden_dim"], heads=g["nheads"],
        enc_layers=g["enc_layers"], dec_layers=g["dec_layers"],
        ffn=g["dim_feedforward"], n_points=g["enc_n_points"],
        num_queries=g["num_queries"], max_text_len=g["max_text_len"],
        text_pad=g["text_pad"], img_size=g["input"]["size"],
        max_size=g["input"]["max_size"],
        pe_temperature=g["pe_temperatureH"],
        swin=SwinConfig(embed_dim=sw["embed_dim"],
                        depths=tuple(sw["depths"]),
                        num_heads=tuple(sw["num_heads"]),
                        window=sw["window_size"],
                        out_indices=tuple(sw["out_indices"]),
                        mlp_ratio=sw["mlp_ratio"]),
        bert=BertConfig(vocab_size=b["vocab_size"], hidden=b["hidden_size"],
                        layers=b["num_hidden_layers"],
                        heads=b["num_attention_heads"],
                        intermediate=b["intermediate_size"],
                        max_position=b["max_position_embeddings"],
                        type_vocab=b["type_vocab_size"]))
    if gcfg.levels != g["num_feature_levels"] \
            or g["dec_n_points"] != g["enc_n_points"]:
        raise ValueError("levels or points the port's GroundingConfig "
                         "cannot express")
    scfg = SAMConfig(
        embed_dim=s["encoder_embed_dim"], depth=s["encoder_depth"],
        num_heads=s["encoder_num_heads"],
        global_attn=tuple(s["encoder_global_attn_indexes"]),
        window=s["window_size"], img_size=s["image_size"],
        patch=s["vit_patch_size"], prompt_dim=s["prompt_embed_dim"],
        mask_in_chans=s["mask_in_chans"], decoder_depth=s["decoder_depth"],
        decoder_heads=s["decoder_heads"], decoder_mlp=s["decoder_mlp_dim"],
        num_multimask=s["num_multimask_outputs"])
    return gcfg, scfg


def prompts(spec: dict, words: list, seed: int) -> list:
    """`n` phrases of `lengths[0]`-`lengths[1]` words of the vocabulary,
    drawn from the seed."""
    rng = np.random.default_rng(stream_seed(seed, "prompts"))
    lo, hi = spec["lengths"]
    return [" ".join(rng.choice(words, int(rng.integers(lo, hi + 1))))
            for _ in range(spec["n"])]


def _randn(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device) * std


def _fan_in(shape) -> int:
    """A matrix's input width, a convolution's fan (all but the first
    dim)."""
    return max(shape[-1] if len(shape) == 2 else math.prod(shape[1:]), 1)


def dino_rule(init: dict):
    """GroundingDINO's draw: biases 0, norms 1, the fusion layers'
    layer-scale gammas 1e-4 (BiAttentionBlock's init_values), other
    vectors N(0, 0.02), matrices and convolutions N(0, 1 / fan-in); the
    configuration's `init` sets the decoder's final norm scale, the
    query content embedding's std and a scale on the decoder layers'
    attention output projections."""
    attn_out = ("self_attn.out_proj.weight", "ca_text.out_proj.weight",
                "cross_attn.output_proj.weight")

    def rule(name, shape, gen):
        if name.endswith(".bias") or "gamma" in name:
            return torch.full(shape, 1e-4 if "gamma" in name else 0.0)
        if name == "transformer.decoder.norm.weight":
            return torch.full(shape, init["decoder_norm_scale"])
        if "norm" in name.lower() and len(shape) == 1:
            return torch.ones(shape)
        if len(shape) == 1:
            return _randn(shape, 0.02, gen)
        if name == "transformer.tgt_embed.weight":
            return _randn(shape, init["tgt_embed_std"], gen)
        std = _fan_in(shape) ** -0.5
        if name.startswith("transformer.decoder.layers.") \
                and name.endswith(attn_out):
            std *= init["decoder_attn_out_scale"]
        return _randn(shape, std, gen)
    return rule


def sam_rule(name, shape, gen):
    """SAM's draw: biases 0, norms 1 (the neck's LayerNorm2d at .1 and
    .3), the position embedding and relative-position tables N(0, 0.02),
    matrices and convolutions N(0, 1 / fan-in)."""
    if name.endswith(".bias") or "norm" in name or ".neck.1" in name \
            or ".neck.3" in name:
        return torch.zeros(shape) if name.endswith("bias") \
            else torch.ones(shape)
    if name.endswith("pos_embed") or "rel_pos" in name:
        return _randn(shape, 0.02, gen)
    return _randn(shape, _fan_in(shape) ** -0.5, gen)


@torch.no_grad()
def draw(model: torch.nn.Module, rule, gen: torch.Generator) -> dict:
    """Draw the model's weights by `rule` from `gen` (name by name in
    sorted order, on the generator's device), load them into the model
    and return them as a state dict under the official checkpoint's key
    names, a shared module's weights under each of its names. The
    model's buffers (rebuilt index tables) are its own."""
    params = dict(model.named_parameters())
    drawn = {id(params[n]): rule(n, tuple(params[n].shape), gen).to(
        gen.device) for n in sorted(params)}
    sd = {k: drawn[id(v)]
          for k, v in model.state_dict(keep_vars=True).items()
          if isinstance(v, torch.nn.Parameter)}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected or set(missing) - {n for n, _ in model.named_buffers()}:
        raise RuntimeError(f"weights not drawn: {missing} {unexpected}")
    return sd


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    """The cell's objects: the seeded scene in a QuerySession, the orbit,
    the prompts, the towers' weights drawn on the device from the seed
    and loaded into the port behind TorchRESProvider, and its box
    threshold set on the orbit's first view and prompt."""
    from goi_tpu_torch.app.session import QuerySession
    from goi_tpu_torch.query.bert import BertTokenizer, make_test_vocab
    from goi_tpu_torch.query.grounding import (GroundingDINO,
                                               GroundingDINOTorch)
    from goi_tpu_torch.query.res import TorchRESProvider
    from goi_tpu_torch.query.sam import SAM, SamTorch
    from goi_tpu_torch.raster.render import RasterConfig, suggest_budgets
    from goi_tpu_torch.semantic.codebook import SemanticDecoder
    from goi_tpu_torch.viewer.web import orbit_view_camera
    gcfg, scfg = port_configs(config)
    raw = inputs.make_scene(config["scene"], seed, device)
    protos = inputs.prototypes(config["maps"], seed, device)
    spec = dict(traffic["query"], dim_in=config["scene"]["sem_dim"],
                tab_len=config["codebook"]["tab_len"])
    weight, bias, lut, _ = inputs.query_model(spec, protos, seed, device)
    path = inputs.orbit_path(traffic["path"], seed)
    fovy = traffic["fovy_deg"]
    scene = program.scene(raw)
    budget, _ = suggest_budgets(
        scene, [orbit_view_camera(q, fovy, device) for q in path])
    sess = QuerySession(scene, SemanticDecoder([weight], [bias]), lut,
                        RasterConfig(max_instances=budget),
                        white_background=True, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "towers"))
    dino = GroundingDINO(gcfg, device=device)
    dino_sd = draw(dino, dino_rule(config["gdino_init"]), gen)
    sam = SAM(scfg, device=device)
    sam_sd = draw(sam, sam_rule, gen)
    vocab = make_test_vocab(config["text"]["words"])
    det = GroundingDINOTorch(dino, BertTokenizer(vocab))
    predictor = SamTorch(sam)
    phrases = prompts(traffic["prompts"], config["text"]["words"], seed)
    prov = TorchRESProvider(det, predictor,
                            text_threshold=config["gdino"]["text_threshold"])
    c = {"sess": sess, "path": path, "fovy": fovy, "det": det,
         "predictor": predictor, "prov": prov, "vocab": vocab,
         "phrases": phrases, "dino_sd": dino_sd, "sam_sd": sam_sd}
    k = traffic["boxes_at_setup"]
    cam, phrase = ask(c, 0)
    _, scores, _ = det.predict(sess.render_view(cam, overlay=False), phrase,
                               box_threshold=0.0)
    sc = np.sort(scores)[::-1]
    if not sc[k - 1] > sc[k]:
        raise RuntimeError(f"detector scores tie at {k}: {sc[:k + 1]}")
    prov.box_threshold = float(sc[k - 1] + sc[k]) / 2
    return c


def ask(c: dict, i: int):
    """The i-th request's camera and prompt: the orbit's i-th view, the
    prompts in turn."""
    from goi_tpu_torch.viewer.web import orbit_view_camera
    path, phrases = c["path"], c["phrases"]
    return orbit_view_camera(path[i % len(path)], c["fovy"],
                             c["sess"].device), phrases[i % len(phrases)]


def request(c: dict, i: int):
    """The i-th request: (the rendered view, the mask or None)."""
    from goi_tpu_torch.utils.profiling import span
    cam, prompt = ask(c, i)
    with span("res.request"):
        img = c["sess"].render_view(cam, overlay=False)
        return img, c["prov"].predict_mask(img, prompt)


@contextlib.contextmanager
def captured(c: dict, order=None):
    """The port's detector outputs, its own selection, image embedding
    and the boxes it hands SAM, for the predict_mask calls in the block.
    Where its own top-k of the same tokens holds the queries in another
    order than `order` (near-equal scores swapped), the decoder takes
    `order`: the slots' query embeddings follow the order."""
    det, predictor = c["det"], c["predictor"]
    cap = {}
    select, predict_boxes = det.model.select, predictor.predict_boxes

    def select_(enc):
        cap["sel"] = sel = select(enc)
        if order is not None and order.shape == sel["topk_idx"].shape \
                and int(order.max()) < sel["score"].shape[1] \
                and not torch.equal(order, sel["topk_idx"]):
            sel = dict(sel, topk_idx=order)
        return sel

    def boxes_(boxes, multimask=False):
        cap["xyxy"] = np.asarray(boxes)
        return predict_boxes(boxes, multimask)

    hook = det.model.register_forward_hook(
        lambda m, a, out: cap.__setitem__("out", out))
    det.model.select, predictor.predict_boxes = select_, boxes_
    try:
        yield cap
    finally:
        hook.remove()
        del det.model.select, predictor.predict_boxes


def _gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def gaps(p: dict, r: dict) -> dict:
    """The cell's numbers of a request, `p` against the reference's `r`
    (reference.towers.res_request): the detector's logits over the
    finite ones and the selection's sorted top-k scores (`top`), its
    boxes, SAM's embedding, the share of the union mask's pixels that
    differ where the reference's logit is clear of 0 (each of `p`'s
    masks), and whether the same queries reached SAM (0: the same)."""
    fin = torch.isfinite(r["pred_logits"])
    logit = float("inf")
    if torch.equal(fin, torch.isfinite(p["pred_logits"])):
        top = r["score"].topk(p["top"].shape[1]).values
        logit = max(_gap(p["pred_logits"][fin], r["pred_logits"][fin]),
                    _gap(p["top"], top))
    mism = 0.0
    for m in p["masks"]:
        if (m is None) != (r["mask"] is None):
            mism = 1.0
        elif m is not None:
            sure = r["mask_logit"].abs() > 1e-2
            diff = torch.as_tensor(m, device=sure.device) != r["mask"]
            mism = max(mism, float((diff & sure).sum() / sure.sum()))
    same = np.array_equal(p["keep"], r["keep"]) and p["to_sam"] == len(
        p["keep"])
    return {"dino_logit_gap": logit,
            "dino_box_gap": float((p["pred_boxes"]
                                   - r["pred_boxes"]).abs().max()),
            "sam_embed_gap": _gap(p["embedding"], r["embedding"]),
            "mask_mismatch": mism,
            "boxes_equal": 0.0 if same else 1.0}


def reference(c: dict, config: dict, img, i: int, select=None) -> dict:
    """The plain reference's i-th request on the view `img`, from the
    drawn weights; `select` decodes that selection in place of the
    reference's own top-k."""
    _, prompt = ask(c, i)
    return ref_towers.res_request(
        c["dino_sd"], config["gdino"], c["sam_sd"], config["sam"],
        c["vocab"], img, prompt, c["prov"].box_threshold, select=select)


def compare(c: dict, config: dict, img: np.ndarray, i: int, mask,
            port_fault=contextlib.nullcontext) -> dict:
    """The port's i-th request on its view `img` against the plain
    reference's, which selects its own queries: the numbers of the
    cell's checks. The port's selection is held to the reference's by
    the sorted top-k scores; the port reruns the request under
    `port_fault` with its outputs captured, its decoder taking the
    reference's order of the same queries where near-equal scores
    swapped two. `mask` is the port's mask of the window (or None),
    compared too where the port's own order was the reference's."""
    predictor = c["predictor"]
    _, prompt = ask(c, i)
    r = reference(c, config, img, i)
    with port_fault(), captured(c, r["topk_idx"]) as cap:
        again = c["prov"].predict_mask(img, prompt)
        if "xyxy" not in cap:        # no box reached SAM
            predictor.set_image(img)
        emb = predictor._emb
    out, own = cap["out"], cap["sel"]
    raw = out["pred_logits"][0].float().cpu().numpy()
    with np.errstate(over="ignore"):
        keep = np.nonzero((1.0 / (1.0 + np.exp(-raw))).max(-1)
                          > c["prov"].box_threshold)[0]
    nq = own["topk_idx"].shape[1]
    same_order = torch.equal(own["topk_idx"], r["topk_idx"])
    if not same_order and own["topk_idx"].shape == r["topk_idx"].shape:
        print(f"[portbench] request {i}: the reference's top-{nq} puts "
              f"{int((own['topk_idx'] != r['topk_idx']).sum())} queries "
              f"in other places; the port's rerun decodes in its order",
              flush=True)
    p = {"pred_logits": out["pred_logits"], "pred_boxes": out["pred_boxes"],
         "top": own["score"].topk(nq).values, "embedding": emb,
         "keep": keep, "to_sam": len(cap.get("xyxy", ())),
         "masks": (mask, again) if same_order else (again,)}
    return gaps(p, r)


def worst(rows: list) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def run(*, cell, workload, config, seed, seconds, trace, device, t_start):
    traffic = workload["params"]
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    marks = [("start", t_start), ("imports", time.perf_counter())]
    program.build_kernels(KERNELS, device)
    marks.append(("build", time.perf_counter()))
    c = setup(config, traffic, seed, device)
    program.sync(device)
    marks.append(("scene, session, towers, threshold", time.perf_counter()))
    for i in range(traffic["warmup_requests"]):
        request(c, i)
    keep = inputs.Reservoir(seed, traffic["compared_requests"])
    prof = Profile(device) if trace else None
    p_lo = traffic["profile_after"]
    p_hi = p_lo + traffic["profile_requests"]
    latency, empty = [], 0
    first = traffic["warmup_requests"]
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        j = len(latency)
        i = first + j                     # the orbit goes on from warm-up
        if prof is not None and j == p_lo:
            prof.start()
        ts = time.perf_counter()
        img, mask = request(c, i)
        te = time.perf_counter()
        if prof is not None and j == p_hi - 1:
            prof.stop(traffic["profile_requests"])
        latency.append(te - ts)
        empty += mask is None
        keep.offer(i, (img, mask))
        if te >= end and (prof is None or j >= p_hi - 1):
            break
    t1 = time.perf_counter()
    setup_s = t0 - t_start
    marks.append(("warm-up requests", t0))
    print(f"[portbench] {cell}: set-up {program.phases(marks)}", flush=True)
    total = len(latency)
    lat_ms = np.asarray(latency) * 1e3
    p95 = float(np.percentile(lat_ms, 95))
    dev_info = program.device_info(device, 1)
    h, w = keep.items()[max(keep.items())][0].shape[:2]
    print(f"[portbench] {cell}: {total} requests in {t1 - t0:.3f} s, "
          f"{empty} without a mask ({h}x{w} views, box threshold "
          f"{c['prov'].box_threshold!r}, prompts {c['phrases']}); latency p50 "
          f"{np.percentile(lat_ms, 50):.3f} p95 {p95:.3f} max "
          f"{lat_ms.max():.3f} mean {lat_ms.mean():.3f} ms; set-up "
          f"{setup_s:.3f} s; peak {dev_info['memory_peak_bytes']} B",
          flush=True)
    plain = np.delete(lat_ms, np.arange(p_lo, p_hi)) if trace else lat_ms
    readings = {"request_ms": float(plain.mean()), "requests": total,
                "work": work_towers.request(config, h, w)}
    profile = None
    if trace:
        profile = prof.result()
        readings["profile"] = profile

    rows = []
    for i, (img, mask) in sorted(keep.items().items()):
        rows.append(compare(c, config, img, i, mask))
    numbers = worst(rows)
    checks, ok = program.checks(numbers, workload["limits"])
    return {"correct": ok, "attempted": total,
            "failed": empty + (0 if ok else len(rows)),
            "e2e": {"request_ms.p95": p95, "setup_s": setup_s},
            "readings": readings, "profile": profile, "device": dev_info,
            "checks": checks}
