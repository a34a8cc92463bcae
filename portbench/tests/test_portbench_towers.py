"""The RES cell towers.res on the CPU at tiny towers: a traced run through
run_cell is correct and reads every towers metric; the parent's square
squash of the detector's input is caught by the comparison; the cell's
files are the ones the harness reads, at the published widths."""

import importlib.util
import json
import math
from pathlib import Path

import pytest

import portbench.run as run

ROOT = Path(__file__).resolve().parents[2]
SEED = 2_718_281_828_459
CELL = "towers.res"
# GroundingDINO and SAM at the port's test widths, under the published
# names the cell's configuration uses
GDINO_TINY = {
    "hidden_dim": 32, "nheads": 4, "enc_layers": 2, "dec_layers": 2,
    "dim_feedforward": 64, "enc_n_points": 4, "dec_n_points": 4,
    "num_queries": 20, "num_feature_levels": 3, "max_text_len": 40,
    "pe_temperatureH": 20, "pe_temperatureW": 20,
    "input": {"size": 64, "max_size": 1333}, "text_pad": 16,
    "text_threshold": 0.25,
    "swin": {"embed_dim": 8, "depths": [2, 2], "num_heads": [2, 2],
             "window_size": 4, "out_indices": [0, 1], "mlp_ratio": 4.0},
    "bert": {"vocab_size": 64, "hidden_size": 16, "num_hidden_layers": 2,
             "num_attention_heads": 2, "intermediate_size": 32,
             "max_position_embeddings": 64, "type_vocab_size": 2,
             "layer_norm_eps": 1e-12}}
SAM_TINY = {
    "encoder_embed_dim": 32, "encoder_depth": 2, "encoder_num_heads": 2,
    "encoder_global_attn_indexes": [1], "window_size": 3,
    "image_size": 64, "vit_patch_size": 8, "prompt_embed_dim": 16,
    "mask_in_chans": 4, "decoder_depth": 2, "decoder_heads": 2,
    "decoder_mlp_dim": 32, "num_multimask_outputs": 3}
TINY = {"config": {"gdino": GDINO_TINY, "sam": SAM_TINY,
                   "scene": {"n_gaussians": 3000}},
        "workload": {"params": {
            "path": {"period": 12, "radius": 4.5, "elev": -15.0,
                     "elev_amp": 10.0, "width": 96, "height": 64},
            "warmup_requests": 1, "profile_after": 1,
            "profile_requests": 2, "compared_requests": 2,
            "boxes_at_setup": 3},
            # the tiny detector with the cell's drawn weights carries float32
            # rounding (~1e-7 a layer) to ~1e-3 in its logits and ~2e-4 in
            # its boxes (float64 on both sides: ~2e-6), far more than the
            # published widths do: limits of its own, still three orders
            # under the squash's ~1 and ~0.8
            "limits": {"dino_logit_gap": 1e-2, "dino_box_gap": 2e-3}}}


def towers_metrics(device_trace=True):
    """The cell's per-layer metrics (on the CPU the profiler records no
    device time: `device_trace=False` leaves those out)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [m["name"] for m in bench["per_layer"]
            if CELL in m.get("workloads", [])
            and (device_trace or m["source"] != "device_trace")]


def tiny(trace):
    from goi_tpu_torch.utils import profiling
    profiling.reset()
    return run.run_cell(CELL, SEED, 0.5, trace, device="cpu",
                        overrides=json.loads(json.dumps(TINY)))


def test_traced_tiny_run_is_correct_and_reads_every_metric():
    res = tiny(True)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 3 and res["failed"] == 0
    assert set(res["checks"]) == {"dino_logit_gap", "dino_box_gap",
                                  "sam_embed_gap", "mask_mismatch",
                                  "boxes_equal"}
    m = res["metrics"]
    for name in towers_metrics(device_trace=False):
        assert name in m and math.isfinite(m[name]["value"]), name
    assert m["towers.res.deform_ms"]["value"] \
        <= m["towers.res.dino_encoder_ms"]["value"] \
        + m["towers.res.dino_decoder_ms"]["value"]
    # the first view's threshold lets boxes through on the profiled views
    assert m["towers.res.boxes_per_request"]["value"] > 0
    assert 0 < m["towers.res_mfu"]["value"]


def driver():
    spec = importlib.util.spec_from_file_location(
        "res_driver", ROOT / "portbench" / "drivers" / "res.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_one_threshold_from_the_first_view_and_drawn_weights():
    """Set-up fixes one box threshold, between the 3rd and 4th score of
    the orbit's first view and prompt; the requests walk the orbit with
    the prompts in turn and leave it alone. The towers' weights are the
    benchmark's draw, loaded into the port under the official names."""
    import torch
    drv = driver()
    wl, cfg = run.load_cell(CELL)
    for key, part in TINY.items():
        target = cfg if key == "config" else wl
        for k, v in part.items():
            target[k] = dict(target[k], **v) if isinstance(v, dict) \
                and isinstance(target.get(k), dict) else v
    c = drv.setup(cfg, wl["params"], SEED, "cpu")
    thresh = c["prov"].box_threshold
    cam, prompt = drv.ask(c, 0)
    img = c["sess"].render_view(cam, overlay=False)
    boxes, _, _ = c["det"].predict(img, prompt, thresh)
    assert len(boxes) == 3
    n, k = len(c["path"]), len(c["phrases"])
    assert (n, k) == (12, 8)
    for i in (1, 7, 12, 13, 29):
        cam, prompt = drv.ask(c, i)
        assert prompt == c["phrases"][i % k]
        assert torch.equal(cam.world_view, drv.ask(c, i % n)[0].world_view)
    assert c["prov"].box_threshold == thresh
    port = c["det"].model.state_dict()
    assert "transformer.tgt_embed.weight" in c["dino_sd"]
    for name, w in c["dino_sd"].items():
        assert torch.equal(port[name], w), name
    for name, w in c["sam_sd"].items():
        assert torch.equal(c["predictor"].model.state_dict()[name], w), name
    init = cfg["gdino_init"]
    assert torch.all(c["dino_sd"]["transformer.decoder.norm.weight"]
                     == init["decoder_norm_scale"])
    std = float(c["dino_sd"]["transformer.tgt_embed.weight"].std())
    assert abs(std - init["tgt_embed_std"]) < 0.1


def test_untraced_run_reports_the_cells_end_to_end_metrics():
    res = tiny(False)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"query_frame_ms.p95", "setup_s"}


def test_the_square_squash_is_caught(monkeypatch):
    """The parent's input: the detector's view squashed to its square."""
    from goi_tpu_torch.query.grounding import GroundingDINOTorch
    monkeypatch.setattr(GroundingDINOTorch, "input_hw",
                        lambda self, h, w: (self.cfg.img_size,) * 2)
    res = tiny(False)
    assert not res["correct"]
    assert res["checks"]["dino_logit_gap"]["value"] \
        > res["checks"]["dino_logit_gap"]["limit"]


def test_the_configuration_is_the_published_towers():
    from goi_tpu_torch.query.grounding import GDINO_SWINT
    from goi_tpu_torch.query.sam import SAM_VIT_H
    mod = driver()
    wl, cfg = run.load_cell(CELL)
    assert mod.port_configs(cfg) == (GDINO_SWINT, SAM_VIT_H)
    assert wl["metric_names"] == {"request_ms.p95": "query_frame_ms.p95"}
    e2e, per_layer = run.cell_metrics(CELL, run.load_json(
        ROOT / "BENCHMARK.json"))
    assert {x["name"] for x in e2e} == {"query_frame_ms.p95", "setup_s"}
    assert {x["name"] for x in per_layer} == set(towers_metrics())
    assert len(per_layer) == 12


@pytest.mark.parametrize("hw, tokens", [((960, 1296), 17971),
                                        ((968, 1296), 17821)])
def test_counted_image_tokens(hw, tokens):
    from portbench.work import towers
    cfg = run.load_cell(CELL)[1]
    w = towers.request(cfg, *hw)
    assert w["gdino"]["tokens"] == tokens
    # SAM ViT-H's encoder: 2 x 632M weights x 4096 tokens and more
    assert 5e12 < w["sam_encoder_flops"] < 7e12
