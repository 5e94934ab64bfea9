"""The in-loop segmentation cells at a tiny size on the CPU, through
``harness.run`` as a run drives them: a sound run of each mode comes out
correct, each fault planted in the program's segmentation comes out not
correct, the control comes out not correct, the plain references import
nothing of the program or of JAX, and the new metric readers read numbers
from a tiny traced slice."""

import ast
import copy
import json
import os
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import tiny_fusion

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
LOOP, SEGMENT = "sdxl-fusion-n3-langsam.bf16-1seed", "sdxl-fusion-n3-langsam.segment"
SEED = 3 * 2**31 + 17
TINY_SAM = dict(image_size=48, vit_patch_size=8, encoder_embed_dim=32, encoder_depth=2,
                encoder_num_heads=2, encoder_global_attn_indexes=[1], window_size=4, mlp_ratio=4,
                prompt_embed_dim=16, transformer_depth=2, transformer_mlp_dim=128,
                transformer_num_heads=2, attention_downsample_rate=2, num_multimask_outputs=3,
                iou_head_depth=3, iou_head_hidden_dim=16, dtype="float32")
TINY_DETECTOR = dict(
    vision_config=dict(image_size=32, patch_size=8, hidden_size=32, intermediate_size=64,
                       num_hidden_layers=2, num_attention_heads=2, hidden_act="quick_gelu",
                       layer_norm_eps=1e-5),
    text_config=dict(vocab_size=1000, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                     num_attention_heads=2, max_position_embeddings=16, hidden_act="quick_gelu",
                     layer_norm_eps=1e-5, eos_token_id=999),
    projection_dim=32, max_boxes=4, box_threshold=0.2, dtype="float32")


def tiny(cell):
    """The cell with tiny SDXL (``tiny.tiny_fusion``'s), SAM and OWL-ViT and
    a 64x64 image."""
    wl, cfg = copy.deepcopy(harness.load_cell(cell))
    _, _, small = tiny_fusion()
    for key in ("unet", "vae", "sampling", "text"):
        cfg[key] = small[key]
    cfg["sam"], cfg["detector"] = dict(TINY_SAM), copy.deepcopy(TINY_DETECTOR)
    wl["image"] = dict(wl.get("image", {}), field=8)
    return wl, cfg


def run_cell(cell, capsys, monkeypatch, trace=False):
    """A whole run of the tiny cell; the launch counters read as the cell
    expects (the CPU runs the kernels' plain versions)."""
    from benchmark.systems.langsam import System

    calls = {"n": 0}

    def counts(self):
        calls["n"] += 1
        want = self.expected_launches()
        return want if calls["n"] % 2 == 0 else {k: 0 for k in want}

    monkeypatch.setattr(System, "launch_counts", counts)
    rc = harness.run(cell, SEED, 0.2, trace, 0.0, device="cpu", chips_check=False, cell_data=tiny(cell))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def padding_excluded(self, x):
    """The port's window attention with the padded tokens masked out as
    keys."""
    from tweediemix_tpu_torch.ops.attention import merge_heads, split_heads
    from tweediemix_tpu_torch.segmentation import sam

    bsz, gh, gw, c = x.shape
    pad = (x == 0).all(dim=-1).reshape(bsz, gh * gw)
    q, k, v = self.qkv(x.reshape(bsz, gh * gw, c)).chunk(3, dim=-1)
    qs, ks, vs = (split_heads(a, self.heads) for a in (q, k, v))
    s = torch.matmul(qs, ks.transpose(1, 2)) * (c // self.heads) ** -0.5
    sam.add_rel_pos_bias_(s, *sam.rel_pos_terms(q, self.rel_pos_h, self.rel_pos_w, gh, gw, self.heads))
    s = s.masked_fill(pad.repeat_interleave(self.heads, 0)[:, None, :], -torch.inf)
    o = merge_heads(torch.matmul(torch.softmax(s, dim=-1), vs), self.heads)
    return self.proj(o).reshape(bsz, gh, gw, c)


def faults():
    """(name, cell, number it must fail, target, attribute, replacement) of
    each planted fault."""
    from tweediemix_tpu_torch.fusion import sampler
    from tweediemix_tpu_torch.fusion.pipeline import TweedieMixPipeline
    from tweediemix_tpu_torch.segmentation import detector, expand, sam

    block_forward = sam.ViTBlock.forward

    def global_windowed(self, x):
        if self.window_size:
            return block_forward(self, x)
        self.window_size = TINY_SAM["window_size"]
        try:
            return block_forward(self, x)
        finally:
            self.window_size = 0

    detect = detector.TextBoxDetector.forward
    preview = TweedieMixPipeline.decode_preview
    build = sampler.build_region_masks
    return [
        ("no rel-pos bias", SEGMENT, "seg_rel", sam, "add_rel_pos_bias_", lambda s, bh, bw: s),
        ("global block windowed", SEGMENT, "seg_rel", sam.ViTBlock, "forward", global_windowed),
        ("padded tokens excluded", SEGMENT, "seg_rel", sam.ViTAttention, "forward", padding_excluded),
        ("boxes moved", SEGMENT, "box_abs", detector.TextBoxDetector, "forward",
         lambda self, px, ids: (lambda b, s: (b * 0.98, s))(*detect(self, px, ids))),
        ("masks not expanded", SEGMENT, "seg_rel", expand, "rect_expand", lambda m: m),
        ("preview altered", LOOP, "preview_abs", TweedieMixPipeline, "decode_preview",
         lambda self, x0: preview(self, x0) * 0.98),
        ("other masks fused", LOOP, "update_rel", sampler, "build_region_masks",
         lambda fg, h, w: build(fg.flip(0), h, w)),
    ]


@pytest.mark.parametrize("cell", [LOOP, SEGMENT])
def test_a_sound_run_is_correct_and_reports_its_metrics(cell, capsys, monkeypatch):
    from benchmark.systems.langsam import System

    line = run_cell(cell, capsys, monkeypatch, trace=True)
    assert line["correct"], line["compared"]
    assert set(line["compared"]) == set(System.compares(tiny(cell)[0])) | {"missed_kernel_path"}
    assert line["compared"]["seg_rel"]["value"] < 1e-4
    if cell == LOOP:
        assert {"segment_s.image", "mfu_pct.langsam", "decode_s.image", "joint_s.image"} <= set(
            line["metrics"]), line["metrics"]
    else:  # the CPU's slice has no device events: the device's readers read nothing
        assert {"mfu_pct.segment"} <= set(line["metrics"]) <= {
            "mfu_pct.segment", "segment_syncs_per_call.segment"}, line["metrics"]


@pytest.mark.parametrize("cell, unit", [(LOOP, "image"), (SEGMENT, "call")])
def test_an_untraced_run_times_its_own_request(cell, unit, capsys, monkeypatch):
    """The in-loop cell's request is an image and the segmentation-only
    cell's one ``segment_fn`` call: each prints its own end-to-end time."""
    line = run_cell(cell, capsys, monkeypatch)
    assert line["correct"], line["compared"]
    assert set(line["metrics"]) == {f"s_per_{unit}", "peak_mem_gib", "setup_s"}, line["metrics"]


@pytest.mark.parametrize("fault", range(7))
def test_each_planted_fault_is_not_correct(fault, capsys, monkeypatch):
    name, cell, number, target, attr, value = faults()[fault]
    monkeypatch.setattr(target, attr, value)
    line = run_cell(cell, capsys, monkeypatch)
    assert not line["correct"], (name, line["compared"])
    got = line["compared"][number]
    assert got["value"] > got["limit"], (name, line["compared"])


def test_the_control_is_not_correct_and_runs_its_parts_with_tf32(monkeypatch):
    """The loop cell's control fails by its bfloat16 update (TF32 exists only
    on the card); in both cells the plain SAM encoder and detector of the
    control run under TF32."""
    from benchmark.controls import judged
    from benchmark.reference import ops
    from benchmark.systems import langsam

    entered = []
    tf32 = ops.tf32

    def spy(enabled):
        entered.append(enabled)
        return tf32(enabled)

    monkeypatch.setattr(langsam.ref_ops, "tf32", spy)
    out = judged(LOOP, 5 * 2**32 + 9, 2, device="cpu", cell_data=tiny(LOOP))
    assert not out["correct"] and "update_rel" in out["fails"], out
    entered.clear()
    out = judged(SEGMENT, 5 * 2**32 + 9, 2, device="cpu", cell_data=tiny(SEGMENT))
    assert set(out["compared"]) == {"box_abs", "seg_rel", "missed_kernel_path"}
    assert entered == [True, True] * 4  # per request and phrase: the detector, the encoder


def test_the_references_import_nothing_of_the_program_or_of_jax():
    for name in ("sam.py", "owlvit.py"):
        tree = ast.parse((Path(harness.BENCH) / "reference" / name).read_text())
        roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert not roots & {"tweediemix_tpu_torch", "tweediemix_tpu", "jax", "jaxlib", "flax"}, name
        assert roots <= {"__future__", "math", "zlib", "typing", "torch", "benchmark"}, (name, roots)


def test_the_new_readers_read_a_tiny_traced_slice():
    """The slice run twice under the profiler as the card's run does (the
    CPU's run profiles it once); the device's numbers stand in for a card's."""
    from benchmark.systems.langsam import System
    from tweediemix_tpu_torch.utils import profiling

    wl, cfg = tiny(SEGMENT)
    system = System(cfg, wl, SEED, "cpu")
    system.warm()
    results = [system.request(harness.request_seed(SEED, i), 0) for i in range(2)]
    work, shape = system.traced_slice()
    profiling.TRACER.clear()
    try:
        for _ in range(2):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                work()
        ctx = dict(results=results, window_s=0.4, requests=2, system=system, workload=wl, config=cfg,
                   slice=dict(shape, window_s=0.5, busy_s=0.2, by_class={"gemm": 0.1}))
        got = {name: harness.read_metric(name, ctx) for name in (
            "segment_s.image", "segment_syncs_per_call.langsam", "device_idle_pct.langsam",
            "mfu_pct.langsam", "seg_gemm_roofline_pct.langsam", "mfu_pct.segment",
            "device_idle_pct.segment", "segment_syncs_per_call.segment")}
    finally:
        profiling.TRACER.clear()
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert got["device_idle_pct.langsam"] == got["device_idle_pct.segment"] == pytest.approx(60.0)
    ops = shape["seg_work"]["seg_gemm"] + shape["seg_work"]["seg_attention"]
    assert got["seg_gemm_roofline_pct.langsam"] == pytest.approx(100 * ops / 67e12 / 0.1)
    # a segment call's work is all fp32: the whole step's share at that peak
    assert got["mfu_pct.segment"] == pytest.approx(100 * sum(shape["seg_work"].values()) / 67e12 / 0.2)
    assert got["mfu_pct.segment"] == pytest.approx(got["mfu_pct.langsam"])
    assert got["segment_syncs_per_call.segment"] == got["segment_syncs_per_call.langsam"]
    # the parent commit's program has no langsam span: nothing is read
    ctx["slice"]["segment_calls"] = 2
    assert harness.read_metric("segment_syncs_per_call.langsam", ctx) is None
    assert harness.read_metric("segment_syncs_per_call.segment", ctx) is None
