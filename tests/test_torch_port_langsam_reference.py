"""The port's in-loop segmentation against the benchmark's plain fp32
references (``benchmark/reference/sam.py``, ``owlvit.py``) at tiny sizes on
the CPU, from one set of seeded named tensors handed to the port's own
loaders: SAM's image encoder over a grid that its windows do not divide
(padding) with a global block and nonzero relative-position tables, the
mask decoder, OWL-ViT's boxes and scores, and the whole ``segment_fn``'s
masks, within 1e-5 relative in fp32. Each fault planted in the port's
encoder (the bias dropped, a global block windowed, the padded tokens
masked out) exceeds that. Also the stage's spans under the profiler."""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmark.reference import owlvit as ref_owlvit  # noqa: E402
from benchmark.reference import sam as ref_sam  # noqa: E402
from benchmark.seg_models import (  # noqa: E402
    draw_seg_weights,
    program_detector_config,
    program_sam_config,
    seg_reference,
)
from tweediemix_tpu_torch.fusion import sampler as port_sampler  # noqa: E402
from tweediemix_tpu_torch.fusion.pipeline import TweedieMixPipeline  # noqa: E402
from tweediemix_tpu_torch.models import unet2d as port_unet2d  # noqa: E402
from tweediemix_tpu_torch.models import vae as port_vae  # noqa: E402
from tweediemix_tpu_torch.models.convert import load_detector, load_sam  # noqa: E402
from tweediemix_tpu_torch.ops.attention import merge_heads, split_heads  # noqa: E402
from tweediemix_tpu_torch.segmentation import LangSAM, make_model_segment_fn  # noqa: E402
from tweediemix_tpu_torch.segmentation import sam as port_sam  # noqa: E402
from tweediemix_tpu_torch.utils import profiling  # noqa: E402
from tweediemix_tpu_torch.utils.tokenizer import HashTokenizer  # noqa: E402

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TOL = 1e-5
SEED = 2**33 + 7
# grid 48 / 8 = 6 under windows of 4: padded to 8, three of four windows hold padding
CFG = {
    "sam": dict(image_size=48, vit_patch_size=8, encoder_embed_dim=32, encoder_depth=2,
                encoder_num_heads=2, encoder_global_attn_indexes=[1], window_size=4, mlp_ratio=4,
                prompt_embed_dim=16, transformer_depth=2, transformer_mlp_dim=128,
                transformer_num_heads=2, attention_downsample_rate=2, num_multimask_outputs=3,
                iou_head_depth=3, iou_head_hidden_dim=16, dtype="float32"),
    "detector": dict(
        vision_config=dict(image_size=32, patch_size=8, hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=2, hidden_act="quick_gelu",
                           layer_norm_eps=1e-5),
        text_config=dict(vocab_size=1000, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=2, max_position_embeddings=16, hidden_act="quick_gelu",
                         layer_norm_eps=1e-5, eos_token_id=999),
        projection_dim=32, max_boxes=4, box_threshold=0.2, dtype="float32"),
}
BOXES = torch.tensor([[0.1, 0.2, 0.7, 0.8], [0.3, 0.1, 0.9, 0.6], [0.0, 0.0, 1.0, 1.0]])


def rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.fixture(scope="module")
def models():
    """(port SAM, port detector, plain SAM, plain OWL-ViT) from one draw."""
    sam_w, det_w = draw_seg_weights(CFG, SEED, "cpu")
    assert sam_w["image_encoder.blocks.0.attn.rel_pos_h"].abs().min() > 0
    ref_sam_m, ref_det = seg_reference(CFG)
    ref_sam_m.load_state_dict({k: v.clone() for k, v in sam_w.items()}, assign=True)
    ref_det.load_state_dict({k: v.clone() for k, v in det_w.items()}, assign=True)
    port = load_sam(sam_w, program_sam_config(CFG), "cpu").eval()
    det = load_detector(det_w, program_detector_config(CFG), "cpu").eval()
    return port, det, ref_sam_m, ref_det


def pixels(seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((1, 48, 48, 3), generator=g)


def image(seed=1):
    g = torch.Generator().manual_seed(seed)
    field = torch.rand((1, 3, 8, 8), generator=g)
    img = torch.nn.functional.interpolate(field, size=(64, 64), mode="bilinear", align_corners=False)
    return (img[0].permute(1, 2, 0) + 0.05 * torch.randn((64, 64, 3), generator=g)).clamp(0, 1)


@torch.no_grad()
def test_sam_encoder_with_padding_and_a_global_block_matches_the_reference(models):
    port, _, ref, _ = models
    want = ref.encode(pixels())
    got = port.encode_image(pixels()).permute(0, 3, 1, 2)
    assert rel(got, want) < TOL


@torch.no_grad()
def test_mask_decoder_matches_the_reference(models):
    port, _, ref, _ = models
    feats = ref.encode(pixels())
    got, _ = port.decode_boxes(feats.permute(0, 2, 3, 1), BOXES)
    want = ref.decode(feats, BOXES)
    assert got.shape == want.shape == (3, 24, 24)
    assert rel(got, want) < TOL


@torch.no_grad()
def test_owlvit_boxes_and_scores_match_the_reference(models):
    _, det, _, ref = models
    img = image()
    tok = HashTokenizer(1000, max_length=16)
    for phrase in ("cat", "a dog"):
        px = ref.pixels(img)
        ids = torch.tensor(tok([phrase]))
        assert ids.tolist() == ref.ids(phrase, "cpu").tolist()
        boxes, scores = det(px, ids)
        want_boxes, want_scores = ref_owlvit.top(*ref(px, ids), 4)
        assert rel(scores, want_scores) < TOL and rel(boxes, want_boxes) < TOL


@torch.no_grad()
def test_segment_fn_masks_match_the_reference_contract(models):
    port, det, ref, ref_det = models
    ls = LangSAM(port, det, HashTokenizer(1000, max_length=16), box_threshold=0.2)
    phrases = ["cat", "dog"]
    got = make_model_segment_fn(ls, "+".join(phrases))(image()[None])
    img, masks = image(), []
    for phrase in phrases:
        boxes, scores = ref_owlvit.top(*ref_det.detect(img, phrase), 4)
        logits, _ = ref_sam.mask_logits(ref, img, boxes)
        want_logits, _, _ = ls.predict_logits(img, phrase)
        assert rel(want_logits, logits) < TOL
        masks.append(ref_sam.best_mask(logits, scores, 0.2))
        img = ref_sam.blackout(img, masks[-1])
    want = ref_sam.region_masks(masks)
    assert want.sum() > 0 and torch.equal(got, want)


def test_segment_fn_keeps_its_own_seconds(models):
    """Off the card nothing is queued before a call: its own seconds are its
    wall seconds."""
    port, det, _, _ = models
    fn = make_model_segment_fn(LangSAM(port, det, HashTokenizer(1000, max_length=16)), "cat+dog")
    assert fn.own_seconds == 0.0
    fn(image())
    assert fn.own_seconds == fn.seconds > 0


@pytest.mark.cuda
def test_segment_fn_own_seconds_leave_out_the_work_queued_before_it_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda on the GPU machine")
    sam_w, det_w = draw_seg_weights(CFG, SEED, "cuda")
    ls = LangSAM(load_sam(sam_w, program_sam_config(CFG), "cuda"),
                 load_detector(det_w, program_detector_config(CFG), "cuda"),
                 HashTokenizer(1000, max_length=16))
    fn = make_model_segment_fn(ls, "cat+dog")
    img = image().cuda()
    fn(img)
    a = torch.randn((4096, 4096), device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(100):
        a @ a
    end.record()
    fn(img)
    queued = start.elapsed_time(end) / 1e3
    assert queued > 0.05
    assert 0 < fn.own_seconds < fn.seconds - 0.5 * queued


def padding_excluded(self, x):
    """The window attention with the padded tokens masked out as keys."""
    bsz, gh, gw, c = x.shape
    pad = (x == 0).all(dim=-1).reshape(bsz, gh * gw)
    q, k, v = self.qkv(x.reshape(bsz, gh * gw, c)).chunk(3, dim=-1)
    qs, ks, vs = (split_heads(a, self.heads) for a in (q, k, v))
    s = torch.matmul(qs, ks.transpose(1, 2)) * (c // self.heads) ** -0.5
    port_sam.add_rel_pos_bias_(s, *port_sam.rel_pos_terms(q, self.rel_pos_h, self.rel_pos_w, gh, gw,
                                                          self.heads))
    s = s.masked_fill(pad.repeat_interleave(self.heads, 0)[:, None, :], -torch.inf)
    o = merge_heads(torch.matmul(torch.softmax(s, dim=-1), vs), self.heads)
    return self.proj(o).reshape(bsz, gh, gw, c)


@pytest.mark.parametrize("fault", ["no_rel_pos_bias", "global_block_windowed", "padding_excluded"])
@torch.no_grad()
def test_each_planted_encoder_fault_exceeds_the_tolerance(models, fault, monkeypatch):
    port, _, ref, _ = models
    if fault == "no_rel_pos_bias":
        monkeypatch.setattr(port_sam, "add_rel_pos_bias_", lambda scores, bh, bw: scores)
    elif fault == "global_block_windowed":
        monkeypatch.setattr(port.image_encoder.blocks[1], "window_size", 4)
    else:
        monkeypatch.setattr(port_sam.ViTAttention, "forward", padding_excluded)
    got = port.encode_image(pixels()).permute(0, 3, 1, 2)
    assert rel(got, ref.encode(pixels())) > 100 * TOL


def test_segment_fn_records_its_spans_per_phrase(models):
    port, det, _, _ = models
    fn = make_model_segment_fn(LangSAM(port, det, HashTokenizer(1000, max_length=16)), "cat+dog")
    profiling.TRACER.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            fn(image())
        spans = profiling.spans()
    finally:
        profiling.TRACER.clear()
    root = spans[0]
    assert root["name"] == "langsam" and root["parent"] is None
    assert root["attrs"] == {"phrases": 2, "boxes": [4, 4], "fallbacks": len(fn.no_detections)}
    below = [s["name"] for s in spans[1:] if s["request"] == root["id"]]
    assert below == ["langsam.detect", "langsam.encode", "langsam.decode"] * 2 + ["langsam.expand"]
    assert all(s["parent"] == root["id"] for s in spans[1:])


def test_in_loop_sample_records_preview_under_fused():
    n = 3
    fcfg = port_sampler.FusionConfig(n_timesteps=4, t_cond=0.5, resampling_steps=1, jumping_steps=1,
                                     height=64, width=64, num_concepts=n)
    torch.manual_seed(0)
    pipe = TweedieMixPipeline.from_random_weights(
        port_unet2d.UNetConfig.tiny(concept_slots=n + 1), port_vae.VAEConfig.tiny(), fcfg, device="cpu")
    pipe.sampler.segment_fn = make_model_segment_fn(LangSAM.random_init(device="cpu"), "a cat+a dog")
    embeds = port_sampler.TextEmbeds(*(0.2 * torch.randn(m, *s) for m in (2, n - 1, n + 1)
                                       for s in ((6, 32), (32,))))
    profiling.TRACER.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            pipe.sample(embeds, seed=3, fg_masks=None)
        spans = {s["id"]: s for s in profiling.spans()}
    finally:
        profiling.TRACER.clear()
    named = {s["name"]: s for s in spans.values()}
    assert spans[named["preview"]["parent"]]["name"] == "fused"
    assert spans[named["langsam"]["parent"]]["name"] == "segment"
    assert named["segment"]["parent"] == named["preview"]["parent"]
    assert named["langsam"]["attrs"]["phrases"] == 2
