"""The torch port's segmentation stage against the JAX package on the CPU:
mask post-processing, ``expand_masks``, SAM (window partition, the
relative-position bias, ``ViTBlock``, the image and prompt encoders, the
mask decoder, the whole model), the OWL-ViT ``TextBoxDetector``, the CLIP
vision tower, ``LangSAM.predict`` and ``make_model_segment_fn``, the
checkpoint loaders, and HF's ``SamModel`` and ``OwlViTForObjectDetection``.

Parameters and inputs come from numpy seeds and go through both packages
(the JAX trees through ``models/convert.py``'s entries functions).
Tolerances, in fp32: 3e-5 per block, 1e-4 per model (atol and rtol, or
relative to the output's largest magnitude where stated); masks are
compared as booleans, equal except pixels whose logit lies within 1e-4 of
the largest |logit| from 0.
"""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tweediemix_tpu.fusion import masks as jax_masks
from tweediemix_tpu.models import clip as jax_clip
from tweediemix_tpu.models import convert as jax_convert
from tweediemix_tpu.segmentation import detector as jax_det
from tweediemix_tpu.segmentation import expand as jax_expand
from tweediemix_tpu.segmentation import lang_sam as jax_lang_sam
from tweediemix_tpu.segmentation import sam as jax_sam
from tweediemix_tpu.utils import tokenizer as jax_tok
from tweediemix_tpu_torch.fusion import masks as port_masks
from tweediemix_tpu_torch.models import clip as port_clip
from tweediemix_tpu_torch.models import convert as port_convert
from tweediemix_tpu_torch.segmentation import detector as port_det
from tweediemix_tpu_torch.segmentation import expand as port_expand
from tweediemix_tpu_torch.segmentation import lang_sam as port_lang_sam
from tweediemix_tpu_torch.segmentation import sam as port_sam
from tweediemix_tpu_torch.utils import tokenizer as port_tok

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

BLOCK_TOL, MODEL_TOL = 3e-5, 1e-4
BOXES = np.array([[0.1, 0.2, 0.7, 0.8], [0.3, 0.1, 0.9, 0.6], [0.0, 0.0, 1.0, 1.0]], np.float32)


def numpy_params(abstract, seed):
    """Every leaf of a JAX tree from a numpy seed: norm scales near 1,
    biases and the relative-position tables small, matrices and kernels
    N(0, 1/fan_in), vectors and tables N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['bias']") or "rel_pos" in name:
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['kernel']") and len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def to_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(got, want, tol):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)


def assert_rel_close(got, want, tol):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


# -- mask post-processing -------------------------------------------------------------


def _test_masks_inputs():
    """tests/test_masks.py's inputs: 16x16 masks at 0.8 (RandomState(0)),
    12x12 pairs at 0.7 (RandomState(1)), its containment case, and an empty
    and a disjoint pair."""
    r0 = np.random.RandomState(0)
    singles = [(r0.rand(16, 16) > 0.8).astype(np.float32) for _ in range(5)]
    singles.append(np.zeros((8, 8), np.float32))
    r1 = np.random.RandomState(1)
    pairs = [((r1.rand(12, 12) > 0.7).astype(np.float32), (r1.rand(12, 12) > 0.7).astype(np.float32))
             for _ in range(8)]
    o0, o1 = np.zeros((8, 8), np.float32), np.zeros((8, 8), np.float32)
    o0[2:4, 2:4], o1[1:6, 1:6] = 1, 1
    pairs.append((o0, o1))
    d0, d1 = np.zeros((8, 8), np.float32), np.zeros((8, 8), np.float32)
    d0[:2, :2], d1[5:, 5:] = 1, 1
    pairs += [(d0, d1), (np.zeros((8, 8), np.float32), o1)]
    return singles, pairs


def test_rect_expand_and_blackout_match_jax():
    singles, _ = _test_masks_inputs()
    for m in singles:
        np.testing.assert_array_equal(to_np(port_masks.rect_expand(torch.from_numpy(m))),
                                      np.asarray(jax_masks.rect_expand(jnp.asarray(m))))
        img = np.random.default_rng(0).random(m.shape + (3,)).astype(np.float32)
        np.testing.assert_array_equal(
            to_np(port_masks.sequential_blackout(torch.from_numpy(img), torch.from_numpy(m))),
            np.asarray(jax_masks.sequential_blackout(jnp.asarray(img), jnp.asarray(m))))
    assert port_masks.rect_expand(torch.zeros(8, 8)).sum() == 0


@pytest.mark.parametrize("case", range(11))
def test_resolve_overlap_pair_matches_jax(case):
    _, pairs = _test_masks_inputs()
    orig0, orig1 = pairs[case]
    rect0 = np.array(jax_masks.rect_expand(jnp.asarray(orig0)))
    rect1 = np.array(jax_masks.rect_expand(jnp.asarray(orig1)))
    want = jax_masks.resolve_overlap_pair(*(jnp.asarray(a) for a in (rect0, rect1, orig0, orig1)))
    got = port_masks.resolve_overlap_pair(*(torch.from_numpy(a) for a in (rect0, rect1, orig0, orig1)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


@pytest.mark.parametrize("n_concepts", [1, 2, 3])
def test_expand_masks_matches_jax(n_concepts):
    """A fixed predictor (a threshold of one colour channel, shifted per
    concept) through both packages' expand_masks."""
    img = np.random.default_rng(n_concepts).random((20, 24, 3)).astype(np.float32)
    concepts = ["a cat", "a dog", "a tree"][:n_concepts]

    def above(image, text):
        c = concepts.index(text)
        return image[..., c] > 0.6 + 0.1 * c

    want = jax_expand.expand_masks(lambda i, t: above(i, t).astype(jnp.float32), jnp.asarray(img), concepts)
    got = port_expand.expand_masks(lambda i, t: above(i, t).float(), torch.from_numpy(img), concepts)
    assert got.shape == (n_concepts, 20, 24)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


# -- SAM -------------------------------------------------------------------------------


@pytest.mark.parametrize("hw, win", [((8, 8), 4), ((10, 7), 4), ((64, 64), 14)])
def test_window_partition_matches_jax(hw, win):
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    want = jax_sam.window_partition(jnp.asarray(x), win)
    got = port_sam.window_partition(torch.from_numpy(x), win)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    back = port_sam.window_unpartition(got, win, hw)
    np.testing.assert_array_equal(to_np(back), x)
    np.testing.assert_array_equal(to_np(back), np.asarray(jax_sam.window_unpartition(want, win, hw)))


@pytest.mark.parametrize("gh, gw, heads", [(4, 4, 2), (8, 8, 2), (3, 5, 1)])
def test_rel_pos_bias_matches_jax(gh, gw, heads):
    rng = np.random.default_rng(gh * gw)
    hd = 4
    q = rng.standard_normal((3, gh * gw, heads * hd)).astype(np.float32)
    rel_h = rng.standard_normal((2 * gh - 1, hd)).astype(np.float32)
    rel_w = rng.standard_normal((2 * gw - 1, hd)).astype(np.float32)
    want = jax_sam._rel_pos_bias(jnp.asarray(q), jnp.asarray(rel_h), jnp.asarray(rel_w), gh, gw, heads)
    bh, bw = port_sam.rel_pos_terms(torch.from_numpy(q), torch.from_numpy(rel_h),
                                    torch.from_numpy(rel_w), gh, gw, heads)
    got = port_sam.add_rel_pos_bias_(torch.zeros(3 * heads, gh * gw, gh * gw), bh, bw)
    assert_close(got, want, BLOCK_TOL)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _sam_block_state(params, i=0):
    """A JAX ViTBlock tree → the port ViTBlock's state dict (through
    sam_entries under the encoder's block scope)."""
    sd = {}
    for path, arr in port_convert.flatten_tree({"image_encoder": {f"blocks_{i}": params}}).items():
        for name, value in port_convert.sam_entries(path, arr):
            sd[name] = torch.tensor(np.ascontiguousarray(value))
    return _strip(sd, f"image_encoder.blocks.{i}.")


@pytest.mark.parametrize("grid, win", [(8, 4), (6, 4), (8, 0)])
def test_vit_block_matches_jax(grid, win):
    """Windowed (grid divisible, and padded 6 → 8) and global blocks."""
    dim, heads = 16, 2
    x = np.random.default_rng(grid + win).standard_normal((1, grid, grid, dim)).astype(np.float32)
    block = jax_sam.ViTBlock(dim, heads, win)
    params = numpy_params(jax.eval_shape(block.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    want = block.apply({"params": params}, jnp.asarray(x))
    port = port_sam.ViTBlock(dim, heads, win, grid)
    port.load_state_dict(_sam_block_state(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert_close(got, want, BLOCK_TOL)


@pytest.fixture(scope="module")
def sam_pair():
    """The tiny JAX SAM with a numpy-seeded tree, the port SAM converted from
    it, an image and boxes."""
    cfg = jax_sam.SAMConfig.tiny()
    img = np.random.default_rng(5).standard_normal((1, 64, 64, 3)).astype(np.float32)
    model = jax_sam.SAM(cfg)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(BOXES))
    params = numpy_params(abstract["params"], 0)
    port = port_sam.SAM(port_sam.SAMConfig.tiny(), device="cpu").eval()
    port_convert.load_params(port, params, entries_fn=port_convert.sam_entries)
    return model, params, port, img


def test_sam_image_encoder_matches_jax(sam_pair):
    model, params, port, img = sam_pair
    want = model.apply({"params": params}, jnp.asarray(img), method=jax_sam.SAM.encode_image)
    with torch.no_grad():
        got = port.encode_image(torch.from_numpy(img))
    assert got.shape == (1, 8, 8, 16)
    assert_close(got, want, MODEL_TOL)


def test_sam_prompt_encoder_matches_jax(sam_pair):
    _, params, port, _ = sam_pair
    enc = jax_sam.SAMPromptEncoder(jax_sam.SAMConfig.tiny())
    p = {"params": params["prompt_encoder"]}
    sparse, no_mask = enc.apply(p, jnp.asarray(BOXES))
    dense = enc.apply(p, 8, method=jax_sam.SAMPromptEncoder.dense_pe)
    with torch.no_grad():
        got_sparse, got_no_mask = port.prompt_encoder(torch.from_numpy(BOXES))
        got_dense = port.prompt_encoder.dense_pe(8)
    assert_close(got_sparse, sparse, BLOCK_TOL)
    assert_close(got_no_mask, no_mask, 0.0)
    assert_close(got_dense, dense, BLOCK_TOL)


@pytest.mark.parametrize("first", [True, False])
def test_two_way_block_matches_jax(sam_pair, first):
    """The decoder's first layer (queries replaced, no PE) and a later one."""
    _, params, port, _ = sam_pair
    rng = np.random.default_rng(8)
    tokens, token_pe = (rng.standard_normal((3, 7, 16)).astype(np.float32) for _ in range(2))
    image, image_pe = (rng.standard_normal((3, 64, 16)).astype(np.float32) for _ in range(2))
    block = jax_sam.TwoWayBlock(16, 2, 2)
    args = [jnp.asarray(a) for a in (tokens, image, token_pe, image_pe)]
    want = block.apply({"params": params["mask_decoder"]["layers_1"]}, *args, first)
    with torch.no_grad():
        got = port.mask_decoder.transformer.layers[1](
            *(torch.from_numpy(a) for a in (tokens, image, token_pe, image_pe)), first)
    for g, w in zip(got, want):
        assert_close(g, w, BLOCK_TOL)


def test_sam_mask_decoder_matches_jax(sam_pair):
    _, params, port, _ = sam_pair
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((3, 8, 8, 16)).astype(np.float32)
    pe = rng.standard_normal((8, 8, 16)).astype(np.float32)
    sparse = rng.standard_normal((3, 2, 16)).astype(np.float32)
    dec = jax_sam.SAMMaskDecoder(jax_sam.SAMConfig.tiny())
    masks, iou = dec.apply({"params": params["mask_decoder"]}, *(jnp.asarray(a) for a in (feats, pe, sparse)))
    with torch.no_grad():
        got_masks, got_iou = port.mask_decoder(*(torch.from_numpy(a) for a in (feats, pe, sparse)))
    assert got_masks.shape == (3, 4, 32, 32)
    assert_close(got_masks, masks, MODEL_TOL)
    assert_close(got_iou, iou, MODEL_TOL)


def test_sam_matches_jax(sam_pair):
    model, params, port, img = sam_pair
    masks, iou = model.apply({"params": params}, jnp.asarray(img), jnp.asarray(BOXES))
    with torch.no_grad():
        got_masks, got_iou = port(torch.from_numpy(img), torch.from_numpy(BOXES))
    assert got_masks.shape == (3, 32, 32)
    assert_rel_close(got_masks, masks, MODEL_TOL)
    assert_close(got_iou, iou, MODEL_TOL)


def test_sam_transposed_convolutions_need_the_flip(sam_pair):
    """The tree converter flips up1/up2; without the flip the port computes
    something else (the masks' 2x2 sub-pixels come out mirrored)."""
    model, params, port, img = sam_pair
    masks, _ = model.apply({"params": params}, jnp.asarray(img), jnp.asarray(BOXES))
    unflipped = port_sam.SAM(port_sam.SAMConfig.tiny(), device="cpu").eval()
    sd = port_convert.convert_params(params, unflipped, entries_fn=port_convert.sam_entries)
    for i in (0, 3):
        key = f"mask_decoder.output_upscaling.{i}.weight"
        sd[key] = sd[key].flip(2, 3)
    unflipped.load_state_dict(sd)
    with torch.no_grad():
        got, _ = unflipped(torch.from_numpy(img), torch.from_numpy(BOXES))
    err = np.abs(to_np(got) - np.asarray(masks)).max() / np.abs(np.asarray(masks)).max()
    assert err > 1e-2


# -- the detector and the CLIP vision tower ----------------------------------------


@pytest.fixture(scope="module")
def det_pair():
    cfg = jax_det.DetectorConfig.tiny()
    img = np.random.default_rng(3).standard_normal((1, 32, 32, 3)).astype(np.float32)
    ids = np.random.default_rng(4).integers(1, 998, (1, 16))
    ids[0, 7] = 999
    model = jax_det.TextBoxDetector(cfg)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(ids))
    params = numpy_params(abstract["params"], 2)
    port = port_det.TextBoxDetector(port_det.DetectorConfig.tiny(), device="cpu").eval()
    port_convert.load_params(port, params, entries_fn=port_convert.detector_entries)
    return model, params, port, img, ids


@pytest.mark.parametrize("query", ["eos at 7", "eos at 3", "no eos"])
def test_detector_matches_jax(det_pair, query):
    model, params, port, img, ids = det_pair
    ids = ids.copy()
    if query == "eos at 3":
        ids[0, 3] = 999
    elif query == "no eos":
        ids[ids == 999] = 5
    boxes, scores = model.apply({"params": params}, jnp.asarray(img), jnp.asarray(ids))
    with torch.no_grad():
        got_boxes, got_scores = port(torch.from_numpy(img), torch.from_numpy(ids))
    assert got_boxes.shape == (4, 4) and got_scores.shape == (4,)
    assert_close(got_scores, scores, MODEL_TOL)
    assert_close(got_boxes, boxes, MODEL_TOL)


def test_detector_box_bias_and_tie_order():
    np.testing.assert_array_equal(port_det._box_bias(4), jax_det._box_bias(4))
    # equal scores keep the lower patch index first, as jax.lax.top_k does
    scores = torch.tensor([0.5, 0.7, 0.5, 0.7, 0.1])
    order = torch.sort(scores, descending=True, stable=True).indices
    assert order.tolist() == np.asarray(jax.lax.top_k(jnp.asarray(scores.numpy()), 5)[1]).tolist()


@pytest.mark.parametrize("variant", ["tiny", "gelu_no_projection"])
def test_clip_vision_model_matches_jax(variant):
    kw = {} if variant == "tiny" else dict(hidden_act="gelu", projection_dim=None)
    cfg = jax_clip.CLIPVisionConfig.tiny(**kw)
    img = np.random.default_rng(11).standard_normal((2, 32, 32, 3)).astype(np.float32)
    model = jax_clip.CLIPVisionModel(cfg)
    params = numpy_params(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(img))["params"], 3)
    want = model.apply({"params": params}, jnp.asarray(img))
    port = port_clip.CLIPVisionModel(port_clip.CLIPVisionConfig.tiny(**kw), device="cpu").eval()
    port_convert.load_params(port, params, entries_fn=port_convert.clip_vision_entries)
    with torch.no_grad():
        got = port(torch.from_numpy(img))
    assert got.shape == want.shape
    assert_close(got, want, MODEL_TOL)


# -- LangSAM ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lang_sam_pair(sam_pair, det_pair):
    _, sam_params, sam, _, = sam_pair
    _, det_params, det, _, _ = det_pair
    jls = jax_lang_sam.LangSAM(jax_sam.SAMConfig.tiny(), sam_params, jax_det.DetectorConfig.tiny(),
                               det_params, jax_tok.HashTokenizer(1000))
    pls = port_lang_sam.LangSAM(sam, det, port_tok.HashTokenizer(1000))
    return jls, pls


def _jax_upsampled_logits(jls, image, boxes):
    """The JAX predict's mask logits before the threshold."""
    size = jls.sam.config.image_size
    img = jax.image.resize(jnp.asarray(image), (size, size, 3), "bilinear")[None]
    img = (img * 255.0 - jnp.asarray(jax_lang_sam.SAM_PIXEL_MEAN)) / jnp.asarray(jax_lang_sam.SAM_PIXEL_STD)
    logits, _ = jls.sam.apply({"params": jls.sam_params}, img, boxes)
    return np.asarray(jax.image.resize(logits, (logits.shape[0], *image.shape[:2]), "bilinear"))


def assert_masks_equal_off_the_edge(got, want, logits):
    """Boolean masks equal except pixels whose logit is within 1e-4 of the
    largest |logit| from 0."""
    differ = to_np(got) != np.asarray(want)
    edge = np.abs(logits) <= MODEL_TOL * np.abs(logits).max()
    assert not (differ & ~edge).any(), int((differ & ~edge).sum())


@pytest.mark.parametrize("hw", [(64, 64), (96, 80), (20, 28)])
def test_lang_sam_predict_matches_jax(lang_sam_pair, hw):
    """Down-, up- and same-size resizes into the detector (32²) and SAM (64²)."""
    jls, pls = lang_sam_pair
    image = np.random.default_rng(hw[0]).random((*hw, 3)).astype(np.float32)
    masks, boxes, scores, valid = jls.predict(jnp.asarray(image), "a cat")
    got_masks, got_boxes, got_scores, got_valid = pls.predict(torch.from_numpy(image), "a cat")
    assert got_masks.dtype == torch.bool and got_masks.shape == (4, *hw)
    assert_close(got_scores, scores, MODEL_TOL)
    assert_close(got_boxes, boxes, MODEL_TOL)
    np.testing.assert_array_equal(to_np(got_valid), np.asarray(valid))
    want_logits = _jax_upsampled_logits(jls, image, boxes)
    assert_rel_close(pls.predict_logits(torch.from_numpy(image), "a cat")[0], want_logits, MODEL_TOL)
    assert_masks_equal_off_the_edge(got_masks, masks, want_logits)


def test_resize_bilinear_matches_jax_image_resize():
    x = np.random.default_rng(0).random((3, 40, 24)).astype(np.float32)
    for hw in [(40, 24), (32, 32), (96, 80), (7, 50)]:
        want = jax.image.resize(jnp.asarray(x), (3, *hw), "bilinear")
        assert_close(port_lang_sam.resize_bilinear(torch.from_numpy(x), *hw), want, BLOCK_TOL)


def test_model_segment_fn_matches_jax(lang_sam_pair):
    jls, pls = lang_sam_pair
    image = np.random.default_rng(9).random((48, 40, 3)).astype(np.float32)
    jls.box_threshold = pls.box_threshold = 0.5
    want_fn = jax_lang_sam.make_model_segment_fn(jls, "a cat+a dog")
    got_fn = port_lang_sam.make_model_segment_fn(pls, "a cat+a dog")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = want_fn(jnp.asarray(image)[None])
        got = got_fn(torch.from_numpy(image)[None])
    assert got.shape == (2, 48, 40) and got.dtype == torch.float32
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert [c for c, _ in got_fn.no_detections] == [c for c, _ in want_fn.no_detections]
    assert [c for c, _ in got_fn.top_scores] == ["a cat", "a dog"]
    np.testing.assert_allclose(got_fn.areas, np.asarray(want).mean(axis=(1, 2)), rtol=1e-6)
    assert got_fn.seconds > 0


def test_no_detection_warns_records_and_resets(lang_sam_pair):
    """No box can clear a threshold of 2: every concept warns, is recorded
    with its top score and falls back to the top box; a call where boxes
    clear it resets the record."""
    _, pls = lang_sam_pair
    fn = port_lang_sam.make_model_segment_fn(pls, "a cat+a dog")
    img = torch.from_numpy(np.random.default_rng(2).random((64, 64, 3)).astype(np.float32))
    pls.box_threshold = 2.0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        masks = fn(img)
    assert masks.shape == (2, 64, 64) and torch.isfinite(masks).all()
    msgs = [str(w.message) for w in caught]
    assert any("a cat" in m and "box_threshold" in m for m in msgs)
    assert any("a dog" in m for m in msgs)
    assert [c for c, _ in fn.no_detections] == ["a cat", "a dog"]
    assert [s for _, s in fn.no_detections] == [s for _, s in fn.top_scores]
    pls.box_threshold = -1.0
    with warnings.catch_warnings(record=True) as caught2:
        warnings.simplefilter("always")
        fn(img)
    assert fn.no_detections == [] and caught2 == []
    pls.box_threshold = 0.20


def test_sam_random_is_seeded_and_explicit():
    a = port_lang_sam.LangSAM.random_init(torch.Generator().manual_seed(3), device="cpu")
    b = port_lang_sam.LangSAM.random_init(torch.Generator().manual_seed(3), device="cpu")
    c = port_lang_sam.LangSAM.random_init(torch.Generator().manual_seed(4), device="cpu")
    for x, y, z in zip(a.sam.state_dict().values(), b.sam.state_dict().values(),
                       c.sam.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert any(not torch.equal(x, z) for x, z in zip(a.detector.state_dict().values(),
                                                     c.detector.state_dict().values()))
    img = torch.rand(40, 40, 3, generator=torch.Generator().manual_seed(0))
    masks, boxes, scores, valid = a.predict(img, "a cat")
    assert masks.shape == (4, 40, 40) and bool(((boxes >= 0) & (boxes <= 1)).all())
    assert bool((scores[:-1] >= scores[1:]).all())


# -- checkpoint loaders --------------------------------------------------------------


def _sam_checkpoint_tensors(port, seed=0):
    """segment-anything-named tensors for a tiny SAM: the port's state
    dict drawn anew (up1/up2 at std 1, so the flip shows), plus the point-
    and mask-prompt parameters that the port does not hold."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in port.state_dict().items():
        std = 1.0 if "output_upscaling" in k and k.endswith("weight") and v.ndim == 4 else 0.3
        sd[k] = std * torch.randn(v.shape, generator=g)
    d = port.config.prompt_dim
    for k, shape in [("prompt_encoder.point_embeddings.0.weight", (1, d)),
                     ("prompt_encoder.point_embeddings.1.weight", (1, d)),
                     ("prompt_encoder.not_a_point_embed.weight", (1, d)),
                     ("prompt_encoder.mask_downscaling.0.weight", (4, 1, 2, 2)),
                     ("prompt_encoder.mask_downscaling.0.bias", (4,))]:
        sd[k] = torch.randn(shape, generator=g)
    return sd


@pytest.mark.parametrize("fmt", ["pth", "safetensors", "safetensors_dir"])
def test_sam_loader_equals_the_jax_tree_with_up1_up2_flipped(tmp_path, sam_pair, fmt):
    """Both packages read one segment-anything checkpoint. The port puts
    its transposed-convolution kernels into ConvTranspose2d as they are
    (what upstream computes), so it equals the JAX package's tree with
    up1/up2 flipped, and not the tree itself (the JAX converter leaves the
    flip out)."""
    _, _, port, img = sam_pair
    sd = _sam_checkpoint_tensors(port)
    if fmt == "pth":
        path = str(tmp_path / "sam.pth")
        torch.save(sd, path)
        jax_path = path
    else:
        os.makedirs(tmp_path / "sam")
        path = str(tmp_path / "sam" / "model.safetensors")
        port_convert.save_safetensors(path, sd)
        jax_path = str(tmp_path / "sam")
        if fmt == "safetensors_dir":
            path = jax_path
    loaded = port_convert.load_sam(path, port_sam.SAMConfig.tiny(), device="cpu")
    want_sd = {k: v for k, v in sd.items() if not k.startswith(port_convert.SAM_UNUSED_PREFIXES)}
    got_sd = loaded.state_dict()
    assert set(got_sd) == set(want_sd)
    for k in want_sd:
        torch.testing.assert_close(got_sd[k], want_sd[k], rtol=0, atol=0)

    tree = jax_convert.load_sam_params(jax_path)
    flipped = jax.tree_util.tree_map(np.asarray, tree)
    for up in ("up1", "up2"):
        flipped["mask_decoder"][up]["kernel"] = flipped["mask_decoder"][up]["kernel"][::-1, ::-1]
    model = jax_sam.SAM(jax_sam.SAMConfig.tiny())
    want, _ = model.apply({"params": flipped}, jnp.asarray(img), jnp.asarray(BOXES))
    as_is, _ = model.apply({"params": tree}, jnp.asarray(img), jnp.asarray(BOXES))
    with torch.no_grad():
        got, _ = loaded(torch.from_numpy(img), torch.from_numpy(BOXES))
    assert_rel_close(got, want, MODEL_TOL)
    assert np.abs(to_np(got) - np.asarray(as_is)).max() > 1e-2 * np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("fault", ["missing", "unexpected", "misshapen"])
def test_sam_loader_raises_on_missing_unexpected_or_misshapen_keys(sam_pair, fault):
    _, _, port, _ = sam_pair
    sd = _sam_checkpoint_tensors(port)
    if fault == "missing":
        del sd["mask_decoder.iou_token.weight"]
    elif fault == "unexpected":
        sd["image_encoder.blocks.0.attn.extra"] = torch.zeros(3)
    else:
        sd["image_encoder.pos_embed"] = torch.zeros(1, 4, 4, 32)
    with pytest.raises(ValueError, match=fault.replace("misshapen", "shape mismatch")):
        port_convert.load_sam(sd, port_sam.SAMConfig.tiny(), device="cpu")


def _hf_named(entries_fn, params, prefix_extra):
    sd = {}
    for path, arr in port_convert.flatten_tree(params).items():
        for name, value in entries_fn(path, arr):
            sd[name] = torch.tensor(np.ascontiguousarray(value))
    sd.update(prefix_extra)
    return sd


def test_detector_dir_loads_like_jax(tmp_path, det_pair):
    """An HF OwlViTForObjectDetection dir (with the contrastive head and
    position-id buffers the detector does not use) read by both packages."""
    model, params, _, img, ids = det_pair
    sd = _hf_named(port_convert.detector_entries, params, {
        "owlvit.logit_scale": torch.tensor(2.6592),
        "owlvit.visual_projection.weight": torch.randn(32, 32),
        "owlvit.text_model.embeddings.position_ids": torch.arange(16)[None],
        "owlvit.vision_model.embeddings.position_ids": torch.arange(17)[None]})
    port_convert.save_safetensors(str(tmp_path / "model.safetensors"), sd)
    loaded = port_convert.load_detector(str(tmp_path), port_det.DetectorConfig.tiny(), device="cpu")
    jparams = jax_convert.load_detector_params(str(tmp_path))
    boxes, scores = model.apply({"params": jparams}, jnp.asarray(img), jnp.asarray(ids))
    with torch.no_grad():
        got_boxes, got_scores = loaded(torch.from_numpy(img), torch.from_numpy(ids))
    assert_close(got_scores, scores, MODEL_TOL)
    assert_close(got_boxes, boxes, MODEL_TOL)
    del sd["class_head.dense0.bias"]
    port_convert.save_safetensors(str(tmp_path / "model.safetensors"), sd)
    with pytest.raises(ValueError, match="missing: class_head.dense0.bias"):
        port_convert.load_detector(str(tmp_path), port_det.DetectorConfig.tiny(), device="cpu")


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_clip_vision_dir_loads_like_jax(tmp_path, fmt):
    cfg = jax_clip.CLIPVisionConfig.tiny()
    img = np.random.default_rng(12).standard_normal((1, 32, 32, 3)).astype(np.float32)
    model = jax_clip.CLIPVisionModel(cfg)
    params = numpy_params(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(img))["params"], 4)
    sd = _hf_named(port_convert.clip_vision_entries, params,
                   {"vision_model.embeddings.position_ids": torch.arange(17)[None]})
    if fmt == "safetensors":
        port_convert.save_safetensors(str(tmp_path / "model.safetensors"), sd)
    else:
        torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    loaded = port_convert.load_clip_vision_model(str(tmp_path), port_clip.CLIPVisionConfig.tiny(),
                                                 device="cpu")
    want = model.apply({"params": jax_convert.load_clip_vision_params(str(tmp_path))}, jnp.asarray(img))
    with torch.no_grad():
        assert_close(loaded(torch.from_numpy(img)), want, MODEL_TOL)


# -- against HF transformers ---------------------------------------------------------


def import_transformers():
    """transformers for its torch models only: with ``USE_TF=0`` while it
    first imports, it does not load TensorFlow."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")
        return pytest.importorskip("transformers")


def _hf_sam_to_upstream(sd):
    """transformers SamModel names → segment-anything's; HF's mask-prompt
    embedding (unused by box prompts) and duplicate position matrix are
    dropped."""
    import re

    out = {}
    for n, v in sd.items():
        if n.startswith("prompt_encoder.mask_embed.") or n == "prompt_encoder.shared_embedding.positional_embedding":
            continue
        n = n.replace("vision_encoder.", "image_encoder.").replace("patch_embed.projection", "patch_embed.proj")
        n = re.sub(r"image_encoder\.layers\.(\d+)\.", r"image_encoder.blocks.\1.", n)
        n = n.replace(".layer_norm1.", ".norm1.").replace(".layer_norm2.", ".norm2.")
        n = (n.replace("neck.conv1", "neck.0").replace("neck.norm1", "neck.1")
             .replace("neck.conv2", "neck.2").replace("neck.norm2", "neck.3"))
        if n == "shared_image_embedding.positional_embedding":
            n = "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"
        n = re.sub(r"prompt_encoder\.point_embed\.(\d)\.", r"prompt_encoder.point_embeddings.\1.", n)
        n = re.sub(r"(transformer\.layers\.\d+)\.layer_norm(\d)", r"\1.norm\2", n)
        n = n.replace("transformer.layer_norm_final_attn", "transformer.norm_final_attn")
        n = (n.replace("upscale_conv1", "output_upscaling.0").replace("upscale_layer_norm", "output_upscaling.1")
             .replace("upscale_conv2", "output_upscaling.3"))
        for head in (r"output_hypernetworks_mlps\.\d+", "iou_prediction_head"):
            n = re.sub(rf"({head})\.layers\.0\.", r"\1.layers.1.", n)
            n = re.sub(rf"({head})\.proj_in\.", r"\1.layers.0.", n)
            n = re.sub(rf"({head})\.proj_out\.", r"\1.layers.2.", n)
        out[n] = v
    return out


@pytest.fixture(scope="module")
def hf_sam_unit_scale():
    """HF SamModel (tiny) with its upscaling and hypernetwork weights
    redrawn at std 1 (mask logits of order 10-100, where a mirrored 2x2
    sub-pixel order shows), a pixel batch and its box-prompted logits."""
    transformers = import_transformers()
    torch.manual_seed(3)
    hf_cfg = transformers.SamConfig(
        vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, image_size=64,
                           patch_size=8, output_channels=16, global_attn_indexes=[1], window_size=4,
                           mlp_ratio=4.0, num_pos_feats=8),
        prompt_encoder_config=dict(hidden_size=16, image_embedding_size=8, image_size=64, patch_size=8,
                                   mask_input_channels=4),
        mask_decoder_config=dict(hidden_size=16, num_attention_heads=2, iou_head_hidden_dim=16,
                                 mlp_dim=128),
    )
    model = transformers.SamModel(hf_cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ("upscale" in name or "hypernetworks" in name) and name.endswith("weight"):
                p.normal_(0.0, 1.0)
    px = torch.randn(1, 3, 64, 64)
    with torch.no_grad():
        out = model(pixel_values=px, input_boxes=torch.tensor(BOXES * 64.0 - 0.5)[None],
                    multimask_output=False)
    return model, px, out


def test_sam_matches_hf_at_unit_scale_upscaling(hf_sam_unit_scale):
    """The port loaded from HF's weights (segment-anything's names, its
    kernels as they are) against HF's logits."""
    model, px, out = hf_sam_unit_scale
    want = out.pred_masks[0, :, 0]
    assert want.abs().max() > 5.0
    port = port_convert.load_sam(_hf_sam_to_upstream(model.state_dict()), port_sam.SAMConfig.tiny(),
                                 device="cpu")
    with torch.no_grad():
        got, iou = port(px.permute(0, 2, 3, 1), torch.from_numpy(BOXES))
    assert_rel_close(got, want, MODEL_TOL)
    assert_close(iou, out.iou_scores[0, :, 0], 1e-3)


def jax_sam_against_hf(model, px, out):
    """max |JAX SAM − HF| / max |HF| of the mask logits, with the JAX
    package's converted tree as it is and with up1/up2 flipped."""
    sd = {k: v.numpy() for k, v in _hf_sam_to_upstream(model.state_dict()).items()}
    tree = jax_convert.convert_sam_state_dict(sd)
    flipped = jax.tree_util.tree_map(np.asarray, tree)
    for up in ("up1", "up2"):
        flipped["mask_decoder"][up]["kernel"] = flipped["mask_decoder"][up]["kernel"][::-1, ::-1]
    want = out.pred_masks[0, :, 0].numpy()
    sam = jax_sam.SAM(jax_sam.SAMConfig.tiny())
    img = jnp.asarray(px.permute(0, 2, 3, 1).numpy())
    errs = {}
    for name, params in (("as_is", tree), ("flipped", flipped)):
        got, _ = sam.apply({"params": params}, img, jnp.asarray(BOXES))
        errs[name] = float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())
    return errs


def test_jax_sam_converter_leaves_out_the_transposed_kernel_flip(hf_sam_unit_scale):
    """The fault in the JAX package that the port's converter repairs: its
    tree as converted puts the 4x upsampling's 2x2 sub-pixels in mirrored
    order; with up1/up2 flipped it matches HF."""
    errs = jax_sam_against_hf(*hf_sam_unit_scale)
    assert errs["as_is"] > 0.1 and errs["flipped"] <= MODEL_TOL, errs


def test_detector_matches_hf():
    transformers = import_transformers()
    torch.manual_seed(2)
    cfg = transformers.OwlViTConfig(
        text_config=dict(vocab_size=1000, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=2, max_position_embeddings=16, eos_token_id=999,
                         bos_token_id=998, pad_token_id=0, hidden_act="quick_gelu"),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, image_size=32, patch_size=8, hidden_act="quick_gelu"),
        projection_dim=32,
    )
    model = transformers.OwlViTForObjectDetection(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():  # heads at unit scale: scores away from 0 and 1
            if name.startswith(("class_head", "box_head")) and name.endswith("weight"):
                p.normal_(0.0, p.shape[-1] ** -0.5)
    ids = torch.randint(1, 998, (1, 16))
    ids[0, 7] = 999
    px = torch.randn(1, 3, 32, 32)
    with torch.no_grad():
        out = model(input_ids=ids, pixel_values=px, attention_mask=torch.ones_like(ids))
    hf_scores = torch.sigmoid(out.logits[0, :, 0])
    cxcy, wh = out.pred_boxes[0, :, :2], out.pred_boxes[0, :, 2:]
    hf_boxes = torch.cat([cxcy - wh / 2, cxcy + wh / 2], dim=-1).clamp(0.0, 1.0)
    port = port_convert.load_detector(model.state_dict(), port_det.DetectorConfig.tiny(max_boxes=16),
                                      device="cpu")
    with torch.no_grad():
        boxes, scores = port(px.permute(0, 2, 3, 1), ids)
    order = torch.sort(hf_scores, descending=True, stable=True).indices
    assert_close(scores, hf_scores[order], MODEL_TOL)
    assert_close(boxes, hf_boxes[order], MODEL_TOL)


# -- full-width shapes -----------------------------------------------------------------


def _jax_full_width_shapes(name):
    if name == "sam_vit_h":
        cfg = jax_sam.SAMConfig.vit_h()
        args = (jnp.zeros((1, 1024, 1024, 3)), jnp.zeros((8, 4)))
        return jax_sam.SAM(cfg), args, port_convert.sam_entries
    if name == "owlvit_base_patch32":
        args = (jnp.zeros((1, 768, 768, 3)), jnp.zeros((1, 16), jnp.int32))
        return jax_det.TextBoxDetector(jax_det.DetectorConfig.owlvit_base_patch32()), args, \
            port_convert.detector_entries
    args = (jnp.zeros((1, 224, 224, 3)),)
    return jax_clip.CLIPVisionModel(jax_clip.CLIPVisionConfig.vit_h()), args, port_convert.clip_vision_entries


@pytest.mark.parametrize("name", ["sam_vit_h", "owlvit_base_patch32", "clip_vision_vit_h"])
def test_full_width_modules_have_the_jax_trees_shapes(name):
    """Built on ``meta`` (no memory, no compute), the port's full-width
    modules hold exactly the JAX trees' parameters (``jax.eval_shape``),
    under the converter's names and layouts."""
    model, args, entries_fn = _jax_full_width_shapes(name)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)["params"]
    want = {}
    for path, leaf in port_convert.flatten_tree(
            jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), abstract)).items():
        for key, value in entries_fn(path, leaf):
            want[key] = tuple(value.shape)
    port = {"sam_vit_h": lambda: port_sam.SAM(port_sam.SAMConfig.vit_h(), device="meta"),
            "owlvit_base_patch32": lambda: port_det.TextBoxDetector(
                port_det.DetectorConfig.owlvit_base_patch32(), device="meta"),
            "clip_vision_vit_h": lambda: port_clip.CLIPVisionModel(
                port_clip.CLIPVisionConfig.vit_h(), device="meta")}[name]()
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want


def test_dataclass_configs_match_jax():
    for jax_cfg, port_cfg in [(jax_sam.SAMConfig.vit_h(), port_sam.SAMConfig.vit_h()),
                              (jax_sam.SAMConfig.tiny(), port_sam.SAMConfig.tiny()),
                              (jax_clip.CLIPVisionConfig.vit_h(), port_clip.CLIPVisionConfig.vit_h()),
                              (jax_clip.CLIPVisionConfig.tiny(), port_clip.CLIPVisionConfig.tiny())]:
        a, b = dataclasses.asdict(jax_cfg), dataclasses.asdict(port_cfg)
        a.pop("dtype"), b.pop("dtype")
        assert a == b
    for jax_cfg, port_cfg in [(jax_det.DetectorConfig.owlvit_base_patch32(),
                               port_det.DetectorConfig.owlvit_base_patch32()),
                              (jax_det.DetectorConfig.tiny(), port_det.DetectorConfig.tiny())]:
        for part in ("vision", "text"):
            a = dataclasses.asdict(getattr(jax_cfg, part))
            b = dataclasses.asdict(getattr(port_cfg, part))
            for d in (a, b):
                d.pop("dtype")
                d.pop("remat", None)
            assert a == b
        assert (jax_cfg.embed_dim, jax_cfg.max_boxes) == (port_cfg.embed_dim, port_cfg.max_boxes)
    assert port_clip.CLIP_IMAGE_MEAN == jax_clip.CLIP_IMAGE_MEAN
    assert port_clip.CLIP_IMAGE_STD == jax_clip.CLIP_IMAGE_STD
    assert port_lang_sam.SAM_PIXEL_MEAN == jax_lang_sam.SAM_PIXEL_MEAN
    assert port_lang_sam.SAM_PIXEL_STD == jax_lang_sam.SAM_PIXEL_STD
