"""The torch port's GroundingDINO against the JAX package on the CPU: the
WordPiece tokenizer, BERT under a phrase mask, the Swin backbone (padded,
shifted, a map equal to the window), the static geometry, multi-scale
deformable sampling (inside the maps, on their borders, outside), every
layer class, the whole model and its two-stage query selection under ties,
``DinoDetector``, ``LangSAM`` with the dino backend, the checkpoint loaders
(an HF-layout directory and the original repo's ``.pth``) and the
full-width parameter shapes.

Parameters and inputs come from numpy seeds and go through both packages
(the JAX trees through ``models/convert.py::dino_entries``). Tolerances, in
fp32: 3e-5 per block (atol and rtol), 1e-4 of the largest magnitude for the
model and the detector, whose logits are compared on their finite entries
with the -inf pattern equal.
"""

import dataclasses
import os
import re
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tweediemix_tpu.models import bert as jax_bert
from tweediemix_tpu.models import convert as jax_convert
from tweediemix_tpu.models import dino as jax_dino
from tweediemix_tpu.models import swin as jax_swin
from tweediemix_tpu.segmentation import lang_sam as jax_lang_sam
from tweediemix_tpu.segmentation import sam as jax_sam
from tweediemix_tpu.utils import tokenizer as jax_tok
from tweediemix_tpu_torch.models import bert as port_bert
from tweediemix_tpu_torch.models import convert as port_convert
from tweediemix_tpu_torch.models import dino as port_dino
from tweediemix_tpu_torch.models import swin as port_swin
from tweediemix_tpu_torch.segmentation import lang_sam as port_lang_sam
from tweediemix_tpu_torch.segmentation import sam as port_sam
from tweediemix_tpu_torch.utils import tokenizer as port_tok

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (its synthetic vocab and checkpoint writer)

BLOCK_TOL, MODEL_TOL = 3e-5, 1e-4
# "[CLS] a cat . dog . [SEP] [PAD]" in the synthetic vocab: two phrases and a
# pad, eight tokens as every caption below (one JAX compile of the model)
A, CAT, DOG = (1100 + chip_smoke.BERT_WORDS.index(w) for w in ("a", "cat", "dog"))
IDS = np.array([[101, A, CAT, 1012, DOG, 1012, 102, 0]], np.int64)
CAPTIONS = ("a cat. a dog.", "a photo of a cat", "a photo of a dog")


def numpy_params(abstract, seed):
    """Every leaf of a JAX tree from a numpy seed: norm scales near 1,
    biases small, matrices and kernels N(0, 1/fan_in), vectors and tables
    (relative-position bias, embeddings, layer scales) N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['bias']"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['kernel']") and len(s.shape) >= 2:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def to_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(got, want, tol=BLOCK_TOL):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)


def assert_rel_close(got, want, tol=MODEL_TOL):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), np.abs(got - want).max()


def assert_logits_close(got, want):
    """The -inf pattern equal, the finite entries within 1e-4 of their max."""
    got, want = to_np(got), to_np(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    assert np.isfinite(got[finite]).all()
    assert_rel_close(got[finite], want[finite])


def pair(jax_module, port_module, seed, *args):
    """A JAX module's numpy-seeded tree (its init traced with ``args``) and
    the port module loaded from it."""
    abstract = jax.eval_shape(lambda k: jax_module.init(k, *args), jax.random.PRNGKey(0))["params"]
    params = numpy_params(abstract, seed)
    port_convert.load_params(port_module, params, entries_fn=port_convert.dino_entries)
    return params, port_module.eval()


def tt(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# -- tokenizer, configs, static geometry ---------------------------------------------


PARITY_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat", "dog", "run", "##ning", "##s",
                ".", ",", "photo", "of", "moun", "##tain", "the", "!", "?"]


@pytest.mark.parametrize("text", ["a cat. a dog.", "photo of a cat running, mountain!", "The DOGS run?",
                                  "cat...dog", "zebra cat.", "is it a cat?", "a cät, a dôg",
                                  "x" * 101 + " cat"])
def test_wordpiece_tokenizer_matches_jax(tmp_path, text):
    """tests/test_dino_parity.py's vocabulary and captions, a question, accents
    (NFD, the marks dropped) and a word longer than 100 characters."""
    vf = tmp_path / "vocab.txt"
    vf.write_text("\n".join(PARITY_VOCAB) + "\n")
    want = jax_tok.BertWordPieceTokenizer.from_dir(str(vf))
    got = port_tok.BertWordPieceTokenizer.from_dir(str(tmp_path))
    assert got([text]) == want([text])
    assert got.encode(text) == want.encode(text)


def test_synthetic_vocab_keeps_the_phrase_ids(tmp_path):
    """The card phase's vocab.txt puts [CLS]/[SEP]/"."/"?" at the ids the
    phrase masks key on: a two-phrase caption gives two blocks."""
    chip_smoke.write_bert_vocab(str(tmp_path / "vocab.txt"), 2000)
    tok = port_tok.BertWordPieceTokenizer.from_dir(str(tmp_path))
    ids = np.asarray(tok(["A cat. A dog?"]))
    assert ids.tolist() == [[101, A, CAT, 1012, A, DOG, 1029, 102]]
    assert {len(tok([port_dino.preprocess_caption(c)])[0]) for c in CAPTIONS} == {IDS.shape[1]}
    attend, pos = port_dino.generate_special_token_masks(ids)
    assert attend.sum() == 1 + 9 + 9 + 1 and pos.tolist() == [[0, 0, 1, 2, 0, 1, 2, 0]]


def test_configs_constants_and_geometry_match_jax():
    for jax_cfg, port_cfg in [(jax_dino.DinoConfig.swin_b(), port_dino.DinoConfig.swin_b()),
                              (jax_dino.DinoConfig.tiny(), port_dino.DinoConfig.tiny()),
                              (jax_swin.SwinConfig.swin_t(), port_swin.SwinConfig.swin_t())]:
        assert dataclasses.asdict(jax_cfg) == dataclasses.asdict(port_cfg)
    assert port_swin.SwinConfig.swin_b().out_channels == jax_swin.SwinConfig.swin_b().out_channels
    assert (port_dino.SPECIAL_TOKENS, port_dino.DINO_IMAGE_MEAN, port_dino.DINO_IMAGE_STD) == (
        jax_dino.SPECIAL_TOKENS, jax_dino.DINO_IMAGE_MEAN, jax_dino.DINO_IMAGE_STD)
    for window in (2, 3, 12):
        np.testing.assert_array_equal(port_swin._rel_pos_index(window), jax_swin._rel_pos_index(window))
    for hw, win, shift in [((4, 4), 2, 1), ((6, 9), 3, 1), ((12, 12), 12, 6)]:
        np.testing.assert_array_equal(port_swin._shift_attn_mask(*hw, win, shift),
                                      jax_swin._shift_attn_mask(*hw, win, shift))
    shapes = ((48, 48), (24, 24), (12, 12), (6, 6))
    np.testing.assert_array_equal(port_dino._sine_position_embedding(5, 7, 32, 20.0),
                                  jax_dino._sine_position_embedding(5, 7, 32, 20.0))
    np.testing.assert_array_equal(port_dino._encoder_reference_points(shapes),
                                  jax_dino._encoder_reference_points(shapes))
    for level_shapes in (shapes, ((50, 3), (2, 2), (1, 1))):  # the second has invalid anchors
        for got, want in zip(port_dino._output_proposals(level_shapes),
                             jax_dino._output_proposals(level_shapes)):
            np.testing.assert_array_equal(got, want)
    assert not jax_dino._output_proposals(((50, 3), (2, 2), (1, 1)))[1].all()
    pos = np.random.default_rng(0).random((2, 5, 4)).astype(np.float32)
    for n, flip in [(16, True), (32, False)]:
        assert_close(port_dino.get_sine_pos_embed(torch.from_numpy(pos), n, exchange_xy=flip),
                     jax_dino.get_sine_pos_embed(jnp.asarray(pos), n, exchange_xy=flip))
    x = np.array([0.0, 1e-7, 0.3, 1.0], np.float32)
    assert_close(port_dino.inverse_sigmoid(torch.from_numpy(x)), jax_dino.inverse_sigmoid(jnp.asarray(x)))
    for caption in ("A Cat", "a cat.", "  two dogs  "):
        assert port_dino.preprocess_caption(caption) == jax_dino.preprocess_caption(caption)
    ids = np.array([[101, 5, 1012, 6, 7, 1029, 102, 0], [101, 5, 6, 7, 8, 9, 10, 102]], np.int64)
    for got, want in zip(port_dino.generate_special_token_masks(ids),
                         jax_dino.generate_special_token_masks(ids)):
        np.testing.assert_array_equal(got, want)


def test_stable_top_k_orders_ties_as_jax():
    x = np.array([[0.5, 0.7, 0.5, 0.7, -1e30, 0.1, -1e30, 0.7]], np.float32)
    for k in (1, 3, 5, 8):
        np.testing.assert_array_equal(to_np(port_dino.stable_top_k(torch.from_numpy(x), k)),
                                      np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1]))


# -- backbones -----------------------------------------------------------------------


@pytest.mark.parametrize("mask", ["phrases", "padding", "none"])
def test_bert_text_encoder_matches_jax(mask):
    cfg = jax_bert.BertConfig.tiny()
    attend, pos = jax_dino.generate_special_token_masks(IDS)
    m = {"phrases": attend, "padding": IDS != 0, "none": None}[mask]
    args = (jnp.asarray(IDS), None if m is None else jnp.asarray(m), None, jnp.asarray(pos))
    model = jax_bert.BertTextEncoder(cfg)
    params, port = pair(model, port_bert.BertTextEncoder(port_bert.BertConfig.tiny(), device="cpu"), 1, *args)
    want = jax.jit(lambda p: model.apply({"params": p}, *args))(params)
    with torch.no_grad():
        got = port(*tt(IDS), None if m is None else torch.from_numpy(m), None, torch.from_numpy(pos))
    assert_close(got, want)


@pytest.mark.parametrize("case", ["shifts", "pads", "map equals window"])
def test_swin_backbone_matches_jax(case):
    """8² then 4² maps at window 2; a 9×7 map at window 3 (padded to 9×9,
    then merged from an odd width to 5×4, padded to 6×6); 4² then 2² at
    window 2, the last stage one window, shifted and masked."""
    kw, hw = {"shifts": ({}, (32, 32)), "pads": ({"window_size": 3}, (36, 28)),
              "map equals window": ({"image_size": 16}, (16, 16))}[case]
    x = np.random.default_rng(2).standard_normal((2, *hw, 3)).astype(np.float32)
    model = jax_swin.SwinBackbone(jax_swin.SwinConfig.tiny(**kw))
    params, port = pair(model, port_swin.SwinBackbone(port_swin.SwinConfig.tiny(**kw), device="cpu"), 3,
                        jnp.asarray(x))
    want = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert_close(g, w)


# -- deformable attention and the layers ---------------------------------------------

SHAPES = ((4, 4), (2, 2), (1, 1))
S = sum(h * w for h, w in SHAPES)


@pytest.mark.parametrize("where", ["inside", "borders", "outside"])
def test_multi_scale_deformable_attention_matches_jax(where):
    rng = np.random.default_rng(4)
    value = rng.standard_normal((2, S, 4, 8)).astype(np.float32)
    shape = (2, 5, 4, len(SHAPES), 3, 2)
    if where == "inside":
        locs = rng.uniform(0.05, 0.95, shape)
    elif where == "borders":  # pixel edges and centres of every level, 0 and 1
        locs = rng.choice([0.0, 0.125, 0.25, 0.5, 0.75, 1.0], shape)
    else:
        locs = rng.uniform(-0.6, 1.6, shape)
    locs = locs.astype(np.float32)
    weights = rng.random(shape[:-1]).astype(np.float32)
    want = jax.jit(jax_dino.multi_scale_deformable_attention, static_argnums=1)(
        jnp.asarray(value), SHAPES, jnp.asarray(locs), jnp.asarray(weights))
    got = port_dino.multi_scale_deformable_attention(*tt(value), SHAPES, *tt(locs, weights))
    assert got.shape == (2, 5, 32)
    assert_close(got, want)


def _layer_case(name, c):
    """(JAX module, port module, JAX call, port call) of one layer class on
    inputs from a numpy seed."""
    rng = np.random.default_rng(5)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    d, st, q = c.d_model, 6, 7
    attend, _ = jax_dino.generate_special_token_masks(np.array([[101, A, 1012, A, CAT, 1012]]))
    pad = np.array([[False] * 4 + [True] * 2])
    vision, text, vpos, tpos = r(1, S, d), r(1, st, d), r(1, S, d), r(1, st, d)
    refs2 = rng.random((1, S, len(SHAPES), 2)).astype(np.float32)
    refs4 = np.concatenate([rng.uniform(0.2, 0.8, (1, q, len(SHAPES), 2)),
                            rng.uniform(0.05, 0.4, (1, q, len(SHAPES), 2))], -1).astype(np.float32)
    additive = np.where(pad, np.finfo(np.float32).min, 0.0).astype(np.float32)[:, None, None, :]
    phrase_additive = np.where(attend, 0.0, np.finfo(np.float32).min).astype(np.float32)[:, None]
    cases = {
        "MultiheadAttention": ((d, 4), (r(1, q, d), text, text, additive)),
        "TextEnhancerLayer": ((c,), (text, tpos, phrase_additive)),
        "BiMultiHeadAttention": ((c,), (vision, text, pad)),
        "FusionLayer": ((c,), (vision, text, pad)),
        "DeformableAttention": ((d, 4, 4, len(SHAPES)), (r(1, q, d), vision, r(1, q, d), refs4, SHAPES)),
        "DeformableLayer": ((c,), (vision, vpos, refs2, SHAPES)),
        "EncoderLayer": ((c,), (vision, text, vpos, tpos, refs2, SHAPES, attend, pad)),
        "DecoderLayer": ((c,), (r(1, q, d), r(1, q, d), refs4, vision, text, additive, SHAPES)),
        "MLPHead": ((d, 4, 3), (r(2, q, d),)),
    }
    ctor, args = cases[name]
    jax_mod = getattr(jax_dino, name)(*ctor)
    port_ctor = ((d,) + ctor) if name == "MLPHead" else ctor  # the port's heads take their input width
    port_mod = getattr(port_dino, name)(*(port_dino.DinoConfig.tiny() if a is c else a for a in port_ctor))

    def jax_call(p):
        return jax_mod.apply({"params": p}, *(a if isinstance(a, tuple) else jnp.asarray(a) for a in args))

    def port_call():
        return port_mod(*(a if isinstance(a, tuple) else torch.from_numpy(np.asarray(a)) for a in args))

    return jax_mod, port_mod, args, jax_call, port_call


@pytest.mark.parametrize("name", ["MultiheadAttention", "TextEnhancerLayer", "BiMultiHeadAttention",
                                  "FusionLayer", "DeformableAttention", "DeformableLayer", "EncoderLayer",
                                  "DecoderLayer", "MLPHead"])
def test_layer_matches_jax(name):
    c = jax_dino.DinoConfig.tiny()
    jax_mod, port_mod, args, jax_call, port_call = _layer_case(name, c)
    abstract = jax.eval_shape(
        lambda k: jax_mod.init(k, *(a if isinstance(a, tuple) else jnp.asarray(a) for a in args)),
        jax.random.PRNGKey(0))["params"]
    params = numpy_params(abstract, 6)
    port_convert.load_params(port_mod, params, entries_fn=port_convert.dino_entries)
    want = jax.jit(jax_call)(params)
    with torch.no_grad():
        got = port_call()
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape
        assert_close(g, w)


# -- the whole model -----------------------------------------------------------------


@pytest.fixture(scope="module")
def dino_pair():
    """The tiny JAX GroundingDino with a numpy-seeded tree and its forward
    jitted once, the port model converted from it, a 32² image and the
    caption's masks."""
    cfg = jax_dino.DinoConfig.tiny()
    img = np.random.default_rng(7).standard_normal((1, 32, 32, 3)).astype(np.float32)
    attend, pos = jax_dino.generate_special_token_masks(IDS)
    inputs = (img, IDS, attend, pos, IDS != 0)
    model = jax_dino.GroundingDino(cfg)
    params, port = pair(model, port_dino.GroundingDino(port_dino.DinoConfig.tiny(), device="cpu"), 8,
                        *(jnp.asarray(a) for a in inputs))
    forward = jax.jit(lambda p, *a: model.apply({"params": p}, *a))
    return forward, params, port, inputs


def test_grounding_dino_matches_jax(dino_pair):
    forward, params, port, inputs = dino_pair
    logits, boxes = forward(params, *inputs)
    with torch.no_grad():
        got_logits, got_boxes = port(*tt(*inputs))
    assert got_logits.shape == (1, 10, 16) and got_boxes.shape == (1, 10, 4)
    assert np.isfinite(np.asarray(logits)).sum() == 10 * 7  # the seven real tokens
    assert np.isneginf(np.asarray(logits)).any()  # the pad and past the caption
    assert_logits_close(got_logits, logits)
    assert_rel_close(got_boxes, boxes)


def test_grounding_dino_stages_compose_to_forward(dino_pair):
    _, _, port, inputs = dino_pair
    img, ids, attend, pos, tok = tt(*inputs)
    with torch.no_grad():
        text, text_pos = port.encode_text(ids, attend, pos)
        vision, vision_pos, shapes = port.encode_image(img)
        assert shapes == ((8, 8), (4, 4), (2, 2))
        vision, text = port.encode(vision, text, vision_pos, text_pos, shapes, attend, tok)
        staged = port.decode(vision, text, shapes, tok)
        whole = port(img, ids, attend, pos, tok)
    for a, b in zip(staged, whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_query_selection_ties_keep_the_lower_index(dino_pair):
    """With ``enc_output`` zeroed every encoder position scores the same:
    both packages must then seed the decoder with positions 0..9, in order,
    for the boxes to agree."""
    forward, params, _, inputs = dino_pair
    params = jax.tree_util.tree_map(np.asarray, params)
    params["enc_output"] = {k: np.zeros_like(v) for k, v in params["enc_output"].items()}
    port = port_dino.GroundingDino(port_dino.DinoConfig.tiny(), device="cpu").eval()
    port_convert.load_params(port, params, entries_fn=port_convert.dino_entries)
    logits, boxes = forward(params, *inputs)
    with torch.no_grad():
        got_logits, got_boxes = port(*tt(*inputs))
    assert_logits_close(got_logits, logits)
    assert_rel_close(got_boxes, boxes)


@pytest.fixture(scope="module")
def detector_pair(dino_pair, tmp_path_factory):
    """Both packages' DinoDetector on the tiny models with the synthetic
    vocab (the JAX one through the fixture's jitted forward)."""
    forward, params, port, _ = dino_pair
    root = tmp_path_factory.mktemp("vocab")
    chip_smoke.write_bert_vocab(str(root / "vocab.txt"), 2000)
    jdet = jax_dino.DinoDetector(jax_dino.DinoConfig.tiny(), params,
                                 jax_tok.BertWordPieceTokenizer.from_dir(str(root)))
    jdet._forward = forward
    pdet = port_dino.DinoDetector(port_dino.DinoConfig.tiny(), port,
                                  port_tok.BertWordPieceTokenizer.from_dir(str(root)))
    return jdet, pdet


@pytest.mark.parametrize("hw, caption", [((40, 56), CAPTIONS[0]), ((24, 20), CAPTIONS[1])])
def test_dino_detector_matches_jax(detector_pair, hw, caption):
    """Non-square images resized down and up to 32²: boxes and scores, and
    the same top queries picked from the same model inputs."""
    jdet, pdet = detector_pair
    image = np.random.default_rng(hw[0]).random((*hw, 3)).astype(np.float32)
    boxes, scores = jdet(jnp.asarray(image), caption)
    got_boxes, got_scores = pdet(torch.from_numpy(image), caption)
    assert got_boxes.shape == (4, 4) and got_scores.shape == (4,)
    assert_rel_close(got_scores, scores)
    assert_rel_close(got_boxes, boxes)
    assert bool(((got_boxes >= 0) & (got_boxes <= 1)).all())
    img = jax.image.resize(jnp.asarray(image), (32, 32, 3), "bilinear")
    img = np.asarray((img - jnp.asarray(jax_dino.DINO_IMAGE_MEAN)) / jnp.asarray(jax_dino.DINO_IMAGE_STD))
    ids = np.asarray(jdet.tokenizer([jax_dino.preprocess_caption(caption)]))
    inputs = (img[None], ids, *jax_dino.generate_special_token_masks(ids), ids != 0)
    logits = jdet._forward(jdet.params, *inputs)[0]
    want_idx = jax.lax.top_k(jax.nn.sigmoid(jnp.nan_to_num(logits[0], neginf=-1e30)).max(-1), 4)[1]
    with torch.no_grad():
        got_logits = pdet.model(*tt(*inputs))[0]
    got_scores = torch.sigmoid(torch.nan_to_num(got_logits[0], neginf=-1e30)).max(-1).values
    got_idx = port_dino.stable_top_k(got_scores, 4)
    np.testing.assert_array_equal(to_np(got_idx), np.asarray(want_idx))


# -- LangSAM with the dino backend ---------------------------------------------------


@pytest.fixture(scope="module")
def lang_sam_pair(detector_pair):
    jdet, pdet = detector_pair
    cfg = jax_sam.SAMConfig.tiny()
    img = np.zeros((1, 64, 64, 3), np.float32)
    sam = jax_sam.SAM(cfg)
    abstract = jax.eval_shape(sam.init, jax.random.PRNGKey(0), jnp.asarray(img), jnp.zeros((4, 4)))
    sam_params = numpy_params(abstract["params"], 9)
    port = port_sam.SAM(port_sam.SAMConfig.tiny(), device="cpu").eval()
    port_convert.load_params(port, sam_params, entries_fn=port_convert.sam_entries)
    jls = jax_lang_sam.LangSAM(cfg, sam_params, dino=jdet)
    pls = port_lang_sam.LangSAM(port, dino=pdet)
    return jls, pls


def test_lang_sam_predict_with_dino_matches_jax(lang_sam_pair):
    jls, pls = lang_sam_pair
    image = np.random.default_rng(10).random((48, 40, 3)).astype(np.float32)
    masks, boxes, scores, valid = jls.predict(jnp.asarray(image), CAPTIONS[1])
    got_masks, got_boxes, got_scores, got_valid = pls.predict(torch.from_numpy(image), CAPTIONS[1])
    assert got_masks.shape == (4, 48, 40) and got_masks.dtype == torch.bool
    assert_rel_close(got_scores, scores)
    assert_rel_close(got_boxes, boxes)
    np.testing.assert_array_equal(to_np(got_valid), np.asarray(valid))
    logits = pls.predict_logits(torch.from_numpy(image), CAPTIONS[1])[0].numpy()
    differ = to_np(got_masks) != np.asarray(masks)
    assert not (differ & (np.abs(logits) > MODEL_TOL * np.abs(logits).max())).any()


def test_model_segment_fn_with_dino_matches_jax(lang_sam_pair):
    """A two-concept image through detect → segment → expand → black out →
    resolve overlap, in both packages."""
    jls, pls = lang_sam_pair
    image = np.random.default_rng(11).random((48, 40, 3)).astype(np.float32)
    jls.box_threshold = pls.box_threshold = 0.5
    concepts = "+".join(CAPTIONS[1:])
    want_fn = jax_lang_sam.make_model_segment_fn(jls, concepts)
    got_fn = port_lang_sam.make_model_segment_fn(pls, concepts)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = want_fn(jnp.asarray(image)[None])
        got = got_fn(torch.from_numpy(image)[None])
    assert got.shape == (2, 48, 40)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert [c for c, _ in got_fn.no_detections] == [c for c, _ in want_fn.no_detections]
    assert [c for c, _ in got_fn.top_scores] == list(CAPTIONS[1:])


# -- loaders -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_layout():
    """An HF GroundingDinoForObjectDetection state dict for the tiny config
    (tests/test_dino_parity.py's), every float tensor drawn from a numpy
    seed and the shared box head's copies equal, its buffers kept; each
    test takes a copy."""
    sd = _hf_layout(12)
    return lambda: dict(sd)


def _hf_layout(seed):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")
        from transformers import GroundingDinoForObjectDetection
    from tests.test_dino_parity import _hf_tiny_config

    sd = GroundingDinoForObjectDetection(_hf_tiny_config()).state_dict()
    rng = np.random.default_rng(seed)
    out, head = {}, {}
    for k, v in sd.items():
        if not v.is_floating_point():
            out[k] = v.clone()
            continue
        m = re.match(r"(?:model\.decoder\.)?bbox_embed\.\d+\.(.*)", k)
        leaf = m.group(1) if m else None
        if leaf is not None and leaf in head:
            out[k] = head[leaf].clone()
            continue
        out[k] = torch.from_numpy((0.2 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
        if leaf is not None:
            head[leaf] = out[k]
    return out


def _assert_equals_jax_tree(module, jax_params):
    """The port module holds exactly the JAX tree's leaves (names through
    ``dino_entries``, values and shapes bit for bit)."""
    want = {}
    for path, arr in port_convert.flatten_tree(jax_params).items():
        for name, value in port_convert.dino_entries(path, arr):
            want[name] = value
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("layout", ["hf_safetensors_dir", "hf_bin_dir", "original_pth"])
def test_loader_equals_load_dino_params(tmp_path, hf_layout, layout):
    """One seeded tree written as an HF directory (.safetensors or .bin) and
    as the original repo's .pth ({"model": state dict}, merged q/k/v, the
    box head under every decoder layer): the port's load_dino and the JAX
    load_dino_params read the same values, leaf for leaf."""
    cfg = port_dino.DinoConfig.tiny()
    if layout == "original_pth":
        src = port_convert.load_dino(hf_layout(), cfg, device="cpu")
        path = str(tmp_path / "groundingdino_tiny.pth")
        torch.save({"model": chip_smoke.dino_original_state_dict(src)}, path)
    else:
        sd = hf_layout()
        path = str(tmp_path)
        if layout == "hf_safetensors_dir":
            port_convert.save_safetensors(str(tmp_path / "model.safetensors"), sd)
        else:
            torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    got = port_convert.load_dino(path, cfg, device="cpu")
    jax_params = jax_convert.load_dino_params(path)
    if layout == "original_pth":  # the JAX package's own check of its best-effort rename
        jax_convert.validate_dino_params(jax_dino.DinoConfig.tiny(), jax_params)
    _assert_equals_jax_tree(got, jax_params)


def test_original_layout_round_trips_and_the_card_writer_loads_in_both(tmp_path):
    """chip_smoke's writer (the card phase's full-width .pth) at the tiny
    size: the JAX loader reads the same tree the port's does, and the
    port's original-layout names invert load_dino's."""
    cfg = port_dino.DinoConfig.tiny()
    info = chip_smoke.write_dino_checkpoint(str(tmp_path / "g.pth"), cfg, seed=0, device="cpu")
    got = port_convert.load_dino(str(tmp_path / "g.pth"), cfg, device="cpu")
    assert info["params"] == sum(t.numel() for t in got.parameters())
    _assert_equals_jax_tree(got, jax_convert.load_dino_params(str(tmp_path / "g.pth")))
    again = port_convert.load_dino(chip_smoke.dino_original_state_dict(got), cfg, device="cpu")
    for (k, a), b in zip(got.state_dict().items(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert (tmp_path / "vocab.txt").read_text().splitlines()[1012] == "."


@pytest.mark.parametrize("fault", ["missing", "unexpected", "misshapen"])
def test_loader_raises_on_missing_unexpected_or_misshapen_keys(hf_layout, fault):
    sd = hf_layout()
    if fault == "missing":
        del sd["model.enc_output.bias"]
    elif fault == "unexpected":
        sd["model.encoder.layers.0.fusion_layer.attn.extra"] = torch.zeros(3)
    else:
        sd["model.level_embed"] = torch.zeros(4, 32)
    with pytest.raises(ValueError, match=fault.replace("misshapen", "shape mismatch")):
        port_convert.load_dino(sd, port_dino.DinoConfig.tiny(), device="cpu")


@pytest.mark.parametrize("how", ["missing path", "empty file", "not a checkpoint"])
def test_loader_names_the_file_it_cannot_read(tmp_path, how):
    path = tmp_path / "groundingdino.pth"
    if how == "empty file":
        path.write_bytes(b"")
    elif how == "not a checkpoint":
        path.write_text("not a checkpoint")
    with pytest.raises((FileNotFoundError, ValueError), match=re.escape(str(path))):
        port_convert.load_dino(str(path), port_dino.DinoConfig.tiny(), device="cpu")


def test_full_width_model_has_the_jax_trees_shapes():
    """Built on ``meta``, the port's Swin-B GroundingDINO holds exactly the
    JAX tree's parameters (``jax.eval_shape`` at 384²), under
    ``dino_entries``' names and layouts: 232,313,216 of them."""
    cfg = jax_dino.DinoConfig.swin_b()
    ids = jnp.zeros((1, 8), jnp.int32)
    abstract = jax.eval_shape(jax_dino.GroundingDino(cfg).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 384, 384, 3)), ids, jnp.ones((1, 8, 8), bool), ids,
                              jnp.ones((1, 8), bool))["params"]
    want = {}
    for path, leaf in port_convert.flatten_tree(
            jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), abstract)).items():
        for key, value in port_convert.dino_entries(path, leaf):
            want[key] = tuple(value.shape)
    port = port_dino.GroundingDino(port_dino.DinoConfig.swin_b(), device="meta")
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert sum(t.numel() for t in port.parameters()) == chip_smoke.DINO_SWINB_PARAMS == 232_313_216
    assert sum(t.numel() for t in port.backbone.parameters()) == 86_880_120
    assert sum(t.numel() for t in port.text_backbone.parameters()) == 108_891_648
