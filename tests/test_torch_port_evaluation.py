"""The port's CLIP-T / CLIP-I evaluation (``evaluation.py``,
``cli/evaluate.py``) against the JAX package on the CPU.

Parameters come from numpy seeds and go into both packages' towers.
Tolerances: ``clip_preprocess`` 1e-5 (atol); L2-normalised embeddings 1e-5
(atol); ``clip_t``/``clip_i`` 1e-4 (atol), all fp32. The JAX package's own
``tests/test_evaluation.py`` cases are repeated against the port.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tweediemix_tpu import evaluation as jax_eval
from tweediemix_tpu.models import clip as jax_clip
from tweediemix_tpu.models.convert import clip_params_to_hf_state_dict
from tweediemix_tpu.utils import tokenizer as jax_tok
from tweediemix_tpu_torch import evaluation as port_eval
from tweediemix_tpu_torch.cli import evaluate as port_cli
from tweediemix_tpu_torch.models import clip as port_clip
from tweediemix_tpu_torch.models import convert as port_convert
from tweediemix_tpu_torch.utils import tokenizer as port_tok
from tweediemix_tpu_torch.utils.image import write_png

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

PRE_TOL, EMBED_TOL, SCORE_TOL = 1e-5, 1e-5, 1e-4
PROJ = 32


def numpy_params(abstract, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['bias']"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith(("['embedding']", "['class_embedding']", "['position_embedding']")):
            return rng.standard_normal(s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def tiny_trees(seed=0, **text_kw):
    tcfg = jax_clip.CLIPTextConfig.tiny(projection_dim=PROJ, **text_kw)
    vcfg = jax_clip.CLIPVisionConfig.tiny(projection_dim=PROJ)
    tparams = numpy_params(jax.eval_shape(jax_clip.CLIPTextModel(tcfg).init, jax.random.PRNGKey(0),
                                          jnp.zeros((1, 8), jnp.int32))["params"], seed)
    vparams = numpy_params(jax.eval_shape(
        jax_clip.CLIPVisionModel(vcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, vcfg.image_size, vcfg.image_size, 3)))["params"], seed + 1)
    return tcfg, vcfg, tparams, vparams


@pytest.fixture(scope="module")
def scorers():
    """The JAX scorer and the port's on one numpy-seeded tiny tree."""
    tcfg, vcfg, tparams, vparams = tiny_trees()
    want = jax_eval.CLIPScorer(tcfg, vcfg, tparams, vparams, jax_tok.HashTokenizer(1000))
    text = port_clip.CLIPTextModel(port_clip.CLIPTextConfig.tiny(projection_dim=PROJ), device="cpu")
    port_convert.load_params(text, tparams, name_fn=port_convert.clip_torch_name)
    vision = port_clip.CLIPVisionModel(port_clip.CLIPVisionConfig.tiny(projection_dim=PROJ),
                                       device="cpu")
    port_convert.load_params(vision, vparams, entries_fn=port_convert.clip_vision_entries)
    return want, port_eval.CLIPScorer(text, vision, port_tok.HashTokenizer(1000))


def images(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in shapes]


SHAPES = [(40, 56), (56, 40), (24, 24), (9, 70), (100, 33)]


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("hw, size", [((40, 56), 32), ((56, 40), 32), ((12, 20), 32),
                                      ((300, 200), 64), ((64, 64), 64), ((17, 90), 8)],
                         ids=["landscape", "portrait", "upscaled", "downscaled", "same", "wide"])
def test_clip_preprocess_matches_jax(hw, size):
    img = np.random.default_rng(hw[0]).random((*hw, 3)).astype(np.float32)
    want = jax_eval.clip_preprocess(jnp.asarray(img), size)
    got = port_eval.clip_preprocess(torch.from_numpy(img), size)
    assert got.shape == (size, size, 3)
    _close(got, want, PRE_TOL)


def test_embeddings_and_scores_match_jax(scorers):
    want, got = scorers
    gen, inst = images(0, SHAPES[:3]), images(1, SHAPES[3:])
    texts = ["a photo of a cat", "a dog", "photo of a cat and a dog running"]
    _close(got.embed_texts(texts), want.embed_texts(texts), EMBED_TOL)
    _close(got.embed_images(gen + inst), want.embed_images(gen + inst), EMBED_TOL)
    prompts = ["photo of a <new1> cat", "a <new2> dog", "two pets"]
    assert got.clip_t(gen, prompts, ["<new1>", "<new2>"]) == pytest.approx(
        want.clip_t(gen, prompts, ["<new1>", "<new2>"]), abs=SCORE_TOL)
    assert got.clip_t(gen, ["a cat"]) == pytest.approx(want.clip_t(gen, ["a cat"]), abs=SCORE_TOL)
    assert got.clip_i(gen, inst) == pytest.approx(want.clip_i(gen, inst), abs=SCORE_TOL)


def write_clip_model_dir(path, tparams, vparams, tcfg, vcfg, extras=True):
    """An HF CLIPModel directory as the JAX package's
    ``test_from_pretrained_combined_checkpoint`` writes it: both towers and
    projections in one ``pytorch_model.bin`` (with the contrastive
    temperature and position-id buffers HF keeps), ``config.json`` with its
    historical eos id of 2, and byte-level tokenizer files."""
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in clip_params_to_hf_state_dict(tparams).items()}
    for path_, arr in port_convert.flatten_tree(vparams).items():
        for name, value in port_convert.clip_vision_entries(path_, arr):
            sd[name] = torch.from_numpy(np.ascontiguousarray(value, np.float32))
    if extras:
        sd["logit_scale"] = torch.tensor(2.6592)
        sd["text_model.embeddings.position_ids"] = torch.arange(tcfg.max_positions)[None]
        sd["vision_model.embeddings.position_ids"] = torch.arange(
            (vcfg.image_size // vcfg.patch_size) ** 2 + 1)[None]
    os.makedirs(path, exist_ok=True)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "projection_dim": PROJ,
            "text_config": {
                "vocab_size": tcfg.vocab_size, "hidden_size": tcfg.hidden_size,
                "intermediate_size": tcfg.intermediate_size, "num_hidden_layers": tcfg.num_layers,
                "num_attention_heads": tcfg.num_heads,
                "max_position_embeddings": tcfg.max_positions, "hidden_act": tcfg.hidden_act,
                "eos_token_id": 2,
            },
            "vision_config": {
                "image_size": vcfg.image_size, "patch_size": vcfg.patch_size,
                "hidden_size": vcfg.hidden_size, "intermediate_size": vcfg.intermediate_size,
                "num_hidden_layers": vcfg.num_layers, "num_attention_heads": vcfg.num_heads,
                "hidden_act": vcfg.hidden_act,
            },
        }, f)
    toks = [v + "</w>" for v in port_tok.bytes_to_unicode().values()]
    toks += list(port_tok.bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(toks)}
    vocab["<|startoftext|>"] = 510
    vocab["<|endoftext|>"] = 511
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    return sd


def test_from_pretrained_combined_checkpoint_matches_jax(tmp_path):
    tcfg, vcfg, tparams, vparams = tiny_trees(seed=5, vocab_size=512, eos_token_id=511)
    write_clip_model_dir(str(tmp_path), tparams, vparams, tcfg, vcfg)
    want = jax_eval.CLIPScorer.from_pretrained(str(tmp_path))
    got = port_eval.CLIPScorer.from_pretrained(str(tmp_path), device="cpu")
    # the text tower pools at the tokenizer's EOS, not config.json's 2
    assert got.text_model.config.eos_token_id == want.text_cfg.eos_token_id == 511
    assert got.vision_model.config == port_clip.CLIPVisionConfig(
        **{f: getattr(want.vision_cfg, f) for f in ("image_size", "patch_size", "hidden_size",
                                                     "intermediate_size", "num_layers",
                                                     "num_heads", "hidden_act",
                                                     "projection_dim")})
    gen, inst = images(2, SHAPES[:2]), images(3, SHAPES[2:])
    texts = ["a cat", "photo of a dog running"]
    _close(got.embed_texts(texts), want.embed_texts(texts), EMBED_TOL)
    _close(got.embed_images(gen), want.embed_images(gen), EMBED_TOL)
    assert got.clip_t(gen, ["a <x> cat"], ["<x>"]) == pytest.approx(
        want.clip_t(gen, ["a <x> cat"], ["<x>"]), abs=SCORE_TOL)
    assert got.clip_i(gen, inst) == pytest.approx(want.clip_i(gen, inst), abs=SCORE_TOL)


@pytest.mark.parametrize("fault", ["missing", "unexpected", "misshapen"])
def test_from_pretrained_raises_on_missing_unexpected_or_misshapen_tensors(tmp_path, fault):
    tcfg, vcfg, tparams, vparams = tiny_trees(seed=6, vocab_size=512, eos_token_id=511)
    sd = write_clip_model_dir(str(tmp_path), tparams, vparams, tcfg, vcfg)
    if fault == "missing":
        del sd["visual_projection.weight"]
    elif fault == "unexpected":
        sd["vision_model.encoder.layers.9.mlp.fc1.weight"] = torch.zeros(2, 2)
    else:
        sd["text_projection.weight"] = torch.zeros(PROJ, 8)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    with pytest.raises(ValueError, match=fault.replace("misshapen", "shape mismatch")):
        port_eval.CLIPScorer.from_pretrained(str(tmp_path), device="cpu")


# -- the JAX package's tests/test_evaluation.py cases, against the port ------------


def test_strip_modifier_tokens():
    assert (port_eval.strip_modifier_tokens("photo of a <new1> cat and a <new2> dog",
                                            ["<new1>", "<new2>"]) == "photo of a cat and a dog")
    assert port_eval.strip_modifier_tokens("a cat", []) == "a cat"


def test_clip_preprocess_center_crops_and_normalizes():
    img = np.zeros((16, 64, 3), np.float32)
    img[:, 16:48] = 1.0
    out = port_eval.clip_preprocess(torch.from_numpy(img), 8)
    assert out.shape == (8, 8, 3)
    want = (1.0 - np.asarray(port_clip.CLIP_IMAGE_MEAN)) / np.asarray(port_clip.CLIP_IMAGE_STD)
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(want, (8, 8, 3)), atol=1e-4)


def test_tiny_scorer_metrics_are_bounded_and_deterministic():
    scorer = port_eval.CLIPScorer.tiny(device="cpu")
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 255, (40, 56, 3), np.uint8) for _ in range(3)]
    np.testing.assert_allclose(scorer.embed_images(imgs).norm(dim=-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(scorer.embed_texts(["a cat", "a dog"]).norm(dim=-1).numpy(), 1.0,
                               atol=1e-5)
    assert scorer.clip_i(imgs[:1], imgs[:1]) == pytest.approx(1.0, abs=1e-5)
    a = scorer.clip_t(imgs, ["a photo of a cat"])
    assert a == scorer.clip_t(imgs, ["a photo of a cat"]) and -1.0 <= a <= 1.0
    assert scorer.clip_t(imgs, ["a photo of a <new1> cat"], ["<new1>"]) == pytest.approx(a, abs=1e-6)
    with pytest.raises(ValueError):
        scorer.clip_t(imgs, ["a", "b"])
    # seeded: a second scorer gives the same scores
    assert port_eval.CLIPScorer.tiny(device="cpu").clip_t(imgs, ["a photo of a cat"]) == a


def test_load_image_paths_dir_and_glob(tmp_path):
    for name in ("b.png", "a.jpg", "notes.txt"):
        (tmp_path / name).write_text("x")
    got = port_eval.load_image_paths(str(tmp_path))
    assert [os.path.basename(p) for p in got] == ["a.jpg", "b.png"]
    assert got == jax_eval.load_image_paths(str(tmp_path))
    got = port_eval.load_image_paths(str(tmp_path / "*.png"))
    assert [os.path.basename(p) for p in got] == ["b.png"]
    with pytest.raises(FileNotFoundError):
        port_eval.load_image_paths(str(tmp_path / "*.webp"))


def test_evaluate_cli_prints_the_jax_clis_line(tmp_path, capsys):
    """Both CLIs over the same PNGs and one numpy-seeded CLIPModel
    directory: the same JSON line (scores rounded to 4 places, which can
    differ by one unit in the last place where a score sits on a rounding
    boundary: held at 1e-4)."""
    from tweediemix_tpu.cli.evaluate import main as jax_main

    tcfg, vcfg, tparams, vparams = tiny_trees(seed=7, vocab_size=512, eos_token_id=511)
    clip_dir = tmp_path / "clip"
    write_clip_model_dir(str(clip_dir), tparams, vparams, tcfg, vcfg)
    dirs = {"gen": images(4, SHAPES[:2]), "cat": images(5, SHAPES[2:4]), "dog": images(6, SHAPES[4:])}
    for d, imgs in dirs.items():
        (tmp_path / d).mkdir()
        for i, im in enumerate(imgs):
            write_png(str(tmp_path / d / f"{i}.png"), im)
    argv = ["--images", str(tmp_path / "gen"), "--prompt", "photo of a <new1> cat and a <new2> dog",
            "--modifier_token", "<new1>+<new2>", "--concept_images",
            f"{tmp_path / 'cat'}+{tmp_path / 'dog'}", "--concepts", "cat+dog",
            "--clip_dir", str(clip_dir)]
    assert port_cli.main(argv + ["--output", str(tmp_path / "port.json")], device="cpu") == 0
    got_line = capsys.readouterr().out.strip()
    assert jax_main(argv + ["--output", str(tmp_path / "jax.json")]) == 0
    want_line = capsys.readouterr().out.strip()
    got, want = json.loads(got_line), json.loads(want_line)
    assert list(got) == list(want) == ["num_images", "clip_t", "clip_i"]
    assert got["num_images"] == want["num_images"] == 2
    assert got["clip_t"] == pytest.approx(want["clip_t"], abs=SCORE_TOL)
    assert list(got["clip_i"]) == ["cat", "dog"]
    for k in want["clip_i"]:
        assert got["clip_i"][k] == pytest.approx(want["clip_i"][k], abs=SCORE_TOL)
    assert json.loads((tmp_path / "port.json").read_text()) == got


def test_evaluate_cli_tiny_preset_without_concepts(tmp_path, capsys):
    (tmp_path / "gen").mkdir()
    for i, im in enumerate(images(8, SHAPES[:3])):
        write_png(str(tmp_path / "gen" / f"{i}.png"), im)
    assert port_cli.main(["--images", str(tmp_path / "gen"), "--prompt", "a||b||c",
                          "--model_preset", "tiny"], device="cpu") == 0
    result = json.loads(capsys.readouterr().out)
    assert set(result) == {"num_images", "clip_t"} and -1.0 <= result["clip_t"] <= 1.0
    with pytest.raises(SystemExit):
        port_cli.main(["--images", str(tmp_path / "gen"), "--prompt", "a"], device="cpu")
