"""The torch port's prompt-to-image slice against the JAX package on the CPU:
``TweedieMixPipeline.from_concept_checkpoints`` (cd and lora modes),
``prepare_text_embeds`` and a short sample, then the port's CLI and PNG
writer.

Both pipelines are built from the same numpy-seeded micro UNet, tiny VAE
and tiny CLIP trees, toy BPE tokenizers (the second pads with "!") and
three reference delta files with modifier tokens; the initial latent is
fed to both (``x_init``). Tolerances: text embeddings 1e-5, the image of a
6-step sample 1e-4 (atol and rtol), in fp32. The CLI tests are structural:
the CLI's tiny preset draws its own random weights.
"""

import json
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tweediemix_tpu.concepts import delta as jax_delta
from tweediemix_tpu.fusion import pipeline as jax_pipeline
from tweediemix_tpu.fusion import sampler as jax_sampler
from tweediemix_tpu.models import clip as jax_clip
from tweediemix_tpu.models import convert as jax_convert
from tweediemix_tpu.models import unet2d as jax_unet2d
from tweediemix_tpu.models import vae as jax_vae
from tweediemix_tpu.utils import tokenizer as jax_tok
from tweediemix_tpu_torch.cli import fusion_sampling as cli
from tweediemix_tpu_torch.concepts import delta as port_delta
from tweediemix_tpu_torch.fusion import pipeline as port_pipeline
from tweediemix_tpu_torch.fusion import sampler as port_sampler
from tweediemix_tpu_torch.models import clip as port_clip
from tweediemix_tpu_torch.models import convert as port_convert
from tweediemix_tpu_torch.models import unet2d as port_unet2d
from tweediemix_tpu_torch.models import vae as port_vae
from tweediemix_tpu_torch.ops.quant import QLinear
from tweediemix_tpu_torch.utils import tokenizer as port_tok

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TEXT_TOL, IMAGE_TOL = 1e-5, 1e-4
HW = 8  # latent side; masks are 64 x 64, images 16 x 16 (the tiny VAE upsamples twice)
IMG = HW * 2
PROMPT = "photo of a cat running+photo of a dog running+mountain background"
PROMPT_ORIG = "photo of a cat and a dog running"
CONCEPTS, MODIFIERS = "cat+dog+mountain", "<cat1>+<dog1>+<mountain1>"


def numpy_params(abstract, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['bias']"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['embedding']"):
            return rng.standard_normal(s.shape).astype(np.float32)
        fan_in = s.shape[-2] if len(s.shape) == 3 else int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def toy_bpe():
    chars = list(port_tok.bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    n = len(vocab)
    for i, c in enumerate(chars):
        vocab[c + "</w>"] = n + i
    merges = ["c a", "ca t</w>", "d o", "do g</w>"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


def tokenizers(module):
    vocab, merges = toy_bpe()
    return (module.CLIPBPETokenizer(vocab, merges),
            module.CLIPBPETokenizer(vocab, merges, pad_token="!"))


@pytest.fixture(scope="module")
def trees():
    """Numpy-seeded trees: micro UNet (ctx 64 = both towers), tiny VAE and
    two tiny CLIP towers whose tables are the toy vocabulary's size."""
    vocab, _ = toy_bpe()
    ccfg = [dict(vocab_size=len(vocab), eos_token_id=vocab["<|endoftext|>"]),
            dict(vocab_size=len(vocab), eos_token_id=vocab["<|endoftext|>"], hidden_act="gelu",
                 projection_dim=32)]
    clip_params = []
    for i, kw in enumerate(ccfg):
        m = jax_clip.CLIPTextModel(jax_clip.CLIPTextConfig.tiny(**kw))
        clip_params.append(numpy_params(jax.eval_shape(
            m.init, jax.random.PRNGKey(0), np.zeros((1, 77), np.int32))["params"], seed=20 + i))
    ucfg = jax_unet2d.UNetConfig.micro(cross_attention_dim=64)
    unet = jax_unet2d.UNet2DConditionModel(ucfg)
    unet_params = numpy_params(jax.eval_shape(
        unet.init, jax.random.PRNGKey(0), np.zeros((2, HW, HW, 4), np.float32), jnp.int32(1),
        np.zeros((2, 77, 64), np.float32), np.zeros((2, 32), np.float32),
        np.zeros((2, 6), np.float32))["params"], seed=22)
    vae = jax_vae.AutoencoderKL(jax_vae.VAEConfig.tiny())
    vae_params = numpy_params(jax.eval_shape(
        vae.init, jax.random.PRNGKey(0), np.zeros((1, 16, 16, 3), np.float32),
        jax.random.PRNGKey(1))["params"], seed=23)
    return ccfg, clip_params, unet_params, vae_params


def write_deltas(tmp_path, unet_params, clip_params, mode, rng):
    """Three reference deltas (JAX save_reference_delta) with modifier
    embeddings; the first two carry text-tower state, so the second's wins."""
    flat = port_convert.flatten_tree(unet_params)
    files = []
    for i in range(3):
        unet = {}
        for p, a in flat.items():
            if mode == "cd" and p[-3:-1] in (("attn2", "to_k"), ("attn2", "to_v")) and p[-1] == "kernel":
                unet[p] = (rng.standard_normal(a.shape) / np.sqrt(a.shape[0])).astype(np.float32)
            if mode == "lora" and p[-2:] == ("to_q", "kernel") and p[-3] in ("attn1", "attn2"):
                for f in ("to_q", "to_k", "to_v", "to_out"):
                    din = 64 if (p[-3] == "attn2" and f in ("to_k", "to_v")) else 32
                    for part, shape in (("down", (din, 4)), ("up", (4, 32))):
                        unet[p[:-2] + ("processor", f"{f}_lora", part, "kernel")] = (
                            0.2 * rng.standard_normal(shape)).astype(np.float32)
        tok = MODIFIERS.split("+")[i]
        te = {}
        if i < 2:
            for key, params in (("text_encoder", clip_params[0]), ("text_encoder_2", clip_params[1])):
                scaled = jax.tree_util.tree_map(lambda a: np.asarray(a) * (1.0 + 0.01 * (i + 1)), params)
                te[key] = jax_convert.clip_params_to_hf_state_dict(scaled)
        path = str(tmp_path / f"delta-{mode}-{i}.bin")
        jax_delta.save_reference_delta(
            path, unet, {tok: rng.standard_normal(32).astype(np.float32)},
            {tok: rng.standard_normal(32).astype(np.float32)}, **te)
        files.append(path)
    return files


def build_both(tmp_path, trees, mode, fcfg_kw):
    ccfg, clip_params, unet_params, vae_params = trees
    files = write_deltas(tmp_path, unet_params, clip_params, mode, np.random.default_rng(31))
    jtok1, jtok2 = tokenizers(jax_tok)
    ptok1, ptok2 = tokenizers(port_tok)

    jtext = jax_clip.DualTextEncoder(jax_clip.CLIPTextConfig.tiny(**ccfg[0]),
                                     jax_clip.CLIPTextConfig.tiny(**ccfg[1]), *clip_params)
    jvae = jax_vae.AutoencoderKL(jax_vae.VAEConfig.tiny())
    with pytest.warns(UserWarning, match="applying the last"):
        jp = jax_pipeline.TweedieMixPipeline.from_concept_checkpoints(
            unet_params, [jax_delta.load_reference_delta(f) for f in files], MODIFIERS.split("+"),
            jax_unet2d.UNetConfig.micro(cross_attention_dim=64), jvae, vae_params, jtext,
            jtok1, jtok2, jax_sampler.FusionConfig(**fcfg_kw), mode=mode)

    towers = []
    for kw, params in zip(ccfg, clip_params):
        tower = port_clip.CLIPTextModel(port_clip.CLIPTextConfig.tiny(**kw), device="cpu")
        towers.append(port_convert.load_params(tower, params, name_fn=port_convert.clip_torch_name))
    pvae = port_convert.load_params(port_vae.AutoencoderKL(port_vae.VAEConfig.tiny(), device="cpu"),
                                    vae_params)
    base = {port_convert.torch_name(p): torch.from_numpy(np.ascontiguousarray(
        port_convert.torch_layout(p, a))) for p, a in port_convert.flatten_tree(unet_params).items()}
    with pytest.warns(UserWarning, match="applying the last"):
        pp = port_pipeline.TweedieMixPipeline.from_concept_checkpoints(
            base, [port_delta.load_reference_delta(f) for f in files], MODIFIERS.split("+"),
            port_unet2d.UNetConfig.micro(cross_attention_dim=64), pvae,
            port_clip.DualTextEncoder(*towers), ptok1, ptok2,
            port_sampler.FusionConfig(**fcfg_kw), mode=mode, device="cpu")
    return jp, pp


@pytest.mark.parametrize("mode", ["cd", "lora"])
def test_concept_pipeline_embeds_and_sample_match_jax(tmp_path, trees, mode):
    fcfg_kw = dict(n_timesteps=6, guidance_scale=0.8, t_cond=0.34, resampling_steps=1,
                   jumping_steps=1, height=HW * 8, width=HW * 8, num_concepts=3,
                   t_stop=0.5 if mode == "lora" else 1.0)
    jp, pp = build_both(tmp_path, trees, mode, fcfg_kw)
    assert pp.tokenizer_1.convert_tokens_to_ids("<mountain1>") == 520
    assert pp.text.model1.config.vocab_size == pp.text.model2.config.vocab_size == 521

    negative = "blurry, ugly"
    want = jp.prepare_text_embeds(PROMPT, PROMPT_ORIG, CONCEPTS, MODIFIERS, negative_prompt=negative)
    got = pp.prepare_text_embeds(PROMPT, PROMPT_ORIG, CONCEPTS, MODIFIERS, negative_prompt=negative)
    for name, g, w in zip(port_sampler.TextEmbeds._fields, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TEXT_TOL, rtol=TEXT_TOL,
                                   err_msg=name)

    # the "||" per-seed path: two prompt sets stacked on a seed axis
    other = pp.prepare_text_embeds(PROMPT.replace("running", "sitting"), "a cat and a dog",
                                   CONCEPTS, MODIFIERS, negative_prompt=negative)
    jother = jp.prepare_text_embeds(PROMPT.replace("running", "sitting"), "a cat and a dog",
                                    CONCEPTS, MODIFIERS, negative_prompt=negative)
    stacked = port_pipeline.stack_text_embeds([got, other])
    jstacked = jax_pipeline.stack_text_embeds([want, jother])
    for g, w in zip(stacked, jstacked):
        assert g.shape[1] == 2
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TEXT_TOL, rtol=TEXT_TOL)

    fg = np.zeros((2, HW * 8, HW * 8), np.float32)  # --mask_dir-style image masks
    fg[0, :, :29] = 1.0
    fg[1, :, 29:] = 1.0
    x_init = np.random.default_rng(3).standard_normal((1, HW, HW, 4)).astype(np.float32)
    sampler = jax_sampler.FusionSampler(jp.table, jp.fusion_config, jp._unet_fn(),
                                        unet_params=jp.unet_params, kv_builder=jp._kv_builder())
    x = sampler.run(want, jax.random.PRNGKey(0), fg_masks=fg, x_init=jnp.asarray(x_init))
    want_img = np.asarray(jp.decode_final(x))
    got_img = pp.sample(got, fg_masks=fg, x_init=torch.from_numpy(x_init))
    assert got_img.shape == (1, IMG, IMG, 3)
    np.testing.assert_allclose(got_img.numpy(), want_img, atol=IMAGE_TOL, rtol=IMAGE_TOL)


def test_prepare_text_embeds_rejects_mismatched_counts(tmp_path, trees):
    fcfg_kw = dict(n_timesteps=6, height=HW * 8, width=HW * 8, num_concepts=3)
    _, pp = build_both(tmp_path, trees, "cd", fcfg_kw)
    with pytest.raises(ValueError, match="same number of '\\+'-separated entries"):
        pp.prepare_text_embeds("a+b", PROMPT_ORIG, CONCEPTS, MODIFIERS)
    with pytest.raises(ValueError, match="built for 3"):
        pp.prepare_text_embeds("a+b", PROMPT_ORIG, "x+y", "<x>+<y>")


# -- the CLI -------------------------------------------------------------------------


def cli_args(out, *extra):
    return ["--model_preset", "tiny", "--prompt", PROMPT, "--prompt_orig", PROMPT_ORIG,
            "--concepts", CONCEPTS, "--modifier_token", MODIFIERS, "--seg_concepts", "a cat+a dog",
            "--output_path", str(out), "--n_timesteps", "6", "--t_cond", "0.34",
            "--resampling_steps", "1", "--jumping_steps", "1", "--guidance_scale", "0.8",
            "--resolution_h", str(HW * 8), "--resolution_w", str(HW * 8), "--seed", "3821", *extra]


def test_cli_tiny_end_to_end_with_mask_dir(tmp_path, capsys):
    mask_dir = tmp_path / "masks"
    mask_dir.mkdir()
    m = np.zeros((HW * 8, HW * 8), np.uint8)
    m[:, : HW * 4] = 255
    Image.fromarray(m).save(mask_dir / "a cat.jpg")
    Image.fromarray(255 - m).save(mask_dir / "a dog.jpg")
    out = tmp_path / "out"
    assert cli.main(cli_args(out, "--mask_dir", str(mask_dir), "--device", "cuda:1"),
                    device="cpu") == 0
    files = list(out.glob("*.png"))
    assert [f.name for f in files] == [f"{PROMPT_ORIG}_3821.png"]
    img = np.asarray(Image.open(files[0]))
    assert img.shape == (IMG, IMG, 3) and img.dtype == np.uint8
    captured = capsys.readouterr()
    assert "--device is accepted for reference-script compatibility" in captured.err
    timings = json.loads(captured.out.split("timings: ")[1])
    assert set(timings) == {"load_s", "seg_load_s", "build_s", "encode_s", "sample_s", "phases"}


def test_cli_heuristic_segmentation_and_seed_sets(tmp_path, capsys):
    """Without --mask_dir the heuristic segmenter makes the masks from the
    boundary step's preview; "||" gives one image per prompt set."""
    out = tmp_path / "out"
    args = cli_args(out, "--num_seeds", "2")
    assert args[2:6] == ["--prompt", PROMPT, "--prompt_orig", PROMPT_ORIG]
    args[3] = PROMPT + "||" + PROMPT.replace("running", "sitting")
    args[5] = PROMPT_ORIG + "||two pets"
    assert cli.main(args, device="cpu") == 0
    names = sorted(f.name for f in out.glob("*.png"))
    assert names == ["photo of a cat and a dog running_3821.png", "two pets_3822.png"]
    assert "heuristic substitutes" in capsys.readouterr().err
    seg = cli.resolve_segment_fn(cli.build_parser().parse_args(cli_args(out)))
    masks = seg(torch.rand(1, 16, 24, 3))
    assert masks.shape == (2, 16, 24)
    torch.testing.assert_close(masks.sum(0), torch.ones(16, 24))


@pytest.mark.parametrize("extra, error, match", [
    (["--concepts", "cat+dog"], ValueError, "same number of"),
    (["--num_seeds", "3", "--prompt", PROMPT + "||" + PROMPT], ValueError, "must equal --num_seeds"),
    # --mesh_devices is ported (tests/test_torch_port_parallel.py): a mesh of
    # no device raises before anything is built (the id keeps its earlier name)
    pytest.param(["--mesh_devices", "0"], ValueError, "--mesh_devices must be at least 1",
                 id="extra2-NotImplementedError-ROADMAP item 16"),
    # --profile is ported: a trace directory that cannot be made raises before
    # anything is built (the id keeps its earlier name)
    pytest.param(["--profile", __file__], FileExistsError, re.escape(__file__),
                 id="extra3-NotImplementedError-ROADMAP item 16"),
    # GroundingDINO asked for with a checkpoint that is not there, or sniffed
    # from a single file that is not a checkpoint: its load raises naming the
    # file, before SAM loads (the two ids keep their earlier names)
    pytest.param(["--seg_preset", "sam", "--sam_checkpoint", "sam.pth", "--detector_dir", "dino",
                  "--detector", "dino"], FileNotFoundError, "no GroundingDINO checkpoint at dino",
                 id="extra4-NotImplementedError-ROADMAP item 13"),
    pytest.param(["--seg_preset", "sam", "--sam_checkpoint", "sam.pth", "--detector_dir", __file__],
                 ValueError, re.escape(__file__), id="extra5-NotImplementedError-ROADMAP item 13"),
])
def test_cli_error_contracts(tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        cli.main(cli_args(tmp_path / "out", *extra), device="cpu")
    assert not list(tmp_path.glob("**/*.png"))


def test_cli_quant_reads_static_scales_from_the_environment(tmp_path, monkeypatch):
    site = "down_blocks_0_attentions_0/transformer_blocks_0/ff/net_2"
    table = tmp_path / "scales.json"
    table.write_text(json.dumps({site: 3.5}))
    opt = cli.build_parser().parse_args(cli_args(tmp_path, "--quant", "int8", "--mask_dir", "m"))
    monkeypatch.delenv("TWEEDIEMIX_QUANT_STATIC_SCALE", raising=False)
    monkeypatch.delenv("TWEEDIEMIX_QUANT_SCALES", raising=False)
    sites = QLinear
    dynamic = cli.build_pipeline(opt, device="cpu").unet
    assert all(m.static_amax == 0.0 for m in dynamic.modules() if isinstance(m, sites))
    monkeypatch.setenv("TWEEDIEMIX_QUANT_SCALES", str(table))
    static = {m.site: m.static_amax for m in cli.build_pipeline(opt, device="cpu").unet.modules()
              if isinstance(m, sites)}
    assert static[site] == 3.5 and sum(v > 0 for v in static.values()) == 1


def test_save_image_writes_the_pixels_as_png(tmp_path):
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((1, 7, 5, 3)).astype(np.float32))
    img[0, 0, 0] = torch.tensor([0.0, 1.0, 0.999])
    path = str(tmp_path / "x.png")
    port_pipeline.save_image(img, path)
    with Image.open(path) as f:
        assert f.mode == "RGB"
        got = np.asarray(f)
    np.testing.assert_array_equal(got, (img[0].numpy() * 255.0).astype(np.uint8))
    assert got[0, 0].tolist() == [0, 255, 254]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Image.open(path).verify()  # CRCs and chunk layout
