"""The port's image-to-video entry point against the JAX package on the CPU:
the I2VGen-XL UNet checkpoint loader, the CLI's text and image
conditioning, the PIL-exact RGB resize, the GIF writer and reader, and
``cli/run_video.py`` at ``--model_preset tiny``.

Tolerances: the UNet3D loaded from the same diffusers-layout files by both
packages, 1e-4 of max |eps| (fp32, the whole model); the text and image
conditioning, 1e-5 of the largest magnitude (the tiny towers, fp32); the
resize bit for bit against PIL; GIF frames of at most 256 colours exactly,
random frames within the median cut's palette error (stated at the test).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.torch import save_file

from tests.test_torch_port_video import numpy_params
from tweediemix_tpu.models import clip as jax_clip
from tweediemix_tpu.models import unet3d as jax_unet3d
from tweediemix_tpu.models.convert import load_unet3d_params, validate_unet3d_params
from tweediemix_tpu.utils.tokenizer import HashTokenizer as JaxHashTokenizer
from tweediemix_tpu.video.pipeline import export_gif as jax_export_gif
from tweediemix_tpu_torch.cli import run_video
from tweediemix_tpu_torch.models import clip as port_clip
from tweediemix_tpu_torch.models import convert as port_convert
from tweediemix_tpu_torch.models import unet3d as port_unet3d
from tweediemix_tpu_torch.utils import image as port_image
from tweediemix_tpu_torch.utils.tokenizer import HashTokenizer
from tweediemix_tpu_torch.video.pipeline import export_gif

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

MODEL_TOL = 1e-4
COND_TOL = 1e-5
# I2VGen-XL's topology (4 levels with the plain DownBlock3D tail, two
# layers per block, temporal convs and attentions, the image-latent stacks)
# at shrunk widths, as tests/test_convert_strict.py writes it
SHRUNK = dict(block_out_channels=(16, 32, 64, 64), attention_head_dim=8, cross_attention_dim=32,
              norm_num_groups=8, context_pool_size=4)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# -- the I2VGen-XL UNet checkpoint --------------------------------------------------

_TOP = {"image_latents_proj_in_conv1": "image_latents_proj_in.0",
        "image_latents_proj_in_conv2": "image_latents_proj_in.2",
        "image_latents_proj_in_conv3": "image_latents_proj_in.4",
        "image_latents_context_embedding_conv1": "image_latents_context_embedding.0",
        "image_latents_context_embedding_conv2": "image_latents_context_embedding.3",
        "image_latents_context_embedding_conv3": "image_latents_context_embedding.5"}


def diffusers_entry(path, arr):
    """A JAX UNet3D tree leaf → its diffusers ``I2VGenXLUNet`` name and torch
    layout (the JAX converter's inverse, written out here on its own): the
    spatial transformers' ``proj_in``/``proj_out`` as 1x1 convolutions, a
    temporal conv stage's norm at Sequential index 0 and its conv at 2
    (stage 1) or 3."""
    mod, leaf = list(path[:-1]), path[-1]
    top = mod[0]
    m = re.match(r"(down_blocks|up_blocks)_(\d+)_([a-z_]+)_(\d+)$", top)
    mid = re.match(r"mid_block_([a-z_]+)_(\d+)$", top)
    mod[0] = (f"{m[1]}.{m[2]}.{m[3]}.{m[4]}" if m else
              f"mid_block.{mid[1]}.{mid[2]}" if mid else _TOP.get(top, top))
    name = ".".join(mod)
    name = re.sub(r"transformer_blocks_(\d+)", r"transformer_blocks.\1", name)
    name = name.replace("net_0_proj", "net.0.proj").replace("net_2", "net.2")
    name = name.replace("to_out_0", "to_out.0")
    name = re.sub(r"(context_embedding|fps_embedding)\.linear_([12])",
                  lambda mm: f"{mm[1]}.{2 * int(mm[2]) - 2}", name)
    if "temp_convs" in name:
        name = re.sub(r"norm(\d)$", r"conv\1.0", name)
        name = re.sub(r"conv(\d)$", lambda mm: f"conv{mm[1]}." + ("2" if mm[1] == "1" else "3"), name)
    spatial = "attentions" in top and "temp_attentions" not in top
    if leaf == "kernel":
        if arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif spatial and path[-2] in ("proj_in", "proj_out"):
            arr = arr.T[:, :, None, None]
        else:
            arr = arr.T
    return f"{name}.{'weight' if leaf in ('kernel', 'scale') else leaf}", arr


def _unet3d_inputs(seed):
    rng = np.random.default_rng(seed)
    f, hw = 2, 8
    return (rng.standard_normal((1, f, hw, hw, 4)).astype(np.float32),
            (0.3 * rng.standard_normal((1, 5, 32))).astype(np.float32),
            (0.3 * rng.standard_normal((1, f, hw, hw, 4))).astype(np.float32),
            (0.3 * rng.standard_normal((1, 1, 32))).astype(np.float32),
            np.full((1,), 8.0, np.float32))


@pytest.fixture(scope="module")
def unet3d_dir(tmp_path_factory):
    """A diffusers-layout ``unet/`` directory of numpy-seeded weights at the
    shrunk topology (written with the ``safetensors`` package), and the
    JAX tree it holds."""
    cfg = jax_unet3d.UNet3DConfig.i2vgen(**SHRUNK)
    sample, ctx, il, emb, _ = _unet3d_inputs(0)
    abstract = jax.eval_shape(jax_unet3d.UNet3DConditionModel(cfg).init, jax.random.PRNGKey(0),
                              sample, jnp.int32(1), ctx, il, emb, jnp.float32(8.0))["params"]
    params = numpy_params(abstract, 30)
    sd = {}
    for path, arr in port_convert.flatten_tree(params).items():
        name, value = diffusers_entry(path, arr)
        assert name not in sd, name
        sd[name] = torch.from_numpy(np.ascontiguousarray(value))
    d = tmp_path_factory.mktemp("unet")
    save_file(sd, str(d / "diffusion_pytorch_model.safetensors"))
    return str(d), params, sd


def test_load_unet3d_matches_jax(unet3d_dir):
    """Both packages load the same files; the JAX loader gives back the
    tree that was written, and the two models agree at 1e-4 of max |eps|."""
    path, params, _ = unet3d_dir
    cfg = jax_unet3d.UNet3DConfig.i2vgen(**SHRUNK)
    jparams = load_unet3d_params(path)
    validate_unet3d_params(cfg, jparams)
    flat_want = port_convert.flatten_tree(params)
    flat_got = port_convert.flatten_tree(jparams)
    assert set(flat_got) == set(flat_want)
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k])
    model = jax_unet3d.UNet3DConditionModel(cfg)
    sample, ctx, il, emb, fps = _unet3d_inputs(1)
    want = np.asarray(jax.jit(lambda p: model.apply({"params": p}, sample, jnp.int32(601), ctx, il,
                                                    emb, fps, 1.0, 1.0, 0.7))(jparams))
    port = port_convert.load_unet3d(path, port_unet3d.UNet3DConfig.i2vgen(**SHRUNK), device="cpu")
    assert not any(p.is_meta for p in port.parameters())
    with torch.no_grad():
        got = port(_t(sample), 601, _t(ctx), _t(il), _t(emb), _t(fps), 1.0, 1.0, 0.7)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= MODEL_TOL * np.abs(want).max()


@pytest.mark.parametrize("fault", ["missing", "unexpected", "mis-shaped"])
def test_load_unet3d_rejects_a_wrong_key(unet3d_dir, fault):
    _, _, sd = unet3d_dir
    sd = dict(sd)
    name = "down_blocks.0.temp_attentions.0.transformer_blocks.0.attn2.to_k.weight"
    if fault == "missing":
        del sd[name]
        match = rf"missing: {re.escape(name)}"
    elif fault == "unexpected":
        sd["down_blocks.0.attentions.0.proj_mid.weight"] = torch.zeros(4, 4)
        match = r"unexpected: down_blocks\.0\.attentions\.0\.proj_mid\.weight"
    else:
        sd[name] = sd[name][:, :-1]
        match = rf"shape mismatch: {re.escape(name)}"
    with pytest.raises(ValueError, match=match):
        port_convert.load_unet3d(sd, port_unet3d.UNet3DConfig.i2vgen(**SHRUNK), device="cpu")


@pytest.mark.parametrize("quant", ["int8", "int8_conv"])
def test_load_unet3d_quantises_as_the_tree_converter_does(unet3d_dir, quant):
    """Under quant the checkpoint load gives the int8 weights and scales
    (and the kept float cross-attention K/V) that converting the JAX tree
    gives: the module the W8A8 parity tests hold against the JAX package."""
    path, params, _ = unet3d_dir
    cfg = port_unet3d.UNet3DConfig.i2vgen(quant=quant, **SHRUNK)
    loaded = port_convert.load_unet3d(path, cfg, device="cpu").state_dict()
    want = port_convert.load_params(port_unet3d.UNet3DConditionModel(cfg, device="cpu"),
                                    params).state_dict()
    assert set(loaded) == set(want)
    assert any(k.endswith("attn2.to_qkv.weight_q") for k in loaded)
    for k in want:
        torch.testing.assert_close(loaded[k], want[k], atol=0, rtol=0, msg=k)


# -- the CLI's text and image conditioning ---------------------------------------------


@pytest.fixture(scope="module")
def towers():
    """The tiny CLIP text and vision towers of the JAX CLI's tiny preset,
    every leaf from a numpy seed, and the port's loaded with them."""
    tcfg = jax_clip.CLIPTextConfig.tiny()
    text = jax_clip.CLIPTextModel(tcfg)
    tparams = numpy_params(jax.eval_shape(text.init, jax.random.PRNGKey(0),
                                          np.zeros((1, 77), np.int32))["params"], 31)
    vcfg = jax_clip.CLIPVisionConfig.tiny(projection_dim=tcfg.hidden_size)
    vision = jax_clip.CLIPVisionModel(vcfg)
    vparams = numpy_params(jax.eval_shape(vision.init, jax.random.PRNGKey(0),
                                          np.zeros((1, 32, 32, 3), np.float32))["params"], 32)
    ptext = port_convert.load_params(port_clip.CLIPTextModel(port_clip.CLIPTextConfig.tiny(),
                                                             device="cpu"), tparams,
                                     name_fn=port_convert.clip_torch_name)
    pvision = port_convert.load_params(
        port_clip.CLIPVisionModel(port_clip.CLIPVisionConfig.tiny(projection_dim=32), device="cpu"),
        vparams, entries_fn=port_convert.clip_vision_entries)
    return (text, tparams, vision, vparams), (ptext.eval(), pvision.eval())


def _assert_rel(got, want, tol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


def test_text_conditioning_matches_the_jax_cli(towers):
    """``final_layer_norm`` of the penultimate hidden states for the prompt
    and the negative prompt (``run_video.py``'s ``encode(...)[3]``)."""
    (text, tparams, _, _), (ptext, _) = towers
    prompts = ["a cat and a dog running", run_video.build_parser().get_default("negative_prompt")]
    tok, jtok = HashTokenizer(1000), JaxHashTokenizer(1000)
    assert tok(prompts) == [list(r) for r in jtok(prompts)]
    got = run_video.encode_prompts(ptext, tok, prompts)
    for i, p in enumerate(prompts):
        want = text.apply({"params": tparams}, jnp.asarray(jtok([p]), jnp.int32))[3]
        _assert_rel(got[i : i + 1], want, COND_TOL)


@pytest.mark.parametrize("mode,size,hw", [("RGB", (45, 37), (40, 48)), ("RGBA", (20, 30), (24, 16)),
                                          ("L", (64, 64), (32, 32))])
def test_image_conditioning_matches_the_jax_cli(towers, tmp_path, mode, size, hw):
    """The VAE input (the picture as RGB, resized with PIL's default filter,
    in [-1, 1]) exactly, and the CLIP embedding (antialiased bilinear to the
    tower's size, CLIP statistics) at 1e-5, against the JAX CLI's own
    operations on a PNG of each mode."""
    (_, _, vision, vparams), (_, pvision) = towers
    h, w = hw
    rng = np.random.default_rng(sum(size))
    channels = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    pixels = rng.integers(0, 256, (size[1], size[0], channels)).astype(np.uint8)
    path = str(tmp_path / "picture.png")
    Image.fromarray(pixels.squeeze(-1) if channels == 1 else pixels, mode).save(path)

    img = Image.open(path).convert("RGB").resize((w, h))
    img01 = jnp.asarray(np.asarray(img, np.float32) / 255.0)[None]
    clip_in = jax.image.resize(img01, (1, 32, 32, 3), "bilinear")
    clip_in = (clip_in - jnp.asarray(jax_clip.CLIP_IMAGE_MEAN)) / jnp.asarray(jax_clip.CLIP_IMAGE_STD)
    want_emb = vision.apply({"params": vparams}, clip_in)[:, None, :]

    got01 = run_video.read_conditioning_image(path, h, w)
    np.testing.assert_array_equal(got01.numpy(), np.asarray(img01))
    np.testing.assert_array_equal((got01 * 2.0 - 1.0).numpy(), np.asarray(img01 * 2.0 - 1.0))
    _assert_rel(run_video.encode_image(pvision, got01), want_emb, COND_TOL)


@pytest.mark.parametrize("shape,hw", [((37, 45), (24, 16)), ((20, 30), (512, 512)),
                                      ((64, 48), (64, 100)), ((33, 33), (33, 33))])
def test_resize_rgb_is_pils_default_resize(shape, hw):
    rgb = np.random.default_rng(shape[0]).integers(0, 256, shape + (3,)).astype(np.uint8)
    want = np.asarray(Image.fromarray(rgb, "RGB").resize((hw[1], hw[0])))
    np.testing.assert_array_equal(port_image.resize_rgb(rgb, *hw), want)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_read_image_gives_pils_rgb(tmp_path, mode):
    channels = len(mode)
    pixels = np.random.default_rng(channels).integers(0, 256, (9, 7, channels)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(pixels.squeeze(-1) if channels == 1 else pixels, mode).save(path)
    got = port_image.read_image(path)
    assert got.shape == (9, 7, 3)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))


# -- GIF ---------------------------------------------------------------------------------


def _pil_frames(path):
    with Image.open(path) as gif:
        frames, durations = [], []
        for i in range(gif.n_frames):
            gif.seek(i)
            frames.append(np.asarray(gif.convert("RGB")))
            durations.append(gif.info.get("duration"))
        return np.stack(frames), durations, gif.info.get("loop"), gif.size


def _few_colours(rng, shape, n):
    palette = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    return palette[rng.integers(0, n, shape)]


def test_export_gif_writes_what_the_jax_export_gif_writes(tmp_path):
    """Frame count, size, the 125 ms delay stored as 12 cs, loop 0 and (at
    ≤ 256 colours) the pixels, as PIL reads the JAX package's GIF (written
    by PIL) and the port's (written by its own writer)."""
    rng = np.random.default_rng(40)
    video = _few_colours(rng, (3, 20, 28), 200).astype(np.float32) / 255.0
    jax_export_gif(jnp.asarray(video), str(tmp_path / "jax.gif"), fps=8)
    export_gif(torch.from_numpy(video), str(tmp_path / "port.gif"), fps=8)
    jframes, jdur, jloop, jsize = _pil_frames(str(tmp_path / "jax.gif"))
    pframes, pdur, ploop, psize = _pil_frames(str(tmp_path / "port.gif"))
    assert (psize, ploop) == (jsize, jloop) == ((28, 20), 0)
    assert pdur == jdur == [120, 120, 120]
    np.testing.assert_array_equal(pframes, jframes)
    header, frames = port_image.read_gif(str(tmp_path / "port.gif"))
    assert header == dict(width=28, height=20, loop=0, durations_ms=[120, 120, 120])
    np.testing.assert_array_equal(frames, pframes)


@pytest.mark.parametrize("colours", [1, 2, 5, 256])
def test_gif_round_trips_frames_of_at_most_256_colours(tmp_path, colours):
    rng = np.random.default_rng(colours)
    frames = np.stack([_few_colours(rng, (33, 17), colours) for _ in range(4)])
    path = str(tmp_path / "x.gif")
    port_image.write_gif(path, frames, duration_ms=40)
    pil, durations, loop, _ = _pil_frames(path)
    np.testing.assert_array_equal(pil, frames)
    assert durations == [40] * 4 and loop == 0
    header, back = port_image.read_gif(path)
    np.testing.assert_array_equal(back, frames)


def test_gif_palette_error_on_random_frames(tmp_path):
    """Uniformly random frames (far more than 256 colours, and long enough
    that the LZW table fills and is cleared): PIL and the port's reader
    decode the same pixels, within the median cut's error of the input:
    mean |error| ≤ 12 and max ≤ 48 levels per channel (10.7 and 38 here;
    10.8 and 33 on one 512² frame)."""
    frames = np.random.default_rng(41).integers(0, 256, (2, 96, 80, 3)).astype(np.uint8)
    path = str(tmp_path / "noise.gif")
    port_image.write_gif(path, frames, duration_ms=125)
    pil, durations, _, _ = _pil_frames(path)
    _, back = port_image.read_gif(path)
    np.testing.assert_array_equal(back, pil)
    err = np.abs(back.astype(np.int64) - frames)
    assert err.mean() <= 12 and err.max() <= 48, (err.mean(), err.max())
    assert durations == [120, 120]


def test_read_gif_reads_pils_gifs(tmp_path):
    rng = np.random.default_rng(42)
    frames = [Image.fromarray(_few_colours(rng, (24, 30), 64)) for _ in range(3)]
    path = str(tmp_path / "pil.gif")
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=250, loop=0)
    header, back = port_image.read_gif(path)
    pil, durations, _, _ = _pil_frames(path)
    np.testing.assert_array_equal(back, pil)
    assert header["durations_ms"] == durations and header["loop"] == 0


# -- the CLI -----------------------------------------------------------------------------


def _cli(tmp_path, *extra):
    png = str(tmp_path / "fused.png")
    port_image.write_png(png, np.random.default_rng(43).integers(0, 256, (40, 48, 3)).astype(np.uint8))
    out = str(tmp_path / "out" / "clip.gif")
    argv = ["--model_preset", "tiny", "--image", png, "--prompt", "a cat and a dog running",
            "--output", out, "--num_frames", "3", "--height", "32", "--width", "32",
            "--n_timesteps", "3", *extra]
    return run_video.main(argv, device="cpu"), out


@pytest.mark.parametrize("quant", [None, "int8", "int8_conv"])
def test_video_cli_writes_a_gif_of_num_frames(tmp_path, capsys, quant):
    rc, out = _cli(tmp_path, *(["--quant", quant] if quant else []))
    assert rc == 0
    header, frames = port_image.read_gif(out)
    assert frames.shape == (3, 32, 32, 3) and header["durations_ms"] == [120] * 3
    assert frames.min() < frames.max()
    text = capsys.readouterr().out
    timings = json.loads(text.split("timings: ", 1)[1].splitlines()[0])
    assert set(timings) == {"load_s", "build_s", "encode_s", "generate_s", "write_s", "phases"}
    assert os.listdir(os.path.dirname(out)) == ["clip.gif"]


def test_video_cli_writes_one_gif_per_seed(tmp_path):
    rc, out = _cli(tmp_path, "--num_seeds", "2", "--fps", "4")
    assert rc == 0
    assert sorted(os.listdir(os.path.dirname(out))) == ["clip.gif", "clip_1.gif"]
    first, second = (port_image.read_gif(os.path.join(os.path.dirname(out), f)) for f in
                     ("clip.gif", "clip_1.gif"))
    assert first[1].shape == second[1].shape == (3, 32, 32, 3)
    assert first[0]["durations_ms"] == [250] * 3
    assert not np.array_equal(first[1], second[1])  # each clip from its own noise


def test_video_cli_mesh_devices_raises(tmp_path):
    """``--mesh_devices 2`` runs (``tests/test_torch_port_parallel.py``); a
    clip count that does not divide over the devices raises the JAX
    package's message."""
    with pytest.raises(AssertionError, match="clip batch 3 must divide over 2 devices"):
        _cli(tmp_path, "--num_seeds", "3", "--mesh_devices", "2")


def test_video_cli_has_every_flag_of_the_jax_cli():
    from tweediemix_tpu.cli import run_video as jax_run_video

    def flags(parser):
        return {a.dest: (a.default, a.type, tuple(a.choices or ()), a.required)
                for a in parser._actions if a.dest != "help"}

    assert flags(run_video.build_parser()) == flags(jax_run_video.build_parser())
