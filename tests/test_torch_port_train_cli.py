"""The torch port's training CLI and its data path against the JAX package
on the CPU: the dataset batch for batch, the built augment library against
its numpy version, class-image sampling, the tiny CLI end to end in
Custom-Diffusion and LoRA modes (its deltas read by the JAX package and
sampled by the port's fusion CLI, a JAX-trained delta sampled by the port),
resume, and the flags.

Images are PNGs written with the port's writer. Tolerances are stated in
each test.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tweediemix_tpu.concepts.delta import load_reference_delta as jax_load_delta
from tweediemix_tpu.training import data as jax_data
from tweediemix_tpu.utils.tokenizer import HashTokenizer as JaxHashTokenizer
from tweediemix_tpu_torch.cli import fusion_sampling
from tweediemix_tpu_torch.cli import train as port_train
from tweediemix_tpu_torch.concepts.delta import (
    load_reference_delta,
    lora_delta_from_reference,
    save_reference_delta,
)
from tweediemix_tpu_torch.training import augment
from tweediemix_tpu_torch.training import data as port_data
from tweediemix_tpu_torch.utils.image import read_png, write_png
from tweediemix_tpu_torch.utils.tokenizer import HashTokenizer

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


@pytest.fixture
def image_dirs(tmp_path):
    """Three instance PNGs (one gray) and four class PNGs of other shapes."""
    inst, cls = tmp_path / "inst", tmp_path / "cls"
    inst.mkdir()
    cls.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        write_png(str(inst / f"{i}.png"), rng.randint(0, 255, (96, 80, 3), np.uint8))
    write_png(str(inst / "3.png"), rng.randint(0, 255, (50, 120), np.uint8))
    for i, shape in enumerate([(64, 64, 3), (80, 64, 3), (64, 100, 3), (70, 70, 3)]):
        write_png(str(cls / f"{i}.png"), rng.randint(0, 255, shape, np.uint8))
    return str(inst), str(cls)


@pytest.mark.parametrize("hflip,center_crop", [(False, False), (True, True)])
def test_dataset_matches_jax_batch_for_batch(image_dirs, hflip, center_crop):
    """``CustomDiffusionDataset`` on the same seed gives the JAX package's
    batches exactly (the same numpy draws, the same augment source built
    with the same flags, the same pixels read)."""
    inst, cls = image_dirs
    kw = dict(size=64, with_prior_preservation=True, hflip=hflip, center_crop=center_crop,
              seed=3, latent_factor=8, num_class_images=3)
    want = jax_data.CustomDiffusionDataset(
        [jax_data.ConceptSpec(inst, "photo of a <new1> cat", cls, "photo of a cat")],
        JaxHashTokenizer(), JaxHashTokenizer(), **kw)
    got = port_data.CustomDiffusionDataset(
        [port_data.ConceptSpec(inst, "photo of a <new1> cat", cls, "photo of a cat")],
        HashTokenizer(), HashTokenizer(), **kw)
    assert len(got) == len(want) == 4
    for a, b in zip(got.batches(2, 3), want.batches(2, 3)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["pixel_values"].shape == (4, 64, 64, 3) and a["mask"].shape == (4, 8, 8, 1)


def test_augment_library_matches_its_numpy_version():
    """The built library against the numpy versions within 1e-5 (fp32 on
    one sampling grid), paste offsets past the canvas included."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for th, tw, oy, ox, size, ms in [(20, 30, 5, 7, 64, 8), (64, 64, 0, 0, 64, 32), (9, 70, 50, -6, 64, 8),
                                     (1, 1, 3, 3, 16, 8)]:
        got = augment.paste_augment(img, th, tw, oy, ox, size, ms)
        want = augment.paste_augment_reference(img, th, tw, oy, ox, size, ms)
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got[1], want[1])
    for size, cy, cx in [(32, 0, 5), (37, 0, 0), (20, 9, 40)]:
        np.testing.assert_allclose(augment.resize_crop_normalize(img, size, cy, cx),
                                   augment.resize_crop_normalize_reference(img, size, cy, cx),
                                   atol=1e-5, rtol=0)
    assert augment.library_path().exists()


def test_resumed_batches_continue_the_stream(image_dirs):
    """``batches(start=...)`` continues where the unbroken stream is."""
    inst, cls = image_dirs

    def dataset():
        return port_data.CustomDiffusionDataset(
            [port_data.ConceptSpec(inst, "a <new1> cat", cls, "a cat")], HashTokenizer(),
            HashTokenizer(), size=32, seed=1, hflip=True)

    whole = list(dataset().batches(1, 5))
    rest = list(dataset().batches(1, 2, start=3))
    for a, b in zip(whole[3:], rest):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_text2img_scan_matches_jax():
    """The class-image DDIM loop with guidance against the JAX package's
    on the same micro UNet weights and initial noise: x0 within 1e-4."""
    from tweediemix_tpu.models import unet2d as jax_unet2d
    from tweediemix_tpu.schedulers.ddim import DDIMTable as JaxTable
    from tweediemix_tpu.training.class_gen import text2img_scan as jax_scan
    from tweediemix_tpu_torch.models import unet2d as port_unet2d
    from tweediemix_tpu_torch.models.convert import load_params
    from tweediemix_tpu_torch.schedulers.ddim import DDIMTable
    from tweediemix_tpu_torch.training.class_gen import text2img_scan

    jcfg = jax_unet2d.UNetConfig.micro()
    model = jax_unet2d.UNet2DConditionModel(jcfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx2 = (0.3 * rng.standard_normal((2, 5, 32))).astype(np.float32)
    pooled2 = (0.3 * rng.standard_normal((2, 32))).astype(np.float32)
    tids = np.array([[64.0, 64, 0, 0, 64, 64]], np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x, jnp.int32(1), ctx2, pooled2,
                                 np.tile(tids, (2, 1)))["params"]

    def unet_fn(p, xx, t, cx, pl, idx):
        return model.apply({"params": p}, xx, t, cx, pl, jnp.tile(tids, (xx.shape[0], 1)), idx)

    want = jax.jit(lambda p, xx: jax_scan(JaxTable.create(n_steps=4), unet_fn, p, ctx2, pooled2,
                                          xx, 6.0))(params, x)
    port = port_unet2d.UNet2DConditionModel(port_unet2d.UNetConfig.micro(), device="cpu")
    load_params(port, jax.tree_util.tree_map(np.asarray, params))
    ptids = torch.from_numpy(tids)

    def port_fn(xx, t, cx, pl):
        return port(xx, t, cx, pl, ptids.expand(xx.shape[0], -1))

    got = text2img_scan(DDIMTable.create(n_steps=4), port_fn, torch.from_numpy(ctx2),
                        torch.from_numpy(pooled2), torch.from_numpy(x), 6.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def _masks(tmp_path):
    mask_dir = tmp_path / "masks"
    mask_dir.mkdir()
    m = np.zeros((32, 32), np.uint8)
    m[:, :16] = 255
    write_png(str(mask_dir / "a cat.png"), m)
    write_png(str(mask_dir / "a dog.png"), 255 - m)
    return str(mask_dir)


def _sample(tmp_path, delta, mode, name):
    """The port's fusion CLI at --model_preset tiny with ``delta`` as all
    three concepts, at 64² (16² pixels out of the tiny VAE); returns the
    PNG's header and pixels."""
    out = tmp_path / name
    mask_dir = str(tmp_path / "masks") if (tmp_path / "masks").exists() else _masks(tmp_path)
    rc = fusion_sampling.main([
        "--model_preset", "tiny", "--mode", mode,
        "--personal_checkpoint", f"{delta}+{delta}+{delta}",
        "--prompt", "photo of a cat running+photo of a dog running+mountain background",
        "--prompt_orig", "photo of a cat and a dog", "--concepts", "cat+dog+mountain",
        "--modifier_token", "<new1>+<new2>+<new3>", "--seg_concepts", "a cat+a dog",
        "--mask_dir", mask_dir,
        "--output_path", str(out), "--n_timesteps", "4", "--t_cond", "0.5",
        "--resampling_steps", "0", "--jumping_steps", "0",
        "--resolution_h", "64", "--resolution_w", "64"], device="cpu")
    assert rc == 0
    (png,) = out.glob("*.png")
    ihdr, pixels = read_png(str(png))
    assert (ihdr["width"], ihdr["height"]) == (16, 16) and pixels.min() < pixels.max()
    return ihdr, pixels


def _train_args(inst, cls, out, *extra):
    return ["--model_preset", "tiny", "--instance_data_dir", inst,
            "--instance_prompt", "photo of a <new1> cat", "--class_data_dir", cls,
            "--class_prompt", "photo of a cat", "--with_prior_preservation",
            "--num_class_images", "2", "--modifier_token", "<new1>", "--resolution", "64",
            "--max_train_steps", "3", "--save_steps", "100", "--output_dir", str(out),
            "--learning_rate", "1e-3", "--gradient_checkpointing", *extra]


@pytest.mark.parametrize("freeze_model,train_text_encoder",
                         [("crossattn_kv", False), ("lora", False), ("crossattn_kv", True),
                          ("lora", True)])
def test_cli_tiny_trains_a_delta_the_fusion_cli_samples(tmp_path, capsys, freeze_model,
                                                       train_text_encoder):
    """The tiny CLI (class images generated into an empty class dir, prior
    preservation, a modifier token, remat) writes ``delta-3.bin``: the JAX
    package's ``load_reference_delta`` reads it with the reference schema
    (the trained K/V or LoRA processor weights, one row per tower, and
    under --train_text_encoder both towers' state dicts), and the port's
    fusion CLI samples it in the matching mode."""
    inst = tmp_path / "inst"
    inst.mkdir()
    rng = np.random.RandomState(1)
    for i in range(2):
        write_png(str(inst / f"{i}.png"), rng.randint(0, 255, (48, 40, 3), np.uint8))
    cls, out, logs = tmp_path / "cls", tmp_path / "ckpt", tmp_path / "logs"
    extra = ["--freeze_model", freeze_model, "--logging_dir", str(logs)]
    extra += ["--train_text_encoder"] if train_text_encoder else []
    assert port_train.main(_train_args(str(inst), str(cls), out, *extra), device="cpu") == 0
    records = [json.loads(line) for line in open(logs / "train.metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and "prior_loss" in r for r in records)
    stdout = capsys.readouterr().out
    assert "generated 2 class images" in stdout
    assert sorted(os.listdir(cls)) == ["00000.png", "00001.png"]
    timings = json.loads(stdout.split("timings: ")[1])
    assert timings["steps"] == 3 and timings["step_s"] > 0
    delta = out / "delta-3.bin"
    assert sorted(os.listdir(out)) == ["delta-3.bin"]

    st = load_reference_delta(str(delta))
    jst = jax_load_delta(str(delta))
    names = set(st["unet"])
    if freeze_model == "lora":
        assert len(names) == 2 * 4 * 2 * 4  # 4 attentions x 2 (attn1, attn2) x q/k/v/out x down/up
        assert all(".processor.to_" in n and "_lora." in n for n in names)
    else:
        assert len(names) == 2 * 4 and all(n.endswith(("attn2.to_k.weight", "attn2.to_v.weight"))
                                           for n in names)
    assert len(jst["unet"]) == len(names)
    for coll in ("modifier_token", "modifier_token_2"):
        assert list(st[coll]) == ["<new1>"] and st[coll]["<new1>"].shape == (32,)
        np.testing.assert_array_equal(np.asarray(jst[coll]["<new1>"]), st[coll]["<new1>"].numpy())
    assert ("text_encoder" in st) == ("text_encoder_2" in st) == train_text_encoder
    if train_text_encoder:
        assert st["text_encoder"]["text_model.embeddings.token_embedding.weight"].shape == (1001, 32)

    _sample(tmp_path, delta, "lora" if freeze_model == "lora" else "cd", "sample")


def test_jax_trained_delta_samples_in_the_port(tmp_path, image_dirs):
    """A delta of the JAX package's tiny CLI goes through the port's fusion
    CLI, and the port reads the same tensors from it as the JAX package."""
    from tweediemix_tpu.cli.train import main as jax_train

    inst, cls = image_dirs
    out = tmp_path / "jax_ckpt"
    args = _train_args(inst, cls, out, "--dp_devices", "1")
    args.remove("--gradient_checkpointing")
    assert jax_train(args) == 0
    delta = out / "delta-3.bin"
    st, jst = load_reference_delta(str(delta)), jax_load_delta(str(delta))
    assert len(st["unet"]) == len(jst["unet"]) == 8
    _sample(tmp_path, delta, "cd", "from_jax")


def test_cli_resume_continues_the_run(tmp_path, image_dirs):
    """2 steps, then ``--resume_step 2`` for 2 more, give the delta of 4
    unbroken steps (the masters, AdamW's moments and the data and noise
    streams all continue): equal within 1e-6, under accumulation 2."""
    inst, cls = image_dirs

    def run(out, steps, *extra):
        args = _train_args(inst, cls, out, "--gradient_accumulation_steps", "2",
                           "--save_steps", "2", *extra)
        args[args.index("--max_train_steps") + 1] = str(steps)
        assert port_train.main(args, device="cpu") == 0
        return load_reference_delta(str(out / f"delta-{steps}.bin"))

    whole = run(tmp_path / "whole", 4)
    run(tmp_path / "split", 2)
    assert (tmp_path / "split" / "resume" / "state_2.pt").exists()
    resumed = run(tmp_path / "split", 4, "--resume_step", "2")
    for coll in ("unet", "modifier_token", "modifier_token_2"):
        assert set(whole[coll]) == set(resumed[coll])
        for k in whole[coll]:
            torch.testing.assert_close(resumed[coll][k], whole[coll][k], rtol=0, atol=1e-6)


def test_cli_flags_and_defaults_match_jax():
    """Every flag (name, destination, default, choices) of the JAX CLI."""
    from tweediemix_tpu.cli.train import build_parser as jax_parser

    def flags(parser):
        return {tuple(a.option_strings): (a.dest, a.default, a.choices, a.nargs, type(a).__name__)
                for a in parser._actions if a.option_strings and a.dest != "help"}

    assert flags(port_train.build_parser()) == flags(jax_parser())


@pytest.mark.parametrize("extra, error, match", [
    (["--dp_devices", "2", "--multihost", "--coordinator_address", "127.0.0.1:1",
      "--num_processes", "3", "--process_id", "0"], SystemExit, "one rank per device"),
    (["--multihost"], ValueError, "--coordinator_address"),
], ids=["extra0", "extra1"])
def test_cli_data_parallel_is_not_ported(tmp_path, monkeypatch, extra, error, match):
    """Data parallelism is ported (``tests/test_torch_port_parallel_train.py``);
    its flags are checked before any process group is joined or anything is
    written: ``--multihost`` runs one rank per device, and needs a
    coordinator. The name and ids are kept from when both flags raised."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(error, match=match):
        port_train.main(["--model_preset", "tiny", "--instance_data_dir", str(tmp_path),
                         "--instance_prompt", "a cat", "--output_dir", str(tmp_path / "o"),
                         *extra], device="cpu")
    assert not (tmp_path / "o").exists()


def test_lora_delta_names_the_fusion_loaders_read(tmp_path):
    """The JAX trainer keeps a LoRA factor under its stacked name, which the
    JAX package's own ``lora_delta_from_reference`` maps to nothing; the
    port writes the reference's processor names, which both packages'
    loaders map onto the factor (the trained slot, transposed back)."""
    from tweediemix_tpu.concepts.delta import lora_delta_from_reference as jax_lora_from_ref
    from tweediemix_tpu.concepts.delta import save_reference_delta as jax_save
    from tweediemix_tpu_torch.training.trainer import extract_delta

    prefix = "down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    down = np.random.default_rng(0).standard_normal((1, 32, 4)).astype(np.float32)
    jax_path = ("down_blocks_0_attentions_0", "transformer_blocks_0", "attn1", "to_q_lora_down")
    jax_file = str(tmp_path / "jax.bin")
    jax_save(jax_file, {jax_path: down}, {}, {})
    assert jax_lora_from_ref(jax_load_delta(jax_file)) == {}

    unet, _, _ = extract_delta({f"unet/{prefix}.to_q_lora_down": torch.from_numpy(down)}, [], [], [])
    port_file = str(tmp_path / "port.bin")
    save_reference_delta(port_file, unet, {}, {})
    got = jax_lora_from_ref(jax_load_delta(port_file))
    np.testing.assert_array_equal(np.asarray(got[tuple(jax_path[:3]) + ("to_q_lora_down",)]),
                                  down[0])
    mine = lora_delta_from_reference(load_reference_delta(port_file))
    np.testing.assert_array_equal(mine[f"{prefix}.to_q_lora_down"].numpy(), down[0])


def test_vae_encode_with_given_noise_matches_jax():
    """``encode_latents`` (one posterior draw, scaled, fp32) with the noise
    handed over equals the JAX CLI's encode on the same tiny VAE weights
    within 1e-5."""
    from tweediemix_tpu.models.vae import AutoencoderKL as JaxVAE
    from tweediemix_tpu.models.vae import VAEConfig as JaxVAEConfig
    from tweediemix_tpu.models.vae import scale_latents as jax_scale
    from tweediemix_tpu_torch.models.convert import load_params
    from tweediemix_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from tweediemix_tpu_torch.training.trainer import encode_latents

    jcfg = JaxVAEConfig.tiny()
    vae = JaxVAE(jcfg)
    rng = np.random.default_rng(0)
    px = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    params = jax.jit(vae.init)(jax.random.PRNGKey(0), px, jax.random.PRNGKey(1))["params"]
    mean, logvar = vae.apply({"params": params}, px, method=vae.encode)
    noise = rng.standard_normal(mean.shape).astype(np.float32)
    want = jax_scale(mean + jnp.exp(0.5 * logvar) * noise, jcfg)
    port = AutoencoderKL(VAEConfig.tiny(), device="cpu")
    load_params(port, jax.tree_util.tree_map(np.asarray, params))
    got = encode_latents(port, torch.from_numpy(px), noise=torch.from_numpy(noise))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_retrieve_offline_raises(tmp_path, monkeypatch):
    """Without a network the LAION retrieval raises RuntimeError (the CLI
    then samples class images) and writes no caption file."""
    from tweediemix_tpu_torch.training import retrieve

    def no_route(*args, **kwargs):
        raise OSError("no route")

    monkeypatch.setattr(retrieve.urllib.request, "urlopen", no_route)
    with pytest.raises(RuntimeError, match="offline"):
        retrieve.retrieve("photo of a cat", str(tmp_path / "cls"), 4)
    assert not (tmp_path / "cls" / "caption.txt").exists()
