"""The torch port's checkpoint loading and concept deltas against the JAX
package on the CPU.

A micro UNet, a tiny VAE and tiny CLIP towers with numpy-seeded weights are
written to ``tmp_path`` in the diffusers / HF layout, as ``.safetensors``
and as ``.bin``; the JAX package's ``load_*_params`` and the port's loaders
read the same files. Tolerances: file contents bitwise; forwards 1e-4
(atol and rtol) in fp32; delta stacks exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch

from tweediemix_tpu.concepts import delta as jax_delta
from tweediemix_tpu.models import clip as jax_clip
from tweediemix_tpu.models import convert as jax_convert
from tweediemix_tpu.models import unet2d as jax_unet2d
from tweediemix_tpu.models import vae as jax_vae
from tweediemix_tpu_torch.concepts import delta as port_delta
from tweediemix_tpu_torch.models import clip as port_clip
from tweediemix_tpu_torch.models import convert as port_convert
from tweediemix_tpu_torch.models import unet2d as port_unet2d
from tweediemix_tpu_torch.models import vae as port_vae

TOL = 1e-4


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


def diffusers_state(params):
    """A JAX UNet or VAE tree under its diffusers names, torch layout."""
    return {port_convert.torch_name(p): torch.from_numpy(np.ascontiguousarray(
        port_convert.torch_layout(p, a))) for p, a in port_convert.flatten_tree(params).items()}


def write_dir(path, state, fmt):
    os.makedirs(path, exist_ok=True)
    if fmt == "safetensors":
        safetensors.torch.save_file(state, os.path.join(path, "diffusion_pytorch_model.safetensors"))
    else:
        torch.save(state, os.path.join(path, "pytorch_model.bin"))
    return path


def micro_unet(seed):
    cfg = jax_unet2d.UNetConfig.micro()
    model = jax_unet2d.UNet2DConditionModel(cfg)
    abstract = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), np.zeros((2, 8, 8, 4), np.float32), jnp.int32(1),
        np.zeros((2, 5, cfg.cross_attention_dim), np.float32),
        np.zeros((2, cfg.pooled_projection_dim), np.float32), np.zeros((2, 6), np.float32),
        np.zeros((2,), np.int32))["params"]
    return model, numpy_params(abstract, seed)


def unet_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 8, 8, 4)).astype(np.float32), 501,
            (0.5 * rng.standard_normal((2, 5, 32))).astype(np.float32),
            (0.5 * rng.standard_normal((2, 32))).astype(np.float32),
            np.tile(np.array([[64.0, 64, 0, 0, 64, 64]], np.float32), (2, 1)))


def port_eps(unet, inputs):
    x, t, ctx, pooled, tids = inputs
    with torch.no_grad():
        return unet(torch.from_numpy(x), t, torch.from_numpy(ctx), torch.from_numpy(pooled),
                    torch.from_numpy(tids)).numpy()


# -- the safetensors reader and writer --------------------------------------------


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "f64": torch.randn(2, generator=g).double(),
        "i64": torch.arange(6).reshape(2, 3),
        "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
        "u8": torch.tensor([0, 255], dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros(0, 4),
    }
    for d in ("theirs", "ours"):
        (tmp_path / d).mkdir()
    theirs = str(tmp_path / "theirs" / "model.safetensors")
    safetensors.torch.save_file(tensors, theirs, metadata={"format": "pt"})
    ours = str(tmp_path / "ours" / "model.safetensors")
    assert port_convert.save_safetensors(ours, tensors) == os.path.getsize(ours)
    want = safetensors.torch.load_file(theirs)
    for d in ("theirs", "ours"):
        got = port_convert.CheckpointDir(str(tmp_path / d))
        assert set(got) == set(want)
        for k, v in want.items():
            assert got.shapes[k] == tuple(v.shape), k
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert torch.equal(got[k], v), k
    back = safetensors.torch.load_file(ours)  # the package reads the port's file
    assert all(torch.equal(back[k], v) for k, v in tensors.items())


def test_safetensors_reader_rejects_a_short_tensor(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    safetensors.torch.save_file({"w": torch.zeros(4)}, path)
    blob = bytearray(open(path, "rb").read())
    blob = blob.replace(b'"shape":[4]', b'"shape":[5]')
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="bytes for shape"):
        port_convert.CheckpointDir(str(tmp_path))


# -- loaders against the JAX package ---------------------------------------------


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_unet_vae_and_clip_dirs_load_like_jax(tmp_path, fmt):
    model, params = micro_unet(seed=3)
    unet_dir = write_dir(tmp_path / "unet", diffusers_state(params), fmt)
    jparams = jax_convert.load_unet_params(unet_dir)
    jax_convert.validate_unet_params(model.config, jparams)
    port = port_convert.load_unet(unet_dir, port_unet2d.UNetConfig.micro(), device="cpu")
    inputs = unet_inputs(0)
    x, t, ctx, pooled, tids = inputs
    want = model.apply({"params": jparams}, x, jnp.int32(t), ctx, pooled, tids)
    np.testing.assert_allclose(port_eps(port, inputs), np.asarray(want), atol=TOL, rtol=TOL)

    vae = jax_vae.AutoencoderKL(jax_vae.VAEConfig.tiny())
    vparams = numpy_params(jax.eval_shape(
        vae.init, jax.random.PRNGKey(0), np.zeros((1, 16, 16, 3), np.float32),
        jax.random.PRNGKey(1))["params"], seed=4)
    vae_dir = write_dir(tmp_path / "vae", diffusers_state(vparams), fmt)
    with open(os.path.join(vae_dir, "config.json"), "w") as f:
        f.write('{"scaling_factor": 0.25, "latents_mean": [0, 1, 2, 3], "latents_std": [1, 1, 2, 2]}')
    overrides = port_convert.vae_config_overrides(vae_dir)
    assert overrides == jax_convert.vae_config_overrides(vae_dir)
    pvae = port_convert.load_vae(vae_dir, port_vae.VAEConfig.tiny(**overrides), device="cpu")
    assert pvae.config.scaling_factor == 0.25
    z = np.random.default_rng(1).standard_normal((1, 4, 4, 4)).astype(np.float32)
    want = vae.apply({"params": jax_convert.load_vae_params(vae_dir)}, z, method=vae.decode)
    with torch.no_grad():
        got = pvae.decode(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)

    ccfg = dict(hidden_act="gelu", projection_dim=24)
    cmodel = jax_clip.CLIPTextModel(jax_clip.CLIPTextConfig.tiny(**ccfg))
    cparams = numpy_params(jax.eval_shape(cmodel.init, jax.random.PRNGKey(0),
                                          np.zeros((1, 77), np.int32))["params"], seed=5)
    hf = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in jax_convert.clip_params_to_hf_state_dict(cparams).items()}
    hf["text_model.embeddings.position_ids"] = torch.arange(77)[None]  # older checkpoints' buffer
    clip_dir = write_dir(tmp_path / "text_encoder_2", hf, fmt)
    ptower = port_convert.load_clip_text_model(clip_dir, port_clip.CLIPTextConfig.tiny(**ccfg),
                                               device="cpu")
    ids = np.random.default_rng(2).integers(0, 1000, size=(2, 77)).astype(np.int32)
    ids[:, 20] = 999
    want = cmodel.apply({"params": jax_convert.load_clip_params(clip_dir)}, ids)
    with torch.no_grad():
        got = ptower(torch.from_numpy(ids).long())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


def test_loaded_unet_equals_the_converted_tree_in_bf16_and_int8():
    """Loading from checkpoint names gives the same state as converting the
    JAX tree: the merged to_qkv, the module's dtype and, under quant, int8
    weights quantised from the fp32 values."""
    _, params = micro_unet(seed=6)
    state = diffusers_state(params)
    for kw in (dict(dtype=torch.bfloat16), dict(quant="int8"), dict(quant="int8_conv")):
        cfg = port_unet2d.UNetConfig.micro(**kw)
        loaded = port_convert.load_unet(state, cfg, device="cpu").state_dict()
        ref = port_convert.load_params(port_unet2d.UNet2DConditionModel(cfg, device="cpu"),
                                       params).state_dict()
        assert set(loaded) == set(ref)
        for k, v in ref.items():
            assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), (kw, k)


def test_loaders_raise_on_missing_unexpected_or_misshapen_keys():
    _, params = micro_unet(seed=7)
    state = diffusers_state(params)
    cfg = port_unet2d.UNetConfig.micro()
    name = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_k.weight"
    missing = {k: v for k, v in state.items() if k != name}
    with pytest.raises(ValueError, match=rf"missing: {name}"):
        port_convert.load_unet(missing, cfg, device="cpu")
    with pytest.raises(ValueError, match=r"unexpected: bogus\.weight"):
        port_convert.load_unet(dict(state, **{"bogus.weight": torch.zeros(2)}), cfg, device="cpu")
    bad = dict(state, **{"conv_in.weight": torch.zeros(32, 4, 1, 1)})
    with pytest.raises(ValueError, match=r"shape mismatch: conv_in\.weight"):
        port_convert.load_unet(bad, cfg, device="cpu")
    tower = port_convert.checkpoint_state_dict(
        port_clip.CLIPTextModel(port_clip.CLIPTextConfig.tiny(), device="cpu"))
    with pytest.raises(ValueError, match=r"unexpected: text_model\.final_layer_norm\.bogus"):
        port_convert.load_clip_text_model(
            dict(tower, **{"text_model.final_layer_norm.bogus": torch.zeros(2)}),
            port_clip.CLIPTextConfig.tiny(), device="cpu")


# -- concept deltas ----------------------------------------------------------------


def _attn_paths(params):
    return sorted({p[: p.index(a) + 1] for p in port_convert.flatten_tree(params)
                   for a in ("attn1", "attn2") if a in p})


def write_deltas(tmp_path, params, rng, lora_rank=None):
    """Three reference delta files: two by the JAX package's
    save_reference_delta (the second lacks one layer), one written as the
    compressed [u, v] form."""
    cross = [p for p in port_convert.flatten_tree(params)
             if p[-3:-1] in (("attn2", "to_k"), ("attn2", "to_v")) and p[-1] == "kernel"]
    files = []
    for i in range(3):
        unet = {}
        if lora_rank is None:
            for p in cross[: len(cross) - (i == 1)]:
                shape = port_convert.flatten_tree(params)[p].shape
                unet[p] = (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
        else:
            for attn in _attn_paths(params):  # the micro UNet's dims are all 32
                for f in ("to_q", "to_k", "to_v", "to_out"):
                    for part, shape in (("down", (32, lora_rank)), ("up", (lora_rank, 32))):
                        unet[attn + ("processor", f"{f}_lora", part, "kernel")] = (
                            0.3 * rng.standard_normal(shape)).astype(np.float32)
        tok = {f"<c{i}>": rng.standard_normal(32).astype(np.float32)}
        tok2 = {f"<c{i}>": rng.standard_normal(32).astype(np.float32)}
        path = str(tmp_path / f"delta-{i}.bin")
        if i == 2:
            compressed = {jax_delta.flax_path_to_torch_name(p): [
                torch.from_numpy(rng.standard_normal((a.shape[1], 3)).astype(np.float32)),
                torch.from_numpy(rng.standard_normal((3, a.shape[0])).astype(np.float32))]
                for p, a in unet.items()}
            torch.save({"unet": compressed,
                        "modifier_token": {k: torch.from_numpy(v) for k, v in tok.items()},
                        "modifier_token_2": {k: torch.from_numpy(v) for k, v in tok2.items()}}, path)
        else:
            jax_delta.save_reference_delta(path, unet, tok, tok2)
        files.append(path)
    return files


def test_reference_deltas_load_and_stack_like_jax(tmp_path):
    _, params = micro_unet(seed=8)
    files = write_deltas(tmp_path, params, np.random.default_rng(9))
    jax_refs = [jax_delta.load_reference_delta(f) for f in files]
    port_refs = [port_delta.load_reference_delta(f) for f in files]
    for jr, pr in zip(jax_refs, port_refs):
        assert set(pr["unet"]) == {jax_delta.flax_path_to_torch_name(p) for p in jr["unet"]}
        for p, a in jr["unet"].items():
            np.testing.assert_allclose(  # [u, v] is multiplied in fp32 on both sides
                pr["unet"][jax_delta.flax_path_to_torch_name(p)].numpy(),
                port_convert.torch_layout(p, a), rtol=1e-6, atol=1e-6)
        for coll in ("modifier_token", "modifier_token_2"):
            assert set(pr[coll]) == set(jr[coll])
            for k in jr[coll]:
                np.testing.assert_array_equal(pr[coll][k].numpy(), jr[coll][k])

    want_tree = jax_delta.stack_cd_params(params, [jax_delta.cd_delta_from_reference(r)
                                                   for r in jax_refs])
    cfg = port_unet2d.UNetConfig.micro(concept_slots=4)
    want = port_convert.convert_params(want_tree, port_unet2d.UNet2DConditionModel(cfg, device="cpu"))
    kvs = [port_delta.cd_delta_from_reference(r) for r in port_refs]
    stacked = port_delta.stack_cd_params(diffusers_state(params), kvs)
    loaded = port_convert.load_unet(diffusers_state(params), cfg, device="cpu",
                                    concept_kvs=kvs).state_dict()
    stack_keys = [k for k in want if k.endswith("_stack")]
    assert len(stack_keys) == 8 and all(k in stacked for k in stack_keys)  # 4 attn2
    for k in stack_keys:
        assert stacked[k].shape == (4, 32, 32)
        np.testing.assert_allclose(stacked[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(loaded[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6)
    # the second delta lacks the last layer: its slot holds the base weight
    last = stack_keys[-1]
    torch.testing.assert_close(stacked[last][2], stacked[last][0], rtol=0, atol=0)


def test_reference_lora_deltas_stack_like_jax(tmp_path):
    _, params = micro_unet(seed=10)
    files = write_deltas(tmp_path, params, np.random.default_rng(11), lora_rank=4)
    jax_loras = [jax_delta.lora_delta_from_reference(jax_delta.load_reference_delta(f)) for f in files]
    port_loras = [port_delta.lora_delta_from_reference(port_delta.load_reference_delta(f))
                  for f in files]
    want_tree = jax_delta.stack_lora_params(params, jax_loras, rank=4)
    cfg = port_unet2d.UNetConfig.micro(lora_slots=4)
    want = port_convert.convert_params(want_tree, port_unet2d.UNet2DConditionModel(cfg, device="cpu"))
    stacked = port_delta.stack_lora_params(diffusers_state(params), port_loras, rank=4)
    loaded = port_convert.load_unet(diffusers_state(params), cfg, device="cpu",
                                    concept_loras=port_loras).state_dict()
    lora_keys = [k for k in want if "_lora_" in k]
    assert len(lora_keys) == 64  # 8 attentions x 8 factors
    for k in lora_keys:
        assert torch.count_nonzero(want[k][0]) == 0
        np.testing.assert_allclose(stacked[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(loaded[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6)
