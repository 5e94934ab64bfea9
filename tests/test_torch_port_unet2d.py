"""The torch port's UNet2D and embeddings against the JAX package on the CPU.

Parameters (the JAX model's tree, filled from a numpy seed) go into the port
through ``tweediemix_tpu_torch.models.convert``; inputs come from numpy
seeds too.
Tolerance: 1e-4 (atol and rtol) on whole micro/tiny models, for sum-order
differences across a few dozen fp32 layers; 3e-5 on single functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tweediemix_tpu.models import unet2d as jax_unet2d
from tweediemix_tpu.models.embeddings import timestep_embedding as jax_timestep_embedding
from tweediemix_tpu_torch.models import unet2d as port_unet2d
from tweediemix_tpu_torch.models.convert import (
    convert_params,
    load_params,
    merge_self_attention_qkv,
    torch_layout,
    torch_name,
)
from tweediemix_tpu_torch.models.embeddings import timestep_embedding

MODEL_TOL = 1e-4


def numpy_params(abstract, seed):
    """A parameter tree of the JAX model's shapes, filled from a numpy seed
    (fan-in scaled kernels, norm scales near 1, non-zero LoRA up-factors
    with slot 0 kept at zero)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['bias']"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = s.shape[-2] if len(s.shape) == 3 else int(np.prod(s.shape[:-1]))
        a = (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "lora_up" in name:
            a[0] = 0.0
        return a

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def _case(preset, kw, seed=0):
    """JAX model, numpy params and inputs, and the port model loaded with
    the same params through the converter."""
    jcfg = getattr(jax_unet2d.UNetConfig, preset)(**kw)
    model = jax_unet2d.UNet2DConditionModel(jcfg)
    rng = np.random.default_rng(seed)
    hw = 8
    x = (0.4 * rng.standard_normal((3, hw, hw, 4))).astype(np.float32)
    ctx = (0.2 * rng.standard_normal((3, 9, jcfg.cross_attention_dim))).astype(np.float32)
    pooled = (0.2 * rng.standard_normal((3, jcfg.pooled_projection_dim))).astype(np.float32)
    tids = np.tile(np.array([[64.0, 64, 0, 0, 64, 64]], np.float32), (3, 1))
    slots = max(kw.get("concept_slots", 0), kw.get("lora_slots", 0), 1)
    idx = (np.arange(3) % slots).astype(np.int32)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, jnp.int32(5), ctx, pooled,
                              tids, idx)["params"]
    params = numpy_params(abstract, seed)
    port = port_unet2d.UNet2DConditionModel(getattr(port_unet2d.UNetConfig, preset)(**kw),
                                            device="cpu")
    load_params(port, params)
    inputs = (x, ctx, pooled, tids, idx)
    return model, params, port, inputs


def _port_inputs(inputs):
    x, ctx, pooled, tids, idx = inputs
    return (torch.from_numpy(x), torch.from_numpy(ctx), torch.from_numpy(pooled),
            torch.from_numpy(tids), torch.from_numpy(idx).long())


@pytest.mark.parametrize(
    "preset,kw",
    [("micro", dict(concept_slots=3)), ("tiny", dict()), ("tiny", dict(concept_slots=4)),
     ("tiny", dict(lora_slots=3))],
)
def test_unet_eps_matches_jax(preset, kw):
    model, params, port, inputs = _case(preset, kw)
    x, ctx, pooled, tids, idx = inputs
    want = model.apply({"params": params}, x, jnp.int32(501), ctx, pooled, tids, idx)
    px, pctx, ppooled, ptids, pidx = _port_inputs(inputs)
    with torch.no_grad():
        got = port(px, 501, pctx, ppooled, ptids, pidx)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL, rtol=MODEL_TOL)


@pytest.mark.parametrize("kw", [dict(concept_slots=3), dict(lora_slots=3)])
def test_precompute_cross_kv_matches_inline_and_jax(kw):
    model, params, port, inputs = _case("tiny", kw, seed=1)
    x, ctx, pooled, tids, idx = inputs
    px, pctx, ppooled, ptids, pidx = _port_inputs(inputs)
    jcfg = model.config
    jax_kv = jax_unet2d.precompute_cross_kv(jcfg, params, ctx, idx)
    with torch.no_grad():
        kv = port_unet2d.precompute_cross_kv(port, pctx, pidx)
        inline = port(px, 301, pctx, ppooled, ptids, pidx)
        cached = port(px, 301, pctx, ppooled, ptids, pidx, cross_kv=kv)
    assert [n for _, n in port_unet2d.cross_attention_names(port.config)] == \
        [n for _, n in jax_unet2d.cross_attention_names(jcfg)] == list(kv)
    for name, (k, v) in kv.items():
        np.testing.assert_allclose(k.numpy(), np.asarray(jax_kv[name][0]), atol=3e-5, rtol=1e-4)
        np.testing.assert_allclose(v.numpy(), np.asarray(jax_kv[name][1]), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(cached.numpy(), inline.numpy(), atol=1e-6, rtol=1e-6)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 261, 981], np.int32)
    for dim in (8, 9, 320):
        want = jax_timestep_embedding(jnp.asarray(t), dim)
        got = timestep_embedding(torch.from_numpy(t), dim)
        # atol 1e-4: at t=981 the fp32 argument's own ulp is 6e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    # flip_sin_to_cos puts cos first: cos(0) = 1
    assert float(timestep_embedding(torch.tensor([0]), 8)[0, 0]) == 1.0


def test_converter_rejects_missing_and_unexpected_keys():
    model, params, port, _ = _case("micro", dict(concept_slots=3))
    convert_params(params, port)  # the full tree fits
    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["conv_out"]
    with pytest.raises(ValueError, match="missing: conv_out"):
        convert_params(missing, port)
    extra = dict(params, bogus={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="unexpected: bogus.weight"):
        convert_params(extra, port)


def test_converter_merges_self_attention_qkv():
    """attn1's to_q/to_k/to_v kernels become one [3·inner, C] weight, q rows
    first; with one of the three gone nothing is merged and the rest is
    reported."""
    _, params, port, _ = _case("micro", dict(concept_slots=3))
    block = params["down_blocks_0_attentions_0"]["transformer_blocks_0"]["attn1"]
    name = "down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    want = np.concatenate([block[p]["kernel"].T for p in ("to_q", "to_k", "to_v")], axis=0)
    np.testing.assert_array_equal(port.state_dict()[f"{name}.to_qkv.weight"].numpy(), want)
    assert f"{name}.to_q.weight" not in port.state_dict()
    broken = jax.tree_util.tree_map(lambda a: a, params)
    del broken["down_blocks_0_attentions_0"]["transformer_blocks_0"]["attn1"]["to_k"]
    with pytest.raises(ValueError, match=rf"missing: {name}.to_qkv.weight"):
        convert_params(broken, port)


@pytest.mark.parametrize("option", [dict(quant="int4"), dict(remat=True),
                                    dict(detach_first_token_kv=True)])
def test_unported_options_raise(option):
    """quant takes only the JAX package's modes ("int8", "int8_conv":
    tests/test_torch_port_quant.py) and raises on any other; the training
    options are ported: they build and run, with and without a gradient
    (their gradients against the JAX package:
    tests/test_torch_port_training.py)."""
    if "quant" in option:
        with pytest.raises(ValueError):
            port_unet2d.UNetConfig.micro(**option)
        return
    model, params, port, inputs = _case("micro", option)
    assert getattr(port.config, next(iter(option)))
    x, ctx, pooled, tids, idx = _port_inputs(inputs)
    with torch.no_grad():
        plain = port(x, 501, ctx, pooled, tids, idx)
    want = model.apply({"params": params}, *inputs[:1], jnp.int32(501), *inputs[1:])
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=MODEL_TOL, rtol=MODEL_TOL)
    out = port(x, 501, ctx, pooled, tids, idx)
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=1e-6)
    out.square().sum().backward()
    assert all(p.grad is not None for p in port.parameters())


def test_sdxl_structure_matches_jax():
    """Full SDXL with concept slots, built on the meta device (no memory):
    every JAX parameter maps by the converter's rules onto a port parameter
    of the same (transposed) shape, and nothing is left over."""
    port = port_unet2d.UNet2DConditionModel(port_unet2d.UNetConfig.sdxl(concept_slots=4),
                                            device="meta")
    jcfg = jax_unet2d.UNetConfig.sdxl(concept_slots=4)
    S = jax.ShapeDtypeStruct
    shapes = jax.eval_shape(
        jax_unet2d.UNet2DConditionModel(jcfg).init, jax.random.PRNGKey(0),
        S((1, 16, 16, 4), jnp.float32), S((), jnp.int32), S((1, 16, 2048), jnp.float32),
        S((1, 1280), jnp.float32), S((1, 6), jnp.float32),
    )["params"]
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(p.key for p in path)
        shape = torch_layout(keys, np.empty(leaf.shape, np.bool_)).shape
        want[torch_name(keys)] = torch.empty(shape, device="meta")
    merge_self_attention_qkv(want, port.state_dict())
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("block", ["transformer", "resnet"])
def test_block_norm_epsilons_match_jax(block):
    """Small-variance inputs (group variance ~1e-4) make each site's
    GroupNorm epsilon visible: 1e-6 in Transformer2DModel.norm, 1e-5 in the
    resnets."""
    rng = np.random.default_rng(8)
    x = (1e-2 * rng.standard_normal((2, 4, 4, 32))).astype(np.float32)
    if block == "transformer":
        ctx = (0.2 * rng.standard_normal((2, 5, 16))).astype(np.float32)
        idx = np.zeros(2, np.int32)
        jmod = jax_unet2d.Transformer2DModel(heads=2, dim_head=16, num_layers=1,
                                             cross_attention_dim=16, norm_num_groups=8)
        args = (x, ctx, idx)
        port = port_unet2d.Transformer2DModel(32, 2, 16, 1, 16, 8)
        port_args = (torch.from_numpy(ctx), torch.from_numpy(idx).long())
    else:
        temb = rng.standard_normal((2, 24)).astype(np.float32)
        jmod = jax_unet2d.ResnetBlock2D(out_channels=48, norm_num_groups=8)
        args = (x, temb)
        port = port_unet2d.ResnetBlock2D(32, 48, 24, 8)
        port_args = (torch.from_numpy(temb),)
    params = numpy_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)["params"], 2)
    load_params(port, params)
    want = jmod.apply({"params": params}, *args)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), *port_args).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)
