"""The torch port's image-to-video path against the JAX package on the CPU:
the short-sequence attention module, its dispatch, the video DDIM step, the
UNet3D blocks and model, the pipeline's loop, decode and generate, and the
converter.

Parameters (the JAX model's tree, every leaf filled from a numpy seed, so
the temporal convs' zero-initialised last stage is non-zero too) go into the
port through ``tweediemix_tpu_torch.models.convert``; inputs come from numpy
seeds. Tolerances: the short-attention module at the JAX tests' own (rtol
2e-4, atol 2e-5; atol 2e-2 for strongly negative scores); single blocks at 3e-5; the whole tiny UNet3D and a 3-step
trajectory at 1e-4 of the output's max (sum-order differences across a few
dozen fp32 layers). ``attention_head_dim=32`` makes the temporal sites pass
the short-attention gate, so with the knob on the CPU runs go through its
plain version.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tweediemix_tpu.models import unet3d as jax_unet3d
from tweediemix_tpu.models import vae as jax_vae
from tweediemix_tpu.ops.attention import merge_heads as jax_merge_heads
from tweediemix_tpu.ops.attention import split_heads as jax_split_heads
from tweediemix_tpu.ops.short_attention import short_seq_attention as jax_short
from tweediemix_tpu.schedulers import ddim as jax_ddim
from tweediemix_tpu.video import pipeline as jax_video
from tweediemix_tpu_torch.models import unet3d as port_unet3d
from tweediemix_tpu_torch.models import vae as port_vae
from tweediemix_tpu_torch.models.convert import convert_params, load_params, torch_layout, torch_name
from tweediemix_tpu_torch.ops import attention as port_attention
from tweediemix_tpu_torch.ops.short_attention import short_seq_attention, short_seq_attention_reference
from tweediemix_tpu_torch.schedulers import ddim as port_ddim
from tweediemix_tpu_torch.video import pipeline as port_video

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

MODEL_TOL = 1e-4
BLOCK_TOL = 3e-5
B, F, HW, CTX_LEN = 2, 4, 8, 6  # 6 text + 1 conv + 4 embedding context tokens


def numpy_params(abstract, seed):
    """A parameter tree of the JAX model's shapes, every leaf filled from a
    numpy seed (fan-in scaled kernels, norm scales near 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['bias']"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _to_folded(x):
    """JAX [B, F, h, w, C] → the port's [B·F, C, h, w]."""
    return port_unet3d.fold_frames(_t(x))


# -- short-sequence attention -------------------------------------------------


def _qkv(rng, n, s, d, scale=1.0):
    return [(scale * rng.standard_normal((n, s, d))).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n,s,heads,dh", [(64, 16, 5, 64), (32, 12, 3, 64), (8, 16, 2, 128),
                                          (100, 7, 4, 32), (16, 1, 2, 64)])
def test_short_attention_plain_matches_pallas_interpret(n, s, heads, dh):
    q, k, v = _qkv(np.random.default_rng(n * s + heads), n, s, heads * dh)
    want = jax_short(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, interpret=True)
    got = short_seq_attention(_t(q), _t(k), _t(v), heads)  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_short_attention_strongly_negative_scores_match_pallas_interpret():
    """Anti-aligned q/k at large magnitude (scores ~ -400 in the natural-log
    domain): a valid softmax average, never a zero vector. Tolerance: the
    JAX test's own for this case (atol 2e-2): at scores of this size one fp32
    ulp of the score is ~3e-4 of a weight, and the Pallas kernel rounds its
    pre-scaled q where the plain version scales the scores (2.5e-4 apart)."""
    n, s, heads, dh = 4, 16, 2, 8
    rng = np.random.default_rng(0)
    q = 40.0 * np.ones((n, s, heads * dh), np.float32)
    k = (-40.0 * (1.0 + 0.01 * rng.standard_normal(q.shape))).astype(np.float32)
    v = rng.standard_normal(q.shape).astype(np.float32)
    want = np.asarray(jax_short(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                interpret=True))
    got = short_seq_attention(_t(q), _t(k), _t(v), heads).numpy()
    assert np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_short_knob_equals_math_path_on_cpu(monkeypatch, dtype):
    """TWEEDIEMIX_SHORT_ATTENTION=1 on CPU tensors takes the plain version;
    every shape the gate admits runs, q/k/v given as views of one merged
    projection as the model gives them, and matches the knob off."""
    rng = np.random.default_rng(3)
    counts = short_seq_attention.launches
    for s in (1, 7, 16, 32):
        for dh in (32, 64, 128):
            heads = 2
            qkv = _t(rng.standard_normal((3, s, 3 * heads * dh))).to(dtype)
            q, k, v = qkv.chunk(3, dim=-1)
            monkeypatch.setenv("TWEEDIEMIX_SHORT_ATTENTION", "0")
            assert not port_attention.uses_short(q.shape, k.shape, heads)
            off = port_attention.multi_head_attention(q, k, v, heads)
            monkeypatch.setenv("TWEEDIEMIX_SHORT_ATTENTION", "1")
            assert port_attention.uses_short(q.shape, k.shape, heads)
            on = port_attention.multi_head_attention(q, k, v, heads)
            assert on.dtype == dtype and on.shape == q.shape
            torch.testing.assert_close(on, off, atol=1e-6 if dtype == torch.float32 else 1e-2,
                                       rtol=1e-6 if dtype == torch.float32 else 1e-2)
    assert short_seq_attention.launches == counts  # nothing launched on the CPU


def test_short_gate_refuses_what_the_jax_gate_refuses(monkeypatch):
    monkeypatch.setenv("TWEEDIEMIX_SHORT_ATTENTION", "1")
    gate = port_attention.uses_short
    assert gate((8, 16, 128), (8, 16, 128), 2)
    assert not gate((8, 33, 128), (8, 33, 128), 2)  # S > 32
    assert not gate((8, 16, 128), (8, 11, 128), 2)  # cross-attention
    assert not gate((8, 16, 8), (8, 16, 8), 2)  # dh = 4: the image-latent encoder
    assert not gate((8, 16, 96), (8, 16, 96), 2)  # dh = 48
    monkeypatch.setenv("TWEEDIEMIX_SHORT_ATTENTION", "0")
    assert not gate((8, 16, 128), (8, 16, 128), 2)


def test_short_reference_matches_split_heads_math():
    rng = np.random.default_rng(5)
    q, k, v = (_t(a) for a in _qkv(rng, 6, 16, 128))
    split = [port_attention.split_heads(t, 2) for t in (q, k, v)]
    want = port_attention.merge_heads(port_attention.math_attention(*split, 64**-0.5), 2)
    torch.testing.assert_close(short_seq_attention_reference(q, k, v, 2), want,
                               atol=1e-6, rtol=1e-6)
    # the JAX package's split/merge agree with the port's on this layout
    np.testing.assert_array_equal(np.asarray(jax_merge_heads(jax_split_heads(jnp.asarray(q), 2), 2)),
                                  q.numpy())


# -- scheduler ------------------------------------------------------------------


def test_video_ddim_table_matches_jax():
    cfg = port_video.VideoConfig(n_timesteps=10)
    tbl = port_video.VideoDDIM(cfg)
    jtbl = jax_video.VideoDDIM(jax_video.VideoConfig(n_timesteps=10))
    assert list(tbl.timesteps) == list(np.asarray(jtbl.timesteps))
    assert tbl.timesteps[0] == 901 and tbl.timesteps[-1] == 1 and tbl.skip == 100
    acp = np.cumprod(1.0 - port_ddim.make_betas())
    assert tbl.alpha(-99) == pytest.approx(acp[0], rel=1e-6)
    assert tbl.alpha(1) == pytest.approx(acp[1], rel=1e-6)  # unshifted
    for t in (-99, -1, 0, 1, 500, 999, 1200):
        assert tbl.alpha(t) == float(jtbl.alpha(jnp.int32(t)))


def test_video_rotation_step_matches_jax():
    rng = np.random.default_rng(6)
    x, eps = (rng.standard_normal((2, 4, 8, 8, 4)).astype(np.float32) for _ in range(2))
    tbl = port_video.VideoDDIM(port_video.VideoConfig())
    for t in (981, 501, 1):
        at, at_next = tbl.alpha(t), tbl.alpha(t - tbl.skip)
        want = jax_ddim.video_rotation_step(jnp.asarray(x), jnp.asarray(eps), jnp.float32(at),
                                            jnp.float32(at_next))
        got = port_ddim.video_rotation_step(_t(x), _t(eps), at, at_next)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


# -- blocks ----------------------------------------------------------------------


def _block_case(jmod, port, x, seed):
    params = numpy_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)["params"], seed)
    load_params(port, params)
    return np.asarray(jmod.apply({"params": params}, x))


def test_temporal_conv_layer_matches_jax():
    """The layer is loaded at a video-UNet path: its diffusers names
    (``convK.0`` norm, ``convK.2``/``convK.3`` conv) are renamed only under
    ``temp_convs``, since a resnet's ``conv1`` is also called ``conv1``."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, F, 4, 4, 32)).astype(np.float32)
    jmod = jax_unet3d.TemporalConvLayer(32, 8)
    params = numpy_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)["params"], 1)
    port = port_unet3d.TemporalConvLayer(32, 8)
    holder = torch.nn.Module()
    holder.mid_block = torch.nn.Module()
    holder.mid_block.temp_convs = torch.nn.ModuleList([port])
    load_params(holder, {"mid_block_temp_convs_0": params})
    want = np.asarray(jmod.apply({"params": params}, x))
    with torch.no_grad():
        got = port_unet3d.unfold_frames(port(_to_folded(x), F), B)
    np.testing.assert_allclose(got.numpy(), want, atol=BLOCK_TOL, rtol=1e-4)


@pytest.mark.parametrize("dim_head", [16, 32])
def test_transformer_temporal_model_matches_jax(monkeypatch, dim_head):
    monkeypatch.setenv("TWEEDIEMIX_SHORT_ATTENTION", "1")
    rng = np.random.default_rng(8)
    # small-variance input makes the GroupNorm epsilon (1e-6) count
    x = (1e-2 * rng.standard_normal((B, F, 4, 4, 32))).astype(np.float32)
    jmod = jax_unet3d.TransformerTemporalModel(32, heads=2, dim_head=dim_head, norm_num_groups=8)
    port = port_unet3d.TransformerTemporalModel(32, 2, dim_head, 1, 8)
    want = _block_case(jmod, port, x, 2)
    with torch.no_grad():
        got = port_unet3d.unfold_frames(port(_to_folded(x), F), B)
    np.testing.assert_allclose(got.numpy(), want, atol=BLOCK_TOL, rtol=1e-4)


def test_image_latents_temporal_encoder_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B * 16, F, 4)).astype(np.float32)
    jmod = jax_unet3d.ImageLatentsTemporalEncoder(dim=4, heads=2, dim_head=4, ff_inner_dim=16)
    port = port_unet3d.ImageLatentsTemporalEncoder(4, 2, 4, 16)
    want = _block_case(jmod, port, x, 3)
    with torch.no_grad():
        got = port(_t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=BLOCK_TOL, rtol=1e-4)


def test_inject_first_frame_matches_jax():
    x = np.arange(2 * 4 * 2 * 2 * 3, dtype=np.float32).reshape(2, 4, 2, 2, 3)
    for copy, interp in ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)):
        want = jax_unet3d._inject_first_frame(jnp.asarray(x), copy, interp, 0.7)
        got = port_unet3d._inject_first_frame(_t(x), copy, interp, 0.7)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# -- the whole tiny UNet3D ------------------------------------------------------------


@pytest.fixture(scope="module")
def unet3d_case():
    """JAX tiny UNet3D (head dim 32) with numpy params, the port loaded
    with them, and numpy inputs."""
    cfg = jax_unet3d.UNet3DConfig.tiny(attention_head_dim=32)
    model = jax_unet3d.UNet3DConditionModel(cfg)
    rng = np.random.default_rng(10)
    sample = rng.standard_normal((B, F, HW, HW, 4)).astype(np.float32)
    ctx = (0.3 * rng.standard_normal((B, CTX_LEN, 32))).astype(np.float32)
    il = (0.3 * rng.standard_normal((B, F, HW, HW, 4))).astype(np.float32)
    emb = (0.3 * rng.standard_normal((B, 1, 32))).astype(np.float32)
    fps = np.full((B,), 8.0, np.float32)
    inputs = (sample, ctx, il, emb, fps)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), sample, jnp.int32(1), ctx, il,
                              emb, jnp.float32(8.0))["params"]
    params = numpy_params(abstract, 11)
    port = port_unet3d.UNet3DConditionModel(port_unet3d.UNet3DConfig.tiny(attention_head_dim=32),
                                            device="cpu")
    load_params(port, params)
    return model, params, port, inputs


def _assert_eps_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= MODEL_TOL * np.abs(want).max(), err


def test_unet3d_matches_jax_with_short_attention(unet3d_case, monkeypatch):
    monkeypatch.setenv("TWEEDIEMIX_SHORT_ATTENTION", "1")
    model, params, port, (sample, ctx, il, emb, fps) = unet3d_case
    want = model.apply({"params": params}, sample, jnp.int32(501), ctx, il, emb, fps, 1.0, 1.0, 0.7)
    with torch.no_grad():
        got = port(_t(sample), 501, _t(ctx), _t(il), _t(emb), _t(fps), 1.0, 1.0, 0.7)
    _assert_eps_close(got, want)


def test_unet3d_cache_matches_jax_and_inline(unet3d_case, monkeypatch):
    monkeypatch.setenv("TWEEDIEMIX_SHORT_ATTENTION", "1")
    model, params, port, (sample, ctx, il, emb, fps) = unet3d_case
    jctx, jil, jkv = jax_unet3d.precompute_video_cache(model, params, ctx, il, emb, fps)
    want = model.apply({"params": params}, sample, jnp.int32(301), ctx, il, emb, fps, 0.0, 1.0, 0.7,
                       cached_ctx=jctx, cached_il=jil, cross_kv=jkv)
    with torch.no_grad():
        pctx, pil, pkv = port_unet3d.precompute_video_cache(port, _t(ctx), _t(il), _t(emb), _t(fps))
        cached = port(_t(sample), 301, _t(ctx), _t(il), _t(emb), _t(fps), 0.0, 1.0, 0.7,
                      cached_ctx=pctx, cached_il=pil, cross_kv=pkv)
        inline = port(_t(sample), 301, _t(ctx), _t(il), _t(emb), _t(fps), 0.0, 1.0, 0.7)
    assert pctx.shape == (B, CTX_LEN + 1 + 4, 32)
    np.testing.assert_allclose(pctx.numpy(), np.asarray(jctx), atol=BLOCK_TOL, rtol=1e-4)
    np.testing.assert_allclose(pil.numpy(), np.asarray(jil), atol=BLOCK_TOL, rtol=1e-4)
    names = port_unet3d.video_cross_attention_names(port.config)
    assert names == jax_unet3d.video_cross_attention_names(model.config) == list(pkv)
    for name in names:  # the port's K/V are repeated over the frames, b-major
        for got, jwant in zip(pkv[name], jkv[name]):
            np.testing.assert_allclose(got.numpy(), np.repeat(np.asarray(jwant), F, axis=1),
                                       atol=BLOCK_TOL, rtol=1e-4)
    _assert_eps_close(cached, want)
    torch.testing.assert_close(cached, inline, atol=1e-6, rtol=1e-6)


def test_unet3d_injection_and_fps_change_the_output(unet3d_case):
    _, _, port, (sample, ctx, il, emb, fps) = unet3d_case
    args = (_t(sample), 501, _t(ctx), _t(il), _t(emb))
    with torch.no_grad():
        base = port(*args, 8.0)
        copy = port(*args, 8.0, 1.0, 0.0)
        interp = port(*args, 8.0, 0.0, 1.0)
        fps24 = port(*args, 24.0)
    for other in (copy, interp, fps24):
        assert (other - base).abs().max().item() > 1e-6


def test_unet3d_structure_matches_jax_at_full_width():
    """Full I2VGen-XL on the meta device (no memory): every JAX parameter
    maps by the converter's rules onto a port parameter of the same
    (transposed) shape, and nothing is left over."""
    port = port_unet3d.UNet3DConditionModel(port_unet3d.UNet3DConfig.i2vgen(), device="meta")
    jmodel = jax_unet3d.UNet3DConditionModel(jax_unet3d.UNet3DConfig.i2vgen())
    S = jax.ShapeDtypeStruct
    x = S((1, 2, 64, 64, 4), jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, S((), jnp.int32),
                            S((1, 77, 1024), jnp.float32), x, S((1, 1, 1024), jnp.float32),
                            S((), jnp.float32))["params"]
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(p.key for p in path)
        want[torch_name(keys)] = torch_layout(keys, np.empty(leaf.shape, np.bool_)).shape
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    merged = {k for k in got if k.endswith("to_qkv.weight")}
    for key in merged:
        prefix = key[: -len("to_qkv.weight")]
        parts = [want.pop(f"{prefix}{p}.weight") for p in ("to_q", "to_k", "to_v")]
        want[key] = (sum(p[0] for p in parts), parts[0][1])
    assert got == {k: tuple(v) for k, v in want.items()}
    assert "down_blocks.0.temp_convs.0.conv2.3.weight" in got
    assert got["down_blocks.0.temp_convs.0.conv1.2.weight"] == (320, 320, 3, 1, 1)
    assert sum(p.numel() for p in port.parameters()) == sum(
        int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))


def test_converter_rejects_missing_and_misshaped_keys(unet3d_case):
    _, params, port, _ = unet3d_case
    convert_params(params, port)  # the full tree fits
    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["down_blocks_0_temp_convs_0"]["norm3"]
    with pytest.raises(ValueError, match=r"missing: down_blocks\.0\.temp_convs\.0\.conv3\.0\.weight"):
        convert_params(missing, port)
    bad = jax.tree_util.tree_map(lambda a: a, params)
    conv = bad["mid_block_temp_convs_1"]["conv4"]
    conv["kernel"] = np.zeros((1,) + conv["kernel"].shape[1:], np.float32)
    with pytest.raises(ValueError, match=r"shape mismatch: mid_block\.temp_convs\.1\.conv4\.3\.weight"):
        convert_params(bad, port)


def test_video_quant_is_not_ported_yet():
    """The W8A8 mode is ported now (``test_torch_port_video_quant.py`` holds
    it against the JAX package): the config takes the JAX package's modes
    and refuses any other."""
    assert port_unet3d.UNet3DConfig.tiny(quant="int8").quant == "int8"
    assert port_unet3d.UNet3DConfig.tiny(quant="int8_conv").quant == "int8_conv"
    with pytest.raises(ValueError, match="quant"):
        port_unet3d.UNet3DConfig.tiny(quant="int4")


# -- pipeline ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def video_case(unet3d_case):
    """The JAX and port pipelines over the same tiny UNet3D and VAE weights:
    4 frames at 16² (latent 8²), 3 steps, injection on the first step."""
    model, params, port_unet, _ = unet3d_case
    vcfg_kw = dict(num_frames=F, height=16, width=16, latent_factor=2, n_timesteps=3,
                   injection_timestep=0.34)
    jvae = jax_vae.AutoencoderKL(jax_vae.VAEConfig.tiny(scaling_factor=0.18215))
    vparams = numpy_params(jax.eval_shape(jvae.init, jax.random.PRNGKey(0),
                                          jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(1))["params"], 12)
    pvae = load_params(port_vae.AutoencoderKL(port_vae.VAEConfig.tiny(scaling_factor=0.18215),
                                              device="cpu"), vparams)
    jpipe = jax_video.I2VPipeline(jax_video.VideoConfig(**vcfg_kw), model, params, jvae, vparams)
    ppipe = port_video.I2VPipeline(port_video.VideoConfig(**vcfg_kw), port_unet, pvae, device="cpu")
    assert ppipe.config.injection_steps == 1
    return jpipe, ppipe


def test_prepare_image_latents_matches_jax(video_case):
    jpipe, ppipe = video_case
    frame0 = np.random.default_rng(13).standard_normal((2, HW, HW, 4)).astype(np.float32)
    want = jpipe.prepare_image_latents(jnp.asarray(frame0))
    got = ppipe.prepare_image_latents(_t(frame0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_video_matches_jax_at_every_chunk_size(video_case):
    jpipe, ppipe = video_case
    lat = (0.3 * np.random.default_rng(14).standard_normal((1, F, HW, HW, 4))).astype(np.float32)
    want = np.asarray(jpipe.decode_video(jnp.asarray(lat)))
    for chunk in (1, 2, 3, 4):  # 3 does not divide the 4 frames
        cfg = dataclasses.replace(ppipe.config, decode_chunk_size=chunk)
        got = port_video.I2VPipeline(cfg, ppipe.unet, ppipe.vae, device="cpu").decode_video(_t(lat))
        assert got.shape == (1, F, 16, 16, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=BLOCK_TOL, rtol=1e-4)


def _jax_rows(rng):
    """Interleaved conditioning rows for one clip (uncond, cond)."""
    ctx = (0.3 * rng.standard_normal((1, CTX_LEN, 32))).astype(np.float32)
    img = (rng.uniform(size=(1, 16, 16, 3)) * 2 - 1).astype(np.float32)
    emb = (0.3 * rng.standard_normal((1, 1, 32))).astype(np.float32)
    return ctx, np.zeros_like(ctx), img, emb


def test_three_step_trajectory_matches_jax_loop(video_case, monkeypatch):
    monkeypatch.setenv("TWEEDIEMIX_SHORT_ATTENTION", "1")
    jpipe, ppipe = video_case
    rng = np.random.default_rng(15)
    x = rng.standard_normal((1, F, HW, HW, 4)).astype(np.float32)
    ctx2 = (0.3 * rng.standard_normal((2, CTX_LEN, 32))).astype(np.float32)
    il2 = np.repeat((0.3 * rng.standard_normal((1, F, HW, HW, 4))).astype(np.float32), 2, axis=0)
    emb2 = np.concatenate([np.zeros((1, 1, 32), np.float32),
                           (0.3 * rng.standard_normal((1, 1, 32))).astype(np.float32)])
    fps2 = np.full((2,), 8.0, np.float32)
    want = np.asarray(jpipe._jit_loop(jpipe.unet_params, x, ctx2, il2, emb2, fps2))
    rows = (_t(ctx2), _t(il2), _t(emb2), _t(fps2))
    with torch.no_grad():
        cache = port_unet3d.precompute_video_cache(ppipe.unet, *rows)
    got = ppipe.loop(_t(x), *rows, cache)
    assert np.abs(got.numpy() - want).max() <= MODEL_TOL * np.abs(want).max()


def test_generate_matches_jax_with_its_noise(video_case, monkeypatch):
    """The whole slice: first-frame encode, conditioning rows, the 3-step
    loop and the decode, with the JAX run's initial latent and posterior
    noise fed to the port."""
    monkeypatch.setenv("TWEEDIEMIX_SHORT_ATTENTION", "1")
    jpipe, ppipe = video_case
    ctx, uctx, img, emb = _jax_rows(np.random.default_rng(16))
    seed = 3
    want = np.asarray(jpipe.generate(ctx, uctx, img, emb, seed=seed))
    key = jax.random.PRNGKey(seed)
    x = np.asarray(jax.random.normal(key, (F, HW, HW, 4), jnp.float32))[None]
    noise = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (HW, HW, 4), jnp.float32))[None]
    got = ppipe.generate(_t(ctx), _t(uctx), _t(img), _t(emb), x_init=_t(x), posterior_noise=_t(noise))
    assert got.shape == want.shape == (F, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=MODEL_TOL, rtol=MODEL_TOL)
    assert set(ppipe.phase_seconds) == {"precompute", "loop", "decode"}


def test_seeded_noise_is_independent_of_the_clip_count(video_case):
    _, ppipe = video_case
    one = ppipe.init_latents(5, 1)
    three = ppipe.init_latents(5, 3)
    assert one.shape == (1, F, HW, HW, 4)
    torch.testing.assert_close(three[:1], one, atol=0, rtol=0)
    assert (three[1] - three[0]).abs().max() > 0.1
    torch.testing.assert_close(ppipe.posterior_noise(5, (HW, HW, 4), 2)[:1],
                               ppipe.posterior_noise(5, (HW, HW, 4), 1), atol=0, rtol=0)
