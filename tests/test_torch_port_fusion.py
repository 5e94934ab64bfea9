"""The torch port's DDIM table, masks, sampler and pipeline against the JAX
package on the CPU.

Parameters, text embeddings, masks and the initial latent come from numpy
seeds and go through both packages (``x_init`` replaces each package's own
random initial latent). Tolerances: exact for the DDIM table and the masks;
3e-5 / 1e-4 for the Tweedie arithmetic; 1e-4 (atol and rtol) for whole
trajectories and decoded images, for fp32 sum order across many UNet calls.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tweediemix_tpu.fusion import masks as jax_masks
from tweediemix_tpu.fusion import pipeline as jax_pipeline
from tweediemix_tpu.fusion import sampler as jax_sampler
from tweediemix_tpu.models import unet2d as jax_unet2d
from tweediemix_tpu.models import vae as jax_vae
from tweediemix_tpu.schedulers import ddim as jax_ddim
from tweediemix_tpu_torch.fusion import masks as port_masks
from tweediemix_tpu_torch.fusion import sampler as port_sampler
from tweediemix_tpu_torch.fusion.pipeline import TweedieMixPipeline
from tweediemix_tpu_torch.models import unet2d as port_unet2d
from tweediemix_tpu_torch.models import vae as port_vae
from tweediemix_tpu_torch.models.convert import load_params
from tweediemix_tpu_torch.schedulers import ddim as port_ddim

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TRAJ_TOL = 1e-4


def numpy_params(abstract, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['bias']"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = s.shape[-2] if len(s.shape) == 3 else int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


# -- DDIM --------------------------------------------------------------------


def test_ddim_table_matches_jax():
    want = jax_ddim.DDIMTable.create(50)
    got = port_ddim.DDIMTable.create(50)
    np.testing.assert_array_equal(got.timesteps.numpy(), np.asarray(want.timesteps))
    np.testing.assert_array_equal(got.alphas_cumprod.numpy(), np.asarray(want.alphas_cumprod))
    assert got.alphas_cumprod[0] == 1.0  # the prepended 1.0
    assert got.skip == want.skip == 20 and got.n_steps == 50
    for t in (981, 961, 1, 0, -1, -19, 1500):
        assert got.alpha(t) == float(want.alpha(jnp.int32(t))), t
    assert got.alpha(-1) == got.final_alpha_cumprod


def test_tweedie_renoise_cfg_match_jax():
    rng = np.random.default_rng(3)
    x, eps, eps2 = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32) for _ in range(3))
    jt, pt = jax_ddim.DDIMTable.create(50), port_ddim.DDIMTable.create(50)
    for t in (981, 501, 1):
        at, at_next = pt.alpha(t), pt.alpha(t - 20)
        X, E = torch.from_numpy(x), torch.from_numpy(eps)
        np.testing.assert_allclose(pt.tweedie(X, E, at).numpy(),
                                   np.asarray(jt.tweedie(x, eps, jt.alpha(t))), atol=3e-5, rtol=1e-4)
        np.testing.assert_allclose(pt.renoise(X, E, at_next).numpy(),
                                   np.asarray(jt.renoise(x, eps, jt.alpha(t - 20))),
                                   atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(
        port_ddim.cfg(torch.from_numpy(eps), torch.from_numpy(eps2), 0.8).numpy(),
        np.asarray(jax_ddim.cfg(eps, eps2, 0.8)), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(
        port_ddim.rescale_noise_cfg(torch.from_numpy(eps), torch.from_numpy(eps2), 0.7).numpy(),
        np.asarray(jax_ddim.rescale_noise_cfg(eps, eps2, 0.7)), atol=3e-5, rtol=1e-4)


# -- masks -------------------------------------------------------------------


@pytest.mark.parametrize("edge", [37, 64, 101])
def test_region_masks_match_jax_with_unaligned_edge(edge):
    """A mask edge at a column that is not a multiple of the 8x downscale
    tells half-pixel-centre sampling ("nearest-exact") from torch's
    default "nearest"."""
    h = w = 160
    fg = np.zeros((2, h, w), np.float32)
    fg[0, 10:130, :edge] = 0.9
    fg[1, :, edge:] = 0.6
    fg[1, 5:9, 150:] = 0.3  # below the 0.5 threshold
    want = jax_masks.build_region_masks(jnp.asarray(fg), 20, 20)
    got = port_masks.build_region_masks(torch.from_numpy(fg), 20, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = port_masks.binarize_and_resize_mask(torch.from_numpy(fg[0]), 20, 20)
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jax_masks.binarize_and_resize_mask(jnp.asarray(fg[0]), 20, 20)))


def test_mask_resize_picks_half_pixel_centres():
    row = torch.zeros(1, 16)
    row[0, 4] = 1.0
    row[0, 12] = 1.0
    got = port_masks.binarize_and_resize_mask(row.expand(16, 16), 2, 2)
    assert got.tolist() == [[1.0, 1.0], [1.0, 1.0]]
    np.testing.assert_array_equal(
        port_masks.background_mask(torch.tensor([[0.7, 0.0], [0.6, 1.0]])[:, None]).numpy(),
        np.asarray(jax_masks.background_mask(jnp.array([[0.7, 0.0], [0.6, 1.0]])[:, None])))


# -- sampler and pipeline ------------------------------------------------------


def _embeds(rng, n, ctx_len, ctx_dim, pool):
    def rows(m):
        return ((0.2 * rng.standard_normal((m, ctx_len, ctx_dim))).astype(np.float32),
                (0.2 * rng.standard_normal((m, pool))).astype(np.float32))

    return (*rows(2), *rows(n - 1), *rows(n + 1))


def _unet_pair(ucfg_kw, seed, hw, ctx_len):
    jcfg = jax_unet2d.UNetConfig.micro(**ucfg_kw)
    model = jax_unet2d.UNet2DConditionModel(jcfg)
    abstract = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), np.zeros((2, hw, hw, 4), np.float32), jnp.int32(1),
        np.zeros((2, ctx_len, jcfg.cross_attention_dim), np.float32),
        np.zeros((2, jcfg.pooled_projection_dim), np.float32), np.zeros((2, 6), np.float32),
        np.zeros((2,), np.int32))["params"]
    params = numpy_params(abstract, seed)
    port = port_unet2d.UNet2DConditionModel(port_unet2d.UNetConfig.micro(**ucfg_kw), device="cpu")
    load_params(port, params)
    return model, params, port


@pytest.fixture(scope="module")
def micro_trajectory():
    """The 4-step micro fusion trajectory of test_e2e_regression.py
    (prologue resampling, joint step, jumping, masked fusion, Tweedie
    return), run through the JAX sampler from a numpy x_init."""
    n = 2
    hw = 8
    model, params, port = _unet_pair(dict(concept_slots=n + 1), seed=23, hw=hw, ctx_len=5)
    kw = dict(n_timesteps=4, guidance_scale=0.8, t_cond=0.5, resampling_steps=1,
              jumping_steps=1, height=hw * 8, width=hw * 8, num_concepts=n)
    rng = np.random.default_rng(3821)
    embeds = _embeds(rng, n, 5, 32, 32)
    fg = np.zeros((n - 1, hw * 8, hw * 8), np.float32)
    fg[0, :, : hw * 4] = 1.0
    x_init = rng.standard_normal((1, hw, hw, 4)).astype(np.float32)
    tids = jnp.asarray([[float(hw * 8), hw * 8, 0, 0, hw * 8, hw * 8]])

    def unet_fn(p, x, t, ctx, pooled, idx, cross_kv=None):
        return model.apply({"params": p}, x, t, ctx, pooled, jnp.tile(tids, (x.shape[0], 1)), idx,
                           cross_kv=cross_kv)

    sampler = jax_sampler.FusionSampler(
        jax_ddim.DDIMTable.create(n_steps=4), jax_sampler.FusionConfig(**kw), unet_fn,
        unet_params=params)
    want = sampler.run(jax_sampler.TextEmbeds(*embeds), jax.random.PRNGKey(0), fg_masks=fg,
                       x_init=jnp.asarray(x_init))
    return port, kw, embeds, fg, x_init, np.asarray(want)


@pytest.mark.parametrize("kv_cache", [False, True])
def test_micro_trajectory_matches_jax(micro_trajectory, kv_cache):
    """``kv_cache``: the port's UNet call builds the K/V with
    ``precompute_cross_kv`` per call, as the pipeline's runner does; else
    the modules project it."""
    port, kw, embeds, fg, x_init, want = micro_trajectory
    fcfg = port_sampler.FusionConfig(**kw)
    hw8 = kw["height"]
    tids = torch.tensor([[float(hw8), hw8, 0, 0, hw8, hw8]])

    def unet_fn(x, t, ctx, pooled, idx):
        kv = port_unet2d.precompute_cross_kv(port, ctx, idx) if kv_cache else None
        return port(x, t, ctx, pooled, tids.expand(x.shape[0], 6), idx, cross_kv=kv)

    sampler = port_sampler.FusionSampler(port_ddim.DDIMTable.create(n_steps=4), fcfg, unet_fn)
    assert fcfg.unet_calls() == 3 + 1 + 1 + 2  # prologue, joint, jumping, fused
    with torch.no_grad():
        got = sampler.run(port_sampler.TextEmbeds(*map(torch.from_numpy, embeds)),
                          fg_masks=torch.from_numpy(fg), x_init=torch.from_numpy(x_init))
    assert set(sampler.phase_seconds) == {"prologue", "joint", "jumping", "fused"}
    np.testing.assert_allclose(got.numpy(), want, atol=TRAJ_TOL, rtol=TRAJ_TOL)


def test_pipeline_sample_and_decode_match_jax():
    """The port's pipeline.sample + decode_final (micro UNet with 4 concept
    slots, tiny VAE, N=3, the K/V built per call by the pipeline's runner)
    against the JAX sampler (its per-phase cross-K/V cache on) and pipeline
    decode from the same x_init."""
    n, hw = 3, 8
    model, params, port_unet = _unet_pair(dict(concept_slots=n + 1), seed=5, hw=hw, ctx_len=6)
    vae = jax_vae.AutoencoderKL(jax_vae.VAEConfig.tiny())
    vae_params = numpy_params(jax.eval_shape(
        vae.init, jax.random.PRNGKey(0), np.zeros((1, 16, 16, 3), np.float32),
        jax.random.PRNGKey(1))["params"], seed=6)
    port_vae_model = port_vae.AutoencoderKL(port_vae.VAEConfig.tiny(), device="cpu")
    load_params(port_vae_model, vae_params)
    kw = dict(n_timesteps=5, guidance_scale=0.8, t_cond=0.4, resampling_steps=1,
              jumping_steps=2, height=hw * 8, width=hw * 8, num_concepts=n)
    rng = np.random.default_rng(7)
    embeds = _embeds(rng, n, 6, 32, 32)
    fg = np.zeros((n - 1, hw * 8, hw * 8), np.float32)
    fg[0, :, :29] = 1.0
    fg[1, :, 29:] = 1.0
    x_init = rng.standard_normal((2, hw, hw, 4)).astype(np.float32)

    jp = jax_pipeline.TweedieMixPipeline(
        unet=model, unet_params=params, vae=vae, vae_params=vae_params, text=None,
        tokenizer_1=None, tokenizer_2=None, fusion_config=jax_sampler.FusionConfig(**kw),
        table=jax_ddim.DDIMTable.create(n_steps=5))
    sampler = jax_sampler.FusionSampler(jp.table, jp.fusion_config, jp._unet_fn(),
                                        unet_params=params, kv_builder=jp._kv_builder())
    x = sampler.run(jax_sampler.TextEmbeds(*embeds), jax.random.PRNGKey(0), fg_masks=fg,
                    num_seeds=2, x_init=jnp.asarray(x_init))
    want = np.concatenate([np.asarray(jp.decode_final(x[s : s + 1])) for s in range(2)])

    pipe = TweedieMixPipeline(port_unet, port_vae_model, port_sampler.FusionConfig(**kw),
                              device="cpu")
    got = pipe.sample(port_sampler.TextEmbeds(*map(torch.from_numpy, embeds)),
                      fg_masks=torch.from_numpy(fg), num_seeds=2, x_init=torch.from_numpy(x_init))
    assert got.shape == (2, 16, 16, 3)
    assert set(pipe.phase_seconds) == {"prologue", "joint", "jumping", "fused", "decode"}
    np.testing.assert_allclose(pipe.last_latent.numpy(), np.asarray(x), atol=TRAJ_TOL, rtol=TRAJ_TOL)
    np.testing.assert_allclose(got.numpy(), want, atol=TRAJ_TOL, rtol=TRAJ_TOL)


def test_init_latent_rows_do_not_depend_on_batch():
    fcfg = port_sampler.FusionConfig(n_timesteps=10, height=64, width=64)
    sampler = port_sampler.FusionSampler(port_ddim.DDIMTable.create(n_steps=10), fcfg, None)
    one = sampler.init_latent(7, 1, device="cpu")
    three = sampler.init_latent(7, 3, device="cpu")
    assert three.shape == (3, 8, 8, 4)
    torch.testing.assert_close(three[:1], one, rtol=0, atol=0)
    assert not torch.equal(three[1], three[0])


@pytest.mark.parametrize("num_seeds", [1, 2])
def test_compute_masks_from_preview_segmentation_matches_jax(num_seeds):
    """Without precomputed masks, each seed's Tweedie preview is decoded and
    segmented; the same numpy segmentation feeds both packages."""
    n, hw = 3, 8
    preview = np.random.default_rng(num_seeds).standard_normal(
        (num_seeds, hw, hw, 4)).astype(np.float32)

    def segment(img):
        img = np.asarray(img)[0]  # [h, w, 4] preview "image"
        fg = np.stack([img[..., 0] > 0.3, img[..., 1] > 0.3]).astype(np.float32)
        return fg.repeat(8, axis=1).repeat(8, axis=2)

    kw = dict(n_timesteps=10, height=hw * 8, width=hw * 8, num_concepts=n)
    jax_s = jax_sampler.FusionSampler(jax_ddim.DDIMTable.create(n_steps=10),
                                      jax_sampler.FusionConfig(**kw), None,
                                      decode_preview_fn=lambda x: x, segment_fn=segment)
    port_s = port_sampler.FusionSampler(port_ddim.DDIMTable.create(n_steps=10),
                                        port_sampler.FusionConfig(**kw), None,
                                        decode_preview_fn=lambda x: x, segment_fn=segment)
    want = jax_s.compute_masks(jnp.asarray(preview), None)
    got = port_s.compute_masks(torch.from_numpy(preview), None)
    assert got.shape == ((n, hw, hw) if num_seeds == 1 else (num_seeds, n, hw, hw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
