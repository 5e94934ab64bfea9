"""The torch port's AutoencoderKL against the JAX package on the CPU.

Parameters (the JAX VAE's tree, filled from a numpy seed) go into the port
through ``tweediemix_tpu_torch.models.convert``. Tolerance: 1e-4 (atol and
rtol) on the whole tiny encoder and decoder, for fp32 sum order; exact for
the elementwise latent scaling.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tweediemix_tpu.models import vae as jax_vae
from tweediemix_tpu_torch.models import vae as port_vae
from tweediemix_tpu_torch.models.convert import convert_params, load_params

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

MODEL_TOL = 1e-4


def numpy_params(abstract, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['bias']"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


@pytest.fixture(scope="module")
def tiny_vae():
    model = jax_vae.AutoencoderKL(jax_vae.VAEConfig.tiny())
    img = np.zeros((1, 32, 32, 3), np.float32)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), img, jax.random.PRNGKey(1))
    params = numpy_params(abstract["params"], seed=4)
    port = port_vae.AutoencoderKL(port_vae.VAEConfig.tiny(), device="cpu")
    load_params(port, params)
    return model, params, port


def test_tiny_encode_matches_jax(tiny_vae):
    model, params, port = tiny_vae
    img = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    mean, logvar = model.apply({"params": params}, img, method=model.encode)
    with torch.no_grad():
        pmean, plogvar = port.encode(torch.from_numpy(img))
    assert pmean.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(pmean.numpy(), np.asarray(mean), atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(plogvar.numpy(), np.asarray(logvar), atol=MODEL_TOL, rtol=MODEL_TOL)


def test_tiny_decode_matches_jax(tiny_vae):
    model, params, port = tiny_vae
    z = np.random.default_rng(1).standard_normal((2, 16, 16, 4)).astype(np.float32)
    want = model.apply({"params": params}, z, method=model.decode)
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z))
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL, rtol=MODEL_TOL)


@pytest.mark.parametrize(
    "kw,preview",
    [(dict(), False), (dict(), True),
     (dict(latents_mean=(0.1, -0.2, 0.3, 0.0), latents_std=(1.5, 0.5, 1.0, 2.0)), False),
     (dict(latents_mean=(0.1, -0.2, 0.3, 0.0), latents_std=(1.5, 0.5, 1.0, 2.0)), True)],
)
def test_unscale_latents_matches_jax(kw, preview):
    x = np.random.default_rng(2).standard_normal((1, 4, 4, 4)).astype(np.float32)
    want = jax_vae.unscale_latents(x, jax_vae.VAEConfig.sdxl(**kw), preview=preview)
    got = port_vae.unscale_latents(torch.from_numpy(x), port_vae.VAEConfig.sdxl(**kw),
                                   preview=preview)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_postprocess_matches_jax():
    x = np.linspace(-1.5, 1.5, 31, dtype=np.float32)
    np.testing.assert_array_equal(port_vae.postprocess_image(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_vae.postprocess_image(x)))


def test_converter_rejects_mismatched_vae_tree(tiny_vae):
    _, params, port = tiny_vae
    bad = dict(params, decoder=dict(params["decoder"]))
    bad["decoder"]["conv_in"] = {"kernel": np.zeros((3, 3, 4, 7), np.float32),
                                 "bias": np.zeros((7,), np.float32)}
    with pytest.raises(ValueError, match="shape mismatch: decoder.conv_in"):
        convert_params(bad, port)


def test_resnet_block_norm_epsilon_matches_jax():
    """A small-variance input makes the VAE's GroupNorm epsilon (1e-6)
    visible."""
    rng = np.random.default_rng(9)
    x = (1e-2 * rng.standard_normal((1, 6, 6, 16))).astype(np.float32)
    jmod = jax_vae.VAEResnetBlock(out_channels=32, norm_num_groups=8)
    params = numpy_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)["params"], 3)
    port = port_vae.VAEResnetBlock(16, 32, 8)
    load_params(port, params)
    want = jmod.apply({"params": params}, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)
