"""The video UNet's W8A8 mode (``UNet3DConfig(quant=...)``) against the JAX
package on the CPU.

The JAX tree's every leaf is filled from a numpy seed and loaded into both
packages; inputs come from numpy seeds. As in ``test_torch_port_quant.py``
the int8 sites are teacher-forced: each port site gets the JAX site's
input after the two are checked to agree to 1e-4 of their range (3e-5 per
site would be the block tolerance, but the sites' inputs carry the whole
model's fp32 drift), so a 1-ulp difference cannot flip an int8 rounding.
The model's output is held at 1e-4 (atol and rtol), and the port must
quantise exactly the sites the JAX package does, in its call order. The
JAX forward runs under ``jax.jit`` (five times faster here than eager), its
site inputs and outputs recorded in call order by ordered
``jax.debug.callback``s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contextlib
import os

from tests.test_torch_port_quant import MODEL_TOL, forced_port_sites
from tests.test_torch_port_video import numpy_params
from tweediemix_tpu.models import unet2d as jax_unet2d
from tweediemix_tpu.models import unet3d as jax_unet3d
from tweediemix_tpu.ops import quant as jax_quant
from tweediemix_tpu_torch.models import unet3d as port_unet3d
from tweediemix_tpu_torch.models.convert import load_params
from tweediemix_tpu_torch.ops import quant as port_quant

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

B, F, HW, CTX_LEN = 2, 3, 8, 5
SITE_TOL = 3e-5


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    sample = rng.standard_normal((B, F, HW, HW, 4)).astype(np.float32)
    ctx = (0.3 * rng.standard_normal((B, CTX_LEN, 32))).astype(np.float32)
    il = (0.3 * rng.standard_normal((B, F, HW, HW, 4))).astype(np.float32)
    emb = (0.3 * rng.standard_normal((B, 1, 32))).astype(np.float32)
    fps = np.full((B,), 8.0, np.float32)
    return sample, ctx, il, emb, fps


@contextlib.contextmanager
def jax_sites(monkeypatch, outputs=None):
    """Record each JAX int8 site's input (and, with ``outputs``, its output)
    in call order, from inside ``jax.jit``."""
    recorded = []

    def spy(fn, kind):
        def wrapped(x, *args, **kwargs):
            jax.debug.callback(lambda a: recorded.append((kind, np.asarray(a))), x, ordered=True)
            y = fn(x, *args, **kwargs)
            if outputs is not None:
                jax.debug.callback(lambda a: outputs.append(np.asarray(a, np.float32)), y,
                                   ordered=True)
            return y
        return wrapped

    matmul = spy(jax_quant.w8a8_matmul, "matmul")
    with monkeypatch.context() as m:
        m.setattr(jax_quant, "w8a8_matmul", matmul)
        m.setattr(jax_unet2d, "w8a8_matmul", matmul)
        m.setattr(jax_quant, "w8a8_conv", spy(jax_quant.w8a8_conv, "conv"))
        yield recorded
        jax.effects_barrier()


def _jit_apply(model, params, *args, **kw):
    return np.asarray(jax.jit(lambda p, a, k: model.apply({"params": p}, *a, **k))(params, args, kw))


def _site_counts(port):
    n_linear = sum(isinstance(m, port_quant.QLinear) for m in port.modules())
    n_conv = sum(isinstance(m, port_quant.QConv2d) for m in port.modules())
    return n_linear, n_conv


@pytest.fixture(scope="module")
def tiny_case():
    """Numpy inputs and one numpy-filled tree of the tiny UNet3D's shapes
    (the tree is the same with and without quant)."""
    inputs = _inputs(20)
    sample, ctx, il, emb, _ = inputs
    model = jax_unet3d.UNet3DConditionModel(jax_unet3d.UNet3DConfig.tiny())
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), sample, jnp.int32(1), ctx, il,
                              emb, jnp.float32(8.0))["params"]
    return inputs, numpy_params(abstract, 21)


@pytest.mark.parametrize("quant,cached", [("int8", False), ("int8_conv", False),
                                          ("int8", True), ("int8_conv", True)])
def test_quantised_unet3d_matches_jax(quant, cached, tiny_case, monkeypatch):
    """The tiny UNet3D under ``int8``/``int8_conv``, inline and through the
    step-invariant cache (whose cross-attention K/V come from the float
    weights in both packages), with injection on: the output at 1e-4, and
    each int8 site's output, teacher-forced, at 3e-5 of its range."""
    (sample, ctx, il, emb, fps), params = tiny_case
    model = jax_unet3d.UNet3DConditionModel(jax_unet3d.UNet3DConfig.tiny(quant=quant))
    port = port_unet3d.UNet3DConditionModel(port_unet3d.UNet3DConfig.tiny(quant=quant), device="cpu")
    load_params(port, params)
    args = (sample, jnp.int32(501), ctx, il, emb, fps, jnp.float32(1), jnp.float32(1), 0.7)
    pargs = (_t(sample), 501, _t(ctx), _t(il), _t(emb), _t(fps), 1.0, 1.0, 0.7)
    jkw, pkw = {}, {}
    if cached:
        jctx, jil, jkv = jax_unet3d.precompute_video_cache(model, params, ctx, il, emb, fps)
        jkw = dict(cached_ctx=jctx, cached_il=jil, cross_kv=jkv)
        with torch.no_grad():
            pctx, pil, pkv = port_unet3d.precompute_video_cache(port, *map(_t, (ctx, il, emb, fps)))
        pkw = dict(cached_ctx=pctx, cached_il=pil, cross_kv=pkv)
    jouts, pouts = [], []

    def keep(fn):
        def wrapped(*a, **k):
            y = fn(*a, **k)
            pouts.append(y.float().numpy())
            return y
        return wrapped

    with jax_sites(monkeypatch, jouts) as recorded:
        want = _jit_apply(model, params, *args, **jkw)
    with monkeypatch.context() as m:
        m.setattr(port_quant, "w8a8_matmul", keep(port_quant.w8a8_matmul))
        m.setattr(port_quant, "w8a8_conv", keep(port_quant.w8a8_conv))
        with forced_port_sites(monkeypatch, recorded), torch.no_grad():
            got = port(*pargs, **pkw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=MODEL_TOL, rtol=MODEL_TOL)
    assert len(jouts) == len(pouts) == len(recorded) > 0
    for (kind, _), jout, pout in zip(recorded, jouts, pouts):
        if kind == "conv":
            pout = pout.transpose(0, 2, 3, 1)  # the JAX package is NHWC
        assert pout.shape == jout.shape
        assert np.abs(pout - jout).max() <= SITE_TOL * max(np.abs(jout).max(), 1e-6)
    n_linear, n_conv = _site_counts(port)
    spatial_kv = 2 * len(port_unet3d.video_cross_attention_names(port.config))
    # the cache takes every spatial cross-attention's K/V off the int8 path
    assert len(recorded) == n_linear + n_conv - (spatial_kv if cached else 0)
    assert sum(kind == "conv" for kind, _ in recorded) == n_conv
    assert (n_conv > 0) == (quant == "int8_conv")


def _jax_site_count(cfg, monkeypatch):
    """The site keys of the JAX package's int8 matmul calls and the count
    of its int8 conv calls in one traced forward (``jax.eval_shape`` of
    ``init``: no arithmetic)."""
    calls = []

    def count(fn, kind):
        def wrapped(*a, **k):
            calls.append((kind, k.get("site")))
            return fn(*a, **k)
        return wrapped

    S = jax.ShapeDtypeStruct
    s = max(16, cfg.context_pool_size)
    x = S((1, 2, s, s, 4), jnp.float32)
    matmul = count(jax_quant.w8a8_matmul, "matmul")
    with monkeypatch.context() as m:
        m.setattr(jax_quant, "w8a8_matmul", matmul)
        m.setattr(jax_unet2d, "w8a8_matmul", matmul)
        m.setattr(jax_quant, "w8a8_conv", count(jax_quant.w8a8_conv, "conv"))
        jax.eval_shape(jax_unet3d.UNet3DConditionModel(cfg).init, jax.random.PRNGKey(0), x,
                       S((), jnp.int32), S((1, 6, cfg.cross_attention_dim), jnp.float32), x,
                       S((1, 1, cfg.cross_attention_dim), jnp.float32), S((), jnp.float32))
    return [site for kind, site in calls if kind == "matmul"], sum(kind == "conv" for kind, _ in calls)


def test_quant_site_counts_equal_the_jax_packages(monkeypatch):
    """The port's QLinear/QConv2d count equals the JAX package's int8
    matmul/conv calls at I2VGen-XL's topology (widths shrunk for the JAX
    trace, whose ``int8_conv`` calls give both modes' counts: ``int8``
    quantises the same matmuls and no conv), and the port's site keys are
    the JAX package's. (The tiny config's counts are held in
    ``test_quantised_unet3d_matches_jax``.)"""
    shrunk = dict(block_out_channels=(16, 32, 64, 64), attention_head_dim=8,
                  cross_attention_dim=32, norm_num_groups=8, context_pool_size=4)
    jax_sites_, n_conv = _jax_site_count(
        jax_unet3d.UNet3DConfig.i2vgen(quant="int8_conv", **shrunk), monkeypatch)
    for quant, want in (("int8", (len(jax_sites_), 0)), ("int8_conv", (len(jax_sites_), n_conv))):
        port = port_unet3d.UNet3DConditionModel(
            port_unet3d.UNet3DConfig.i2vgen(quant=quant, **shrunk), device="meta")
        assert _site_counts(port) == want, quant
    assert sorted(port_quant.quant_sites(port)) == sorted(jax_sites_)
    assert "transformer_in/transformer_blocks_0/attn2/qkv" in jax_sites_


def test_quantised_unet3d_keeps_the_float_modules_float():
    port = port_unet3d.UNet3DConditionModel(port_unet3d.UNet3DConfig.tiny(quant="int8_conv"),
                                            device="meta")
    for name in ("conv_in", "time_embedding.linear_1", "fps_embedding.0", "context_embedding.2",
                 "image_latents_context_embedding.0", "image_latents_proj_in.4",
                 "image_latents_temporal_encoder.attn1.to_qkv",
                 "image_latents_temporal_encoder.ff.net.2", "down_blocks.0.temp_convs.0.conv1.2",
                 "down_blocks.0.resnets.0.time_emb_proj", "conv_out"):
        assert not isinstance(port.get_submodule(name), (port_quant.QLinear, port_quant.QConv2d)), name
    assert isinstance(port.get_submodule("down_blocks.0.resnets.0.conv1"), port_quant.QConv2d)
    with pytest.raises(ValueError, match="quant"):
        port_unet3d.UNet3DConfig.tiny(quant="int4")
