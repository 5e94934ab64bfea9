"""The port's W8A8 serving path (ops/quant.py, the quant wiring of the UNet,
the int8 attention core) against the JAX package on the CPU.

Inputs and parameters come from numpy seeds and go through both packages.
Tolerances:

* single ops (weight quantisation, ``w8a8_matmul``, ``w8a8_conv``): 1e-6,
  the two compute the same int32 sums and the same fp32 scalings;
* the int8 attention's plain version against the Pallas kernel in interpret
  mode: 1e-4 of max |out| at the same block_k;
* whole models and trajectories: 1e-4 (atol and rtol), as for the float
  port, with the int8 sites teacher-forced. An activation that sits on a
  half step of its int8 grid rounds the other way on a 1-ulp difference
  between XLA's and torch's fp32 sums; each such flip moves that site's
  output by one quantisation step and the next sites' inputs with it, so
  unforced runs drift apart by up to the quantisation noise itself. Forcing
  feeds every port int8 site the JAX site's input (after checking the two
  agree to 1e-4 of their range) and so checks the wiring, the site order
  and everything between the sites at the float tolerance.
"""

import contextlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tweediemix_tpu.fusion import sampler as jax_sampler
from tweediemix_tpu.models import unet2d as jax_unet2d
from tweediemix_tpu.ops import quant as jax_quant
from tweediemix_tpu.ops.flash_attention import flash_attention as jax_flash
from tweediemix_tpu.schedulers import ddim as jax_ddim
from tweediemix_tpu_torch.fusion import sampler as port_sampler
from tweediemix_tpu_torch.models import unet2d as port_unet2d
from tweediemix_tpu_torch.models.convert import load_params
from tweediemix_tpu_torch.ops import attention as port_attn
from tweediemix_tpu_torch.ops import quant as port_quant
from tweediemix_tpu_torch.ops.flash_attention import (
    INT8_BLOCK_K,
    flash_attention,
    flash_attention_int8_reference,
    flash_attention_reference,
)
from tweediemix_tpu_torch.schedulers import ddim as port_ddim

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = 1e-6
MODEL_TOL = 1e-4


def _randn(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def numpy_params(abstract, seed, lora_up=0.0):
    """A parameter tree of the JAX model's shapes from a numpy seed (fan-in
    scaled kernels, norm scales near 1; LoRA up-factors of std ``lora_up``
    with slot 0 kept at zero)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['bias']"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "lora_up" in name:
            a = (lora_up * rng.standard_normal(s.shape)).astype(np.float32)
            a[0] = 0.0
            return a
        fan_in = s.shape[-2] if len(s.shape) == 3 else int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


# -- teacher forcing of the int8 sites ------------------------------------------


@contextlib.contextmanager
def jax_site_inputs(monkeypatch):
    """Record the input of every JAX int8 site, in call order (eager only)."""
    recorded = []

    def spy(fn, kind):
        def wrapped(x, *args, **kwargs):
            recorded.append((kind, np.asarray(x)))
            return fn(x, *args, **kwargs)
        return wrapped

    with monkeypatch.context() as m:
        matmul = spy(jax_quant.w8a8_matmul, "matmul")
        m.setattr(jax_quant, "w8a8_matmul", matmul)
        m.setattr(jax_unet2d, "w8a8_matmul", matmul)
        m.setattr(jax_quant, "w8a8_conv", spy(jax_quant.w8a8_conv, "conv"))
        yield recorded


@contextlib.contextmanager
def forced_port_sites(monkeypatch, recorded):
    """Feed every port int8 site the recorded JAX input of the same call,
    after checking that the port's own input agrees with it."""
    queue = list(recorded)
    worst = []

    def force(fn, kind):
        def wrapped(x, *args, **kwargs):
            want_kind, want = queue.pop(0)
            assert want_kind == kind, (kind, want_kind)
            forced = torch.from_numpy(want.copy())
            if kind == "conv":
                forced = forced.permute(0, 3, 1, 2)  # the JAX package is NHWC
            assert tuple(forced.shape) == tuple(x.shape), (forced.shape, x.shape)
            worst.append(float((x.float() - forced).abs().max() / (forced.abs().max() + 1e-6)))
            return fn(forced.to(x.dtype), *args, **kwargs)
        return wrapped

    with monkeypatch.context() as m:
        m.setattr(port_quant, "w8a8_matmul", force(port_quant.w8a8_matmul, "matmul"))
        m.setattr(port_quant, "w8a8_conv", force(port_quant.w8a8_conv, "conv"))
        yield
    assert not queue, f"{len(queue)} JAX int8 sites were not reached by the port"
    assert worst and max(worst) <= MODEL_TOL, max(worst)


# -- ops ---------------------------------------------------------------------


def test_quantize_weight_int8_matches_jax():
    rng = np.random.default_rng(0)
    w = _randn(rng, (48, 64))  # JAX [in, out]
    wq, s = jax_quant.quantize_weight_int8(w)
    pq, ps = port_quant.quantize_weight_int8(torch.from_numpy(w.T.copy()))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(wq).T)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(s))
    wc = _randn(rng, (3, 3, 16, 24))  # HWIO
    cq, cs = jax_quant.quantize_weight_int8_conv(wc)
    pq, ps = port_quant.quantize_weight_int8_conv(torch.from_numpy(wc.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(cq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(cs))


@pytest.mark.parametrize("static_amax", [0.0, 2.5])
def test_w8a8_matmul_matches_jax(static_amax, monkeypatch):
    """Dynamic per-row scales, and a static per-tensor scale that clips the
    tail of a randn input."""
    rng = np.random.default_rng(1)
    x, w = _randn(rng, (3, 7, 48)), _randn(rng, (48, 40), 0.2)
    wq, ws = jax_quant.quantize_weight_int8(w)
    monkeypatch.setenv("TWEEDIEMIX_QUANT_STATIC_SCALE", str(static_amax))
    want = jax_quant.w8a8_matmul(x, wq, ws)
    pq, ps = port_quant.quantize_weight_int8(torch.from_numpy(w.T.copy()))
    got = port_quant.w8a8_matmul(torch.from_numpy(x), pq, ps, static_amax)
    assert got.shape == (3, 7, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_TOL, rtol=OP_TOL)
    zeros = port_quant.w8a8_matmul(torch.zeros(2, 5, 48), pq, ps, static_amax)
    assert torch.equal(zeros, torch.zeros(2, 5, 40))


@pytest.mark.parametrize("static_amax", [0.0, 2.5])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8a8_matmul_takes_the_bias_as_the_module_added_it(static_amax, dtype):
    """The plain version with ``bias=`` equals the product cast to x's dtype
    plus the bias in that dtype (what ``QLinear`` computed before the bias
    moved into ``w8a8_matmul``) bit for bit, and a CPU ``QLinear`` equals
    that composition."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_randn(rng, (3, 7, 48))).to(dtype)
    lin = port_quant.QLinear(48, 32).to(dtype)
    lin.static_amax = static_amax
    with torch.no_grad():
        lin.bias.copy_(torch.from_numpy(_randn(rng, (32,))))
    wq, ws, b = lin.weight_q, lin.weight_scale, lin.bias.detach()
    composed = port_quant.w8a8_matmul_reference(x, wq, ws, static_amax) + b.to(dtype)
    for got in (port_quant.w8a8_matmul_reference(x, wq, ws, static_amax, b),
                port_quant.w8a8_matmul(x, wq, ws, static_amax, bias=b), lin(x).detach()):
        assert got.dtype == dtype and torch.equal(got, composed)


@pytest.mark.parametrize("static_amax", [0.0, 2.5])
def test_w8a8_matmul_with_bias_matches_jax(static_amax, monkeypatch):
    """The JAX package's site adds its bias after ``w8a8_matmul``; the
    port's takes it as an argument."""
    rng = np.random.default_rng(4)
    x, w, b = _randn(rng, (2, 9, 64)), _randn(rng, (64, 48), 0.2), _randn(rng, (48,))
    wq, ws = jax_quant.quantize_weight_int8(w)
    monkeypatch.setenv("TWEEDIEMIX_QUANT_STATIC_SCALE", str(static_amax))
    want = np.asarray(jax_quant.w8a8_matmul(x, wq, ws)) + b
    pq, ps = port_quant.quantize_weight_int8(torch.from_numpy(w.T.copy()))
    got = port_quant.w8a8_matmul(torch.from_numpy(x), pq, ps, static_amax, bias=torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=OP_TOL, rtol=OP_TOL)


def test_qlinear_hands_its_bias_to_the_w8a8_matmul_seam(monkeypatch):
    """``QLinear`` reaches its product through the module-level
    ``w8a8_matmul`` (the seam ``forced_port_sites`` patches) with the bias
    as a keyword, and a bias-free site passes None."""
    seen = []

    def spy(x, wq, wscale, static_amax=0.0, bias=None):
        seen.append(bias)
        return port_quant.w8a8_matmul_reference(x, wq, wscale, static_amax, bias)

    monkeypatch.setattr(port_quant, "w8a8_matmul", spy)
    x = torch.randn(4, 32)
    with torch.no_grad():
        port_quant.QLinear(32, 16)(x)
        port_quant.QLinear(32, 16, bias=False)(x)
    assert len(seen) == 2 and seen[0] is not None and seen[0].shape == (16,) and seen[1] is None


@pytest.mark.parametrize("k,n,dtype,error", [
    (72, 64, torch.bfloat16, ValueError), (64, 40, torch.bfloat16, ValueError),
    (8, 64, torch.float32, ValueError), (64, 64, torch.float16, TypeError),
    (64, 64, torch.float64, TypeError)])
def test_w8a8_kernel_args_refuse_what_the_kernels_lack(k, n, dtype, error):
    with pytest.raises(error):
        port_quant.check_w8a8_args(k, n, dtype)


# (M, K, N) of the SDXL W8A8 linear sites at 2 and 4 latent rows
SDXL_W8A8_SHAPES = [(rows * tokens, k, n) for rows in (2, 4)
                    for tokens, pairs in ((4096, ((640, 1920), (640, 640), (640, 5120), (2560, 640))),
                                          (1024, ((1280, 3840), (1280, 1280), (1280, 10240),
                                                  (5120, 1280))))
                    for k, n in pairs]


@pytest.mark.parametrize("m,k,n", SDXL_W8A8_SHAPES)
def test_w8a8_tile_plan_fills_the_sms_at_the_sdxl_sites(m, k, n):
    """Every SDXL site takes the kernels (bf16, K and N multiples of 16),
    its N is a whole number of the GEMM's tile columns, and its last wave of
    tiles fills at least 90% of an H100's 132 SMs."""
    for dtype in port_quant.W8A8_DTYPE_CODES:
        port_quant.check_w8a8_args(k, n, dtype)
    assert n % port_quant.W8A8_BLOCK_N == 0
    tiles = -(-m // port_quant.W8A8_BLOCK_M) * (n // port_quant.W8A8_BLOCK_N)
    waves = -(-tiles // 132)
    grid = port_quant.gemm_grid(m, n, 132)
    assert grid == min(tiles, 132) and tiles / (waves * 132) >= 0.9, tiles


@pytest.mark.parametrize("m,n", [(1, 16), (17, 48), (308, 960), (4096, 640), (131072, 1280)])
def test_w8a8_tile_plan_of_ragged_and_video_rows(m, n):
    """One block per tile up to one per SM, a partial tile counted whole;
    the work buffer holds x_q padded to 16 bytes, then 4 bytes a row for
    a dynamic scale."""
    tiles = -(-m // 128) * -(-n // 160)
    assert port_quant.gemm_grid(m, n, 132) == min(tiles, 132) >= 1
    xq = -(-m * 320 // 16) * 16
    assert port_quant.w8a8_work_bytes(m, 320, False) == xq
    assert port_quant.w8a8_work_bytes(m, 320, True) == xq + 4 * m


@pytest.mark.parametrize("stride", [1, 2])
def test_w8a8_conv_matches_jax(stride):
    rng = np.random.default_rng(2)
    x, w = _randn(rng, (2, 9, 9, 16)), _randn(rng, (3, 3, 16, 24), 0.1)
    wq, ws = jax_quant.quantize_weight_int8_conv(w)
    want = jax_quant.w8a8_conv(x, wq, ws, strides=(stride, stride))
    pq, ps = port_quant.quantize_weight_int8_conv(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    got = port_quant.w8a8_conv(torch.from_numpy(x).permute(0, 3, 1, 2), pq, ps, stride=stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=OP_TOL, rtol=OP_TOL)


def test_quantised_modules_keep_fp32_scales_and_no_float_weight():
    torch.manual_seed(0)
    lin = port_quant.QLinear(32, 16)
    conv = port_quant.QConv2d(8, 16, stride=2)
    kept = port_quant.QLinear(32, 16, bias=False, keep_weight=True)
    scales = [m.weight_scale.clone() for m in (lin, conv, kept)]
    for m, s in zip((lin, conv, kept), scales):
        m.to(torch.bfloat16)
        assert m.weight_scale.dtype == torch.float32 and torch.equal(m.weight_scale, s)
        assert m.weight_q.dtype == torch.int8
    assert lin.bias.dtype == torch.bfloat16 and lin.weight is None
    assert kept.weight.dtype == torch.bfloat16
    assert set(lin.state_dict()) == {"weight_q", "weight_scale", "bias"}
    out = lin(torch.randn(2, 5, 32).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 5, 16)
    assert conv(torch.randn(2, 8, 9, 9)).shape == (2, 16, 5, 5)


# -- the int8 attention core ---------------------------------------------------


@pytest.mark.parametrize("bh,sq,sk,dh", [(4, 256, 256, 64), (2, 300, 300, 64),
                                         (2, 128, 128, 128), (2, 300, 300, 128)])
def test_int8_flash_plain_matches_pallas_interpret(bh, sq, sk, dh):
    """The count-column denominator (dh=64), the row-sum one (dh=128), and
    ragged keys, at the shapes of test_attention.py's int8 test; at block_k
    128 and at the Hopper kernel's block width for this dh (INT8_BLOCK_K),
    which is also the plain version's default."""
    rng = np.random.default_rng(bh * 1000 + sq + sk + dh)
    q, k, v = _randn(rng, (bh, sq, dh)), _randn(rng, (bh, sk, dh)), _randn(rng, (bh, sk, dh))
    for block_k in sorted({128, INT8_BLOCK_K[dh]}):
        want = np.asarray(jax_flash(q, k, v, block_q=128, block_k=block_k, interpret=True,
                                    int8_qkpv=True))
        got = flash_attention_int8_reference(*map(torch.from_numpy, (q, k, v)), block_k=block_k)
        assert got.shape == (bh, sq, dh) and got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
        if block_k == INT8_BLOCK_K[dh]:
            default = flash_attention_int8_reference(*map(torch.from_numpy, (q, k, v)))
            assert torch.equal(default, got)


def test_int8_flash_depends_on_block_width_and_stays_near_exact():
    """p8 is quantised against the running max, so the block width changes
    the result; at the kernel's width the output keeps the JAX test's bounds
    against exact attention (corr > 0.999, max err < 0.12 of max)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_randn(rng, (2, 256, 64))) for _ in range(3))
    narrow = flash_attention_int8_reference(q, k, v, block_k=INT8_BLOCK_K[64])
    wide = flash_attention_int8_reference(q, k, v, block_k=256)
    assert not torch.equal(narrow, wide)
    exact = flash_attention_reference(q, k, v).numpy().ravel()
    out = narrow.numpy().ravel()
    assert np.corrcoef(exact, out)[0, 1] > 0.999
    assert np.abs(out - exact).max() < 0.12 * np.abs(exact).max()


def test_int8_knob_sends_flash_sites_to_the_int8_core_on_cpu(monkeypatch):
    """TWEEDIEMIX_FLASH_INT8=1 is read on each call; on CPU tensors the flash
    sites take the int8 core's plain version at the kernel's block width."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_randn(rng, (2, 1024, 64), 0.5)) for _ in range(3))
    monkeypatch.setenv("TWEEDIEMIX_FLASH_INT8", "1")
    got = port_attn.attention(q, k, v)
    assert torch.equal(got, flash_attention_int8_reference(q, k, v, block_k=INT8_BLOCK_K[64]))
    assert torch.equal(flash_attention(q, k, v, int8_qkpv=True), got)
    k77 = k[:, :77]
    assert torch.equal(port_attn.attention(q, k77, k77), port_attn.math_attention(q, k77, k77, 0.125))
    monkeypatch.setenv("TWEEDIEMIX_FLASH_INT8", "0")
    assert torch.equal(port_attn.attention(q, k, v), flash_attention_reference(q, k, v))


# -- UNet ----------------------------------------------------------------------


def _unet_case(preset, kw, seed=0, lora_up=0.0):
    jcfg = getattr(jax_unet2d.UNetConfig, preset)(**kw)
    model = jax_unet2d.UNet2DConditionModel(jcfg)
    rng = np.random.default_rng(seed)
    x = _randn(rng, (3, 8, 8, 4), 0.4)
    ctx = _randn(rng, (3, 9, jcfg.cross_attention_dim), 0.2)
    pooled = _randn(rng, (3, jcfg.pooled_projection_dim), 0.2)
    tids = np.tile(np.array([[64.0, 64, 0, 0, 64, 64]], np.float32), (3, 1))
    slots = max(kw.get("concept_slots", 0), kw.get("lora_slots", 0), 1)
    idx = (np.arange(3) % slots).astype(np.int32)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, jnp.int32(5), ctx, pooled,
                              tids, idx)["params"]
    params = numpy_params(abstract, seed, lora_up)
    port = port_unet2d.UNet2DConditionModel(getattr(port_unet2d.UNetConfig, preset)(**kw),
                                            device="cpu")
    load_params(port, params)
    return model, params, port, (x, ctx, pooled, tids, idx)


def _torch(inputs):
    x, ctx, pooled, tids, idx = inputs
    return (torch.from_numpy(x), torch.from_numpy(ctx), torch.from_numpy(pooled),
            torch.from_numpy(tids), torch.from_numpy(idx).long())


@pytest.mark.parametrize(
    "preset,kw,lora_up",
    [("micro", dict(concept_slots=3, quant="int8"), 0.0),
     ("micro", dict(quant="int8_conv"), 0.0),
     ("tiny", dict(quant="int8"), 0.0),
     ("tiny", dict(concept_slots=4, quant="int8"), 0.0),
     ("tiny", dict(concept_slots=4, quant="int8_conv"), 0.0),
     ("tiny", dict(lora_slots=3, quant="int8"), 0.05),
     ("micro", dict(concept_slots=3, lora_slots=3, lora_rank=2, quant="int8_conv"), 0.05)],
)
def test_quantised_unet_matches_jax(preset, kw, lora_up, monkeypatch):
    model, params, port, inputs = _unet_case(preset, kw, lora_up=lora_up)
    x, ctx, pooled, tids, idx = inputs
    with jax_site_inputs(monkeypatch) as recorded:
        want = model.apply({"params": params}, x, jnp.int32(501), ctx, pooled, tids, idx)
    px, pctx, ppooled, ptids, pidx = _torch(inputs)
    with forced_port_sites(monkeypatch, recorded), torch.no_grad():
        got = port(px, 501, pctx, ppooled, ptids, pidx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL, rtol=MODEL_TOL)
    n_linear = len(port_quant.quant_sites(port))
    n_conv = sum(isinstance(m, port_quant.QConv2d) for m in port.modules())
    assert len(recorded) == n_linear + n_conv and n_linear > 0
    assert (n_conv > 0) == (kw["quant"] == "int8_conv")


def test_quantised_unet_with_static_scales_matches_jax(tmp_path, monkeypatch):
    """Per-site static scales from a JSON table (half the sites, the rest
    dynamic), the JAX side reading the same file through
    TWEEDIEMIX_QUANT_SCALES."""
    model, params, port, inputs = _unet_case("tiny", dict(concept_slots=4, quant="int8"), seed=3)
    sites = sorted(port_quant.quant_sites(port))
    table = {site: 0.5 + 0.25 * i for i, site in enumerate(sites[::2])}
    path = tmp_path / "scales.json"
    path.write_text(json.dumps(table))
    assert port_quant.load_static_scales(port, str(path)) == len(table)
    x, ctx, pooled, tids, idx = inputs
    monkeypatch.setenv("TWEEDIEMIX_QUANT_SCALES", str(path))
    jax_quant._static_scales_table.cache_clear()
    try:
        with jax_site_inputs(monkeypatch) as recorded:
            want = model.apply({"params": params}, x, jnp.int32(301), ctx, pooled, tids, idx)
    finally:
        monkeypatch.delenv("TWEEDIEMIX_QUANT_SCALES")
        jax_quant._static_scales_table.cache_clear()
    with forced_port_sites(monkeypatch, recorded), torch.no_grad():
        got = port(*_torch(inputs)[:1], 301, *_torch(inputs)[1:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL, rtol=MODEL_TOL)


def test_load_static_scales_dict_default_and_missing_sites():
    port = port_unet2d.UNet2DConditionModel(port_unet2d.UNetConfig.micro(quant="int8"),
                                            device="cpu")
    sites = port_quant.quant_sites(port)
    first = sorted(sites)[0]
    assert port_quant.load_static_scales(port, {first: 3.0, "not/a/site": 1.0}) == 1
    assert sites[first].static_amax == 3.0
    assert all(m.static_amax == 0.0 for s, m in sites.items() if s != first)
    port_quant.load_static_scales(port, {}, default_amax=2.0)
    assert all(m.static_amax == 2.0 for m in sites.values())
    port_quant.load_static_scales(port, None)
    assert all(m.static_amax == 0.0 for m in sites.values())


def test_sdxl_quant_sites_are_the_static_scale_table():
    """Full SDXL with four concept slots on the meta device: the quantised
    sites are exactly the 442 keys of quant_scales_sdxl.json (70 transformer
    blocks x 6 matmul sites + 11 transformers x proj_in/proj_out), and
    int8_conv adds convolutions only."""
    with open(os.path.join(REPO, "quant_scales_sdxl.json")) as f:
        table = json.load(f)
    unet = port_unet2d.UNet2DConditionModel(
        port_unet2d.UNetConfig.sdxl(concept_slots=4, quant="int8"), device="meta")
    sites = port_quant.quant_sites(unet)
    assert len(table) == 442 == 70 * 6 + 11 * 2
    assert set(sites) == set(table)
    assert port_quant.load_static_scales(unet, os.path.join(REPO, "quant_scales_sdxl.json")) == 442
    conv = port_unet2d.UNet2DConditionModel(
        port_unet2d.UNetConfig.sdxl(concept_slots=4, quant="int8_conv"), device="meta")
    assert set(port_quant.quant_sites(conv)) == set(table)
    # 3 levels: resnets (2+2+2 down, 2 mid, 3+3+3 up) x 2 convs + 2 down + 2 up samplers
    assert sum(isinstance(m, port_quant.QConv2d) for m in conv.modules()) == 17 * 2 + 4


def test_quant_option_is_checked():
    with pytest.raises(ValueError, match="quant"):
        port_unet2d.UNetConfig.micro(quant="int4")
    assert port_unet2d.UNetConfig.micro(quant="int8_conv").quant == "int8_conv"


def test_calibrate_matches_the_jax_tool(monkeypatch):
    """The port's calibrate against tools/calibrate_quant.py::calibrate:
    same weights, the tool's three probe timesteps at batch N+1 = 4, margin
    1.25; the tool runs eagerly so that its int8 sites can be recorded and
    the port's forced."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from calibrate_quant import calibrate as jax_calibrate
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    model, params, port, inputs = _unet_case("micro", dict(concept_slots=4, quant="int8"), seed=4)
    rng = np.random.default_rng(9)
    x = _randn(rng, (4, 8, 8, 4))
    ctx = _randn(rng, (4, 16, 32), 0.1)
    pooled = _randn(rng, (4, 32), 0.1)
    tids = np.tile(np.array([[64.0, 64, 0, 0, 64, 64]], np.float32), (4, 1))
    idx = np.arange(4, dtype=np.int32)
    monkeypatch.setenv("TWEEDIEMIX_QUANT_CALIBRATE", "1")
    with jax_site_inputs(monkeypatch) as recorded, jax.disable_jit():
        want = jax_calibrate(model, params, [(x, jnp.int32(t), ctx, pooled, tids, idx)
                                             for t in (999, 501, 1)], margin=1.25)
    monkeypatch.delenv("TWEEDIEMIX_QUANT_CALIBRATE")
    px, pctx, ppooled, ptids, pidx = _torch((x, ctx, pooled, tids, idx))
    with forced_port_sites(monkeypatch, recorded):
        got = port_quant.calibrate(
            port, [(px, t, pctx, ppooled, ptids, pidx) for t in (999, 501, 1)], margin=1.25)
    assert set(got) == set(want) == set(port_quant.quant_sites(port))
    for site in want:
        assert got[site] == pytest.approx(want[site], rel=MODEL_TOL), site


def test_precompute_cross_kv_keeps_the_float_projection_under_quant():
    """A non-stacked cross-attention under quant: the in-module K/V are
    quantised, the precomputed cache is a plain float projection, as in the
    JAX package (``precompute_cross_kv`` uses ``ctx @ kernel``)."""
    model, params, port, inputs = _unet_case("tiny", dict(quant="int8"), seed=6)
    x, ctx, pooled, tids, idx = inputs
    want = jax_unet2d.precompute_cross_kv(model.config, params, ctx, idx)
    _, pctx, _, _, pidx = _torch(inputs)
    with torch.no_grad():
        kv = port_unet2d.precompute_cross_kv(port, pctx, pidx)
        attn2 = port.transformer("up_blocks_0_attentions_0").transformer_blocks[0].attn2
        inline_k, _ = attn2.kv(pctx, pidx)
    for name, (k, v) in kv.items():
        np.testing.assert_allclose(k.numpy(), np.asarray(want[name][0]), atol=3e-5, rtol=1e-4)
        np.testing.assert_allclose(v.numpy(), np.asarray(want[name][1]), atol=3e-5, rtol=1e-4)
    cached_k = kv["up_blocks_0_attentions_0"][0][0]
    assert not torch.equal(inline_k, cached_k)
    assert (inline_k - cached_k).abs().max() < 0.05 * cached_k.abs().max()


# -- the slice as a whole ----------------------------------------------------------


def test_quantised_micro_trajectory_matches_jax(monkeypatch):
    """The 4-step micro fusion trajectory (prologue resampling, joint step,
    jumping, masked fusion) with a W8A8 UNet and two seeds, through the JAX
    sampler run eagerly with its cross-K/V cache (so its int8 sites can be
    recorded) and the port's sampler, whose UNet call builds the float K/V
    per call, as the pipeline's runner does."""
    n, hw = 2, 8
    kw = dict(concept_slots=n + 1, quant="int8")
    jcfg = jax_unet2d.UNetConfig.micro(**kw)
    model = jax_unet2d.UNet2DConditionModel(jcfg)
    abstract = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), np.zeros((2, hw, hw, 4), np.float32), jnp.int32(1),
        np.zeros((2, 5, 32), np.float32), np.zeros((2, 32), np.float32),
        np.zeros((2, 6), np.float32), np.zeros((2,), np.int32))["params"]
    params = numpy_params(abstract, 23)
    port = port_unet2d.UNet2DConditionModel(port_unet2d.UNetConfig.micro(**kw), device="cpu")
    load_params(port, params)
    fkw = dict(n_timesteps=4, guidance_scale=0.8, t_cond=0.5, resampling_steps=1,
               jumping_steps=1, height=hw * 8, width=hw * 8, num_concepts=n)
    rng = np.random.default_rng(3821)
    embeds = [(0.2 * rng.standard_normal(s)).astype(np.float32)
              for m in (2, n - 1, n + 1) for s in ((m, 5, 32), (m, 32))]
    fg = np.zeros((n - 1, hw * 8, hw * 8), np.float32)
    fg[0, :, : hw * 4] = 1.0
    x_init = _randn(rng, (2, hw, hw, 4))
    tids = np.array([[float(hw * 8), hw * 8, 0, 0, hw * 8, hw * 8]], np.float32)

    def jax_unet(p, x, t, ctx, pooled, idx, cross_kv=None):
        return model.apply({"params": p}, x, t, ctx, pooled, jnp.tile(tids, (x.shape[0], 1)), idx,
                           cross_kv=cross_kv)

    def jax_kv(p, ctx, idx):
        return jax_unet2d.precompute_cross_kv(jcfg, p, ctx, idx)

    sampler = jax_sampler.FusionSampler(
        jax_ddim.DDIMTable.create(n_steps=4), jax_sampler.FusionConfig(**fkw), jax_unet,
        unet_params=params, kv_builder=jax_kv)
    with jax_site_inputs(monkeypatch) as recorded, jax.disable_jit():
        want = sampler.run(jax_sampler.TextEmbeds(*embeds), jax.random.PRNGKey(0), fg_masks=fg,
                           num_seeds=2, x_init=jnp.asarray(x_init))

    def port_unet(x, t, ctx, pooled, idx):
        return port(x, t, ctx, pooled, torch.from_numpy(tids).expand(x.shape[0], 6), idx,
                    cross_kv=port_unet2d.precompute_cross_kv(port, ctx, idx))

    port_s = port_sampler.FusionSampler(
        port_ddim.DDIMTable.create(n_steps=4), port_sampler.FusionConfig(**fkw), port_unet)
    with forced_port_sites(monkeypatch, recorded), torch.no_grad():
        got = port_s.run(port_sampler.TextEmbeds(*map(torch.from_numpy, embeds)),
                         fg_masks=torch.from_numpy(fg), num_seeds=2,
                         x_init=torch.from_numpy(x_init))
    calls = port_sampler.FusionConfig(**fkw).unet_calls()
    assert len(recorded) == calls * len(port_quant.quant_sites(port)) == 7 * 32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL, rtol=MODEL_TOL)
