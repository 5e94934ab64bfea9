"""The torch port's ops against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages. Tolerances:
fp32 atol 3e-5 / rtol 1e-4 (the block-level tolerance of
test_torch_parity_blocks.py), for sum-order differences between XLA and
torch on the CPU. The Pallas flash kernel runs in interpret mode, as the
JAX package's own tests run it; the port's wrapper takes its plain version
because the tensors lie on the CPU. The Hopper kernel itself is checked on
the card (test_torch_port_kernels.py and chip_smoke.py).
"""

import importlib
import os

import numpy as np
import pytest
import torch

from tweediemix_tpu.ops.flash_attention import flash_attention as jax_flash
from tweediemix_tpu.ops.stacked import lora_delta as jax_lora_delta
from tweediemix_tpu.ops.stacked import stacked_linear as jax_stacked_linear
from tweediemix_tpu_torch.ops import attention as port_attn
from tweediemix_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from tweediemix_tpu_torch.ops.stacked import lora_delta, stacked_linear

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

# tweediemix_tpu.ops re-exports the `attention` function under the module's
# name, so import the module explicitly
jax_attn = importlib.import_module("tweediemix_tpu.ops.attention")

ATOL, RTOL = 3e-5, 1e-4


def _randn(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("bh,sq,sk,dh", [(2, 256, 256, 64), (2, 300, 300, 128), (3, 256, 77, 64)])
def test_flash_plain_matches_pallas_interpret(bh, sq, sk, dh):
    rng = np.random.default_rng(bh * 1000 + sq + sk + dh)
    q, k, v = _randn(rng, (bh, sq, dh)), _randn(rng, (bh, sk, dh)), _randn(rng, (bh, sk, dh))
    want = jax_flash(q, k, v, block_q=128, block_k=128, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert got.shape == (bh, sq, dh) and got.dtype == torch.float32
    _close(got, want)
    _close(flash_attention_reference(*map(torch.from_numpy, (q, k, v))), want)


def test_flash_wrapper_keeps_dtype_and_counts_no_cpu_launch():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_randn(rng, (2, 64, 64))).to(torch.bfloat16)
    before = flash_attention.launches
    out = flash_attention(q, q, q)
    assert out.dtype == torch.bfloat16
    assert flash_attention.launches == before  # the plain version is no launch


@pytest.mark.parametrize(
    "shapes",
    [((2, 64, 64), (2, 64, 32), (2, 64, 64)), ((2, 64, 64), (3, 64, 64), (3, 64, 64)),
     ((2, 64, 64), (2, 0, 64), (2, 0, 64))],
)
def test_flash_wrapper_rejects_bad_shapes(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        flash_attention(q, k, v)


@pytest.mark.parametrize(
    "bh,sq,sk,dh",
    [(2, 1024, 1024, 64),  # a flash site: the plain version on the CPU
     (2, 1024, 77, 64),  # cross-attention: math path
     (3, 96, 96, 16)],  # small self-attention: math path
)
def test_attention_matches_jax(bh, sq, sk, dh):
    rng = np.random.default_rng(sq + sk + dh)
    q, k, v = (_randn(rng, (bh, s, dh), 0.5) for s in (sq, sk, sk))
    assert port_attn.uses_flash(sq, sk, dh) == (sq >= 1024 and sk >= 1024)
    want = jax_attn.attention(q, k, v)
    _close(port_attn.attention(*map(torch.from_numpy, (q, k, v))), want)


def test_chunked_fallback_matches_jax(monkeypatch):
    """Under a small score cap both packages switch to query chunks
    (300 queries in chunks of 8: the last chunk is ragged)."""
    rng = np.random.default_rng(5)
    q, k, v = _randn(rng, (2, 300, 16)), _randn(rng, (2, 50, 16)), _randn(rng, (2, 50, 16))
    cap = 4 * 2 * 8 * 50  # one 8-query chunk
    monkeypatch.setattr(jax_attn, "_XLA_SCORE_BYTES_CAP", cap)
    monkeypatch.setattr(port_attn, "SCORE_BYTES_CAP", cap)
    want = jax_attn.attention(q, k, v)
    got = port_attn.attention(*map(torch.from_numpy, (q, k, v)))
    _close(got, want)
    _close(port_attn.chunked_attention(*map(torch.from_numpy, (q, k, v)), 16**-0.5, 7),
           jax_attn._xla_attention_chunked(q, k, v, 16**-0.5, 7))


def test_heads_and_multi_head_attention_match_jax():
    rng = np.random.default_rng(9)
    x = _randn(rng, (2, 40, 48))
    got = port_attn.split_heads(torch.from_numpy(x), 3)
    want = jax_attn.split_heads(x, 3)
    _close(got, want, atol=0, rtol=0)
    _close(port_attn.merge_heads(got, 3), x, atol=0, rtol=0)
    q, k, v = (_randn(rng, (2, s, 48)) for s in (40, 12, 12))
    _close(port_attn.multi_head_attention(*map(torch.from_numpy, (q, k, v)), 3),
           jax_attn.multi_head_attention(q, k, v, 3))


@pytest.mark.parametrize("with_bias", [False, True])
def test_stacked_linear_matches_jax(with_bias):
    rng = np.random.default_rng(11)
    x, w = _randn(rng, (3, 7, 16)), _randn(rng, (4, 16, 24))
    b = _randn(rng, (4, 24)) if with_bias else None
    idx = np.array([0, 3, 1], np.int32)
    want = jax_stacked_linear(x, w, idx, b)
    got = stacked_linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(idx).long(),
                         None if b is None else torch.from_numpy(b))
    _close(got, want)


def test_lora_delta_matches_jax():
    rng = np.random.default_rng(12)
    x = _randn(rng, (3, 7, 16))
    down, up = _randn(rng, (4, 16, 4)), _randn(rng, (4, 4, 24))
    up[0] = 0.0  # slot 0 is the zero delta
    idx = np.array([0, 2, 3], np.int32)
    want = jax_lora_delta(x, down, up, idx)
    got = lora_delta(*map(torch.from_numpy, (x, down, up)), torch.from_numpy(idx).long())
    _close(got, want)
    assert float(got[0].abs().max()) == 0.0



# -- the reference's attention knobs (tests/test_attention.py:270-310) ------------


def test_xla_knob_sends_a_flash_site_to_the_math_path(monkeypatch):
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(_randn(rng, (2, 1024, 64), 0.5)) for _ in range(3))
    assert port_attn.uses_flash(1024, 1024, 64)
    calls = []
    monkeypatch.setattr(port_attn, "flash_attention", lambda *a, **kw: calls.append(1))
    monkeypatch.setenv("TWEEDIEMIX_ATTENTION", "xla")
    assert not port_attn.uses_flash(1024, 1024, 64)
    got = port_attn.attention(q, k, v)
    assert calls == []
    _close(got, port_attn.math_attention(q, k, v, 64**-0.5), atol=0, rtol=0)
    monkeypatch.setenv("TWEEDIEMIX_ATTENTION", "auto")
    port_attn.attention(q, k, v)
    assert calls == [1]


@pytest.mark.parametrize("mode", ["auto", "flash"])
def test_flash_min_s_sends_s256_to_the_flash_plain_version(monkeypatch, mode):
    """Under TWEEDIEMIX_FLASH_MIN_S=256 an S = 256 site takes the flash
    path (its plain version on the CPU), equal to the JAX package's
    ``attention(..., interpret=True)`` under the same environment; below the
    threshold, and at the default, it stays on the math path."""
    rng = np.random.default_rng(22)
    q, k, v = (_randn(rng, (2, 256, 64), 0.5) for _ in range(3))
    monkeypatch.setenv("TWEEDIEMIX_ATTENTION", mode)
    if mode == "auto":
        assert not port_attn.uses_flash(256, 256, 64)
    monkeypatch.setenv("TWEEDIEMIX_FLASH_MIN_S", "256")
    assert port_attn.uses_flash(256, 256, 64)
    assert not port_attn.uses_flash(256, 255, 64)
    assert port_attn.uses_flash(128, 256, 64) == (mode == "flash")
    seen = []
    monkeypatch.setattr(port_attn, "flash_attention",
                        lambda *a, **kw: seen.append(1) or flash_attention(*a, **kw))
    got = port_attn.attention(*map(torch.from_numpy, (q, k, v)))
    assert seen == [1]
    monkeypatch.setattr(jax_attn.jax, "default_backend", lambda: "tpu")  # the auto gate's backend
    want = jax_attn.attention(q, k, v, interpret=True)
    _close(got, want)


def test_flash_knob_raises_on_a_head_dim_the_kernel_does_not_take(monkeypatch):
    rng = np.random.default_rng(23)
    q = torch.from_numpy(_randn(rng, (2, 1024, 40)))
    assert not port_attn.uses_flash(1024, 1024, 40)
    monkeypatch.setenv("TWEEDIEMIX_ATTENTION", "flash")
    with pytest.raises(ValueError, match="dh 40"):
        port_attn.attention(q, q, q)
    k77 = torch.from_numpy(_randn(rng, (2, 77, 40)))
    assert port_attn.attention(q, k77, k77).shape == q.shape  # sk below the threshold: math
    monkeypatch.setenv("TWEEDIEMIX_ATTENTION", "fast")
    with pytest.raises(ValueError, match="TWEEDIEMIX_ATTENTION"):
        port_attn.uses_flash(1024, 1024, 64)


@pytest.mark.parametrize("bh,sq,sk,dh", [(8, 16, 16, 64), (2, 256, 77, 64)])
def test_bf16_scores_branch_matches_jax(monkeypatch, bh, sq, sk, dh):
    """TWEEDIEMIX_BF16_SCORES_MAX_SK=128: bf16 inputs with sk <= 128 take
    the bf16-score branch, equal to the JAX package's ``_xla_attention``
    under the same setting to one bf16 rounding of the output (2^-8 of max
    |out|); at the default (0) the branch is off and the port's fp32-softmax
    result is returned."""
    import jax.numpy as jnp

    rng = np.random.default_rng(bh + sq + sk)
    q, k, v = (_randn(rng, (bh, s, dh)) for s in (sq, sk, sk))
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    default = port_attn.math_attention(qb, kb, vb, dh**-0.5)
    monkeypatch.setenv("TWEEDIEMIX_BF16_SCORES_MAX_SK", "128")
    got = port_attn.attention(qb, kb, vb)
    want = np.asarray(jax_attn._xla_attention(qj, kj, vj, dh**-0.5), np.float32)
    assert got.dtype == torch.bfloat16
    tol = 2.0**-8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    assert not torch.equal(got, default)  # the branch is taken
    monkeypatch.setenv("TWEEDIEMIX_BF16_SCORES_MAX_SK", str(sk - 1))
    assert torch.equal(port_attn.attention(qb, kb, vb), default)
    monkeypatch.delenv("TWEEDIEMIX_BF16_SCORES_MAX_SK")
    assert torch.equal(port_attn.attention(qb, kb, vb), default)
    # fp32 inputs never take the bf16 branch
    monkeypatch.setenv("TWEEDIEMIX_BF16_SCORES_MAX_SK", "128")
    qf = torch.from_numpy(q)
    _close(port_attn.attention(qf, torch.from_numpy(k), torch.from_numpy(v)),
           jax_attn._xla_attention(q, k, v, dh**-0.5))
