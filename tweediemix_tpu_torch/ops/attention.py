"""Attention dispatch: the flash kernel for long self-attention, an
fp32-softmax math path elsewhere.

Counterpart of ``tweediemix_tpu/ops/attention.py``. The flash sites are the
ones the JAX package dispatches: sq >= ``TWEEDIEMIX_FLASH_MIN_S`` (default
1024), sk >= min(1024, that threshold) and dh in {64, 128, 256} (the SDXL
self-attention at the 4096- and 1024-token levels). ``TWEEDIEMIX_ATTENTION``
overrides the gate: ``xla`` sends every site to the math path, ``flash``
every site whose sk passes the threshold above, whatever sq is (a dh the
kernel does not take then raises), ``auto`` (the default) keeps the gate.
On CUDA tensors the flash sites go to the Hopper kernel, on CPU tensors to
its plain version. ``TWEEDIEMIX_FLASH_INT8=1`` sends them to the int8 core
instead (its kernel on CUDA, its plain version on the CPU).
``TWEEDIEMIX_SHORT_ATTENTION=1`` sends short self-attention (the video
UNet's frame axis: q and k of one shape, S <= 32, dh in {32, 64, 128}) to
the short-sequence kernel, or to its plain version on the CPU; it stays
opt-in, as in the JAX package. ``TWEEDIEMIX_BF16_SCORES_MAX_SK=<n>``
(default 0, off) gives bf16 math-path calls with 0 < sk <= n bf16 scores
and a bf16 softmax, as ``_xla_attention`` does. Every knob is read on every
call, as the JAX package reads them.
Where an input requires a gradient (training), a flash site runs through
``FlashAttention``, an autograd function whose forward is the same kernel
call and whose backward recomputes the math path's vjp in chunks of BH rows,
as the JAX package's ``custom_vjp`` does; inference calls the kernel
directly. Cross-attention (77 keys) and every other site take the math path, which
switches to query chunks when the fp32 score tensor would pass 256 MiB. Head
split/merge happens here, so model code only sees [B, S, D].
"""

from __future__ import annotations

import os

import torch

from tweediemix_tpu_torch.ops import short_attention
from tweediemix_tpu_torch.ops.flash_attention import HEAD_DIMS, flash_attention

FLASH_MIN_SQ = 1024
FLASH_MIN_SK = 1024
# cap on the materialised [BH, Sq, Sk] fp32 score tensor of the math path
SCORE_BYTES_CAP = 256 * 1024 * 1024
ATTENTION_MODES = ("auto", "flash", "xla")  # TWEEDIEMIX_ATTENTION
# every environment knob this module reads on a call
KNOBS = ("TWEEDIEMIX_ATTENTION", "TWEEDIEMIX_FLASH_MIN_S", "TWEEDIEMIX_FLASH_INT8",
         "TWEEDIEMIX_SHORT_ATTENTION", "TWEEDIEMIX_BF16_SCORES_MAX_SK")


def dispatch_key() -> tuple:
    """The values of ``KNOBS`` now. A recorded call (a CUDA graph) keeps the
    kernels they chose at its recording, so it is keyed on them."""
    return tuple(os.environ.get(k) for k in KNOBS)


def flash_min_s() -> int:
    """``TWEEDIEMIX_FLASH_MIN_S``: the least sq of a flash site."""
    return int(os.environ.get("TWEEDIEMIX_FLASH_MIN_S", FLASH_MIN_SQ))


def bf16_scores_max_sk() -> int:
    """``TWEEDIEMIX_BF16_SCORES_MAX_SK``: the largest sk whose bf16 math-path
    calls take bf16 scores (0, the default off a TPU, turns it off)."""
    return int(os.environ.get("TWEEDIEMIX_BF16_SCORES_MAX_SK", "0"))


def uses_flash(sq: int, sk: int, dh: int) -> bool:
    """Whether ``attention`` sends a [*, sq, dh] x [*, sk, dh] call to the
    flash kernel, under ``TWEEDIEMIX_ATTENTION`` and
    ``TWEEDIEMIX_FLASH_MIN_S``. Raises where ``flash`` forces a site whose
    dh the kernel does not take."""
    mode = os.environ.get("TWEEDIEMIX_ATTENTION", "auto")
    if mode not in ATTENTION_MODES:
        raise ValueError(f"TWEEDIEMIX_ATTENTION={mode!r}; use one of {ATTENTION_MODES}")
    min_s = flash_min_s()
    if mode == "xla" or sk < min(FLASH_MIN_SK, min_s):
        return False
    if mode == "flash":
        if dh not in HEAD_DIMS:
            raise ValueError(f"TWEEDIEMIX_ATTENTION=flash: the flash kernel takes dh in "
                             f"{HEAD_DIMS}, this site has dh {dh}")
        return True
    return sq >= min_s and dh in HEAD_DIMS


def uses_short(q_shape, k_shape, num_heads: int) -> bool:
    """Whether ``multi_head_attention`` sends [N, S, H·dh] q/k of these
    shapes to the short-sequence kernel (the JAX package's gate, knob read
    on every call)."""
    return (os.environ.get("TWEEDIEMIX_SHORT_ATTENTION", "0") == "1"
            and tuple(q_shape) == tuple(k_shape)
            and q_shape[1] <= short_attention.MAX_S
            and q_shape[-1] // num_heads in short_attention.HEAD_DIMS)


def math_attention(q, k, v, scale: float) -> torch.Tensor:
    """fp32 scores and softmax; p is cast to v's dtype for the p·v product
    (``_xla_attention``). bf16 inputs with 0 < sk <= ``bf16_scores_max_sk()``
    take its bf16 branch: the fp32 scores rounded to bf16 and the softmax in
    bf16 (max, exp, sum and quotient each rounded to bf16)."""
    s = torch.bmm(q.float(), k.float().transpose(1, 2)) * scale
    if q.dtype == torch.bfloat16 and 0 < k.shape[1] <= bf16_scores_max_sk():
        s = s.to(torch.bfloat16)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
    else:
        p = torch.softmax(s, dim=-1)
    return torch.bmm(p.to(v.dtype), v).to(q.dtype)


def chunked_attention(q, k, v, scale: float, chunk: int) -> torch.Tensor:
    """Query-chunked math path: peak memory ~ BH * chunk * Sk * 4 bytes."""
    return torch.cat(
        [math_attention(qc, k, v, scale) for qc in torch.split(q, chunk, dim=1)], dim=1
    )


class FlashAttention(torch.autograd.Function):
    """The flash kernel with a math backward (``_flash``/``_flash_bwd`` of
    ``tweediemix_tpu/ops/attention.py``): the forward is ``flash_attention``
    (the bf16 kernel, or the int8 core under ``int8_qkpv``, whose float
    backward is then a straight-through estimate); the backward recomputes
    ``math_attention``'s vjp over chunks of BH rows, so the fp32 score
    tensor of one chunk stays under ``SCORE_BYTES_CAP``. No backward kernel
    is written: the JAX package's backward is plain XLA too."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, int8_qkpv: bool):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return flash_attention(q, k, v, scale, int8_qkpv=int8_qkpv)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        bh, sq, _ = q.shape
        rows = max(1, SCORE_BYTES_CAP // (4 * sq * k.shape[1]))
        grads = ([], [], [])
        for start in range(0, bh, rows):
            part = slice(start, start + rows)
            with torch.enable_grad():
                qc, kc, vc = (t[part].detach().requires_grad_() for t in (q, k, v))
                out = math_attention(qc, kc, vc, ctx.scale)
            for acc, d in zip(grads, torch.autograd.grad(out, (qc, kc, vc), g[part])):
                acc.append(d)
        return tuple(torch.cat(d) for d in grads) + (None, None)


def attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Scaled dot-product attention over [BH, S, dh] tensors. A flash site
    whose inputs require a gradient goes through ``FlashAttention``."""
    bh, sq, dh = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = dh**-0.5
    if uses_flash(sq, sk, dh):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        int8_qkpv = os.environ.get("TWEEDIEMIX_FLASH_INT8", "0") == "1"
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return FlashAttention.apply(q, k, v, scale, int8_qkpv)
        return flash_attention(q, k, v, scale, int8_qkpv=int8_qkpv)
    score_bytes = 4 * bh * sq * sk
    if score_bytes > SCORE_BYTES_CAP:
        chunk = min(max(1, SCORE_BYTES_CAP // (4 * bh * sk)), sq)
        return chunked_attention(q, k, v, scale, chunk)
    return math_attention(q, k, v, scale)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*dh] → [B*H, S, dh]."""
    b, s, d = x.shape
    dh = d // num_heads
    return x.reshape(b, s, num_heads, dh).transpose(1, 2).reshape(b * num_heads, s, dh)


def merge_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B*H, S, dh] → [B, S, H*dh]."""
    bh, s, dh = x.shape
    b = bh // num_heads
    return x.reshape(b, num_heads, s, dh).transpose(1, 2).reshape(b, s, num_heads * dh)


def multi_head_attention(q, k, v, num_heads: int, scale: float | None = None) -> torch.Tensor:
    """Multi-head attention over [B, S, D] projections (pre-head-split)."""
    if scale is None:
        scale = (q.shape[-1] // num_heads) ** -0.5
    if uses_short(q.shape, k.shape, num_heads):
        return short_attention.short_seq_attention(q, k, v, num_heads, scale)
    out = attention(
        split_heads(q, num_heads), split_heads(k, num_heads), split_heads(v, num_heads),
        scale=scale,
    )
    return merge_heads(out, num_heads)
