"""Plain operations of the reference models: fp32 arithmetic on weights
held in their served dtype (each weight is cast to fp32 where it is used,
so the reference holds no second copy), W8A8 as quantise -> exact integer
product -> dequantise, and a work counter that the roofline code reads.

Nothing here imports the measured program: the reference is written from
the published architectures (diffusers' SDXL, AutoencoderKL and I2VGen-XL
layouts) and from the W8A8 and int8-attention semantics that the
configuration states.

Precision. ``Precision`` says how a reference model computes: ``fp32``
(TF32 off, the reference), the W8A8 configuration's (``amax``, ``bits``
8, ``int8_attention``), or a control one step lower (``bits`` 4;
``tf32()`` for the decode). The quantised sites and their static activation abs-max come from
``Precision.amax`` ({site key: abs-max}); a site missing from it takes a
dynamic per-row scale.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

_COUNTER: contextvars.ContextVar = contextvars.ContextVar("work_counter", default=None)


class WorkCounter:
    """Multiply-add work (2 operations per multiply-add) of the products a
    reference forward runs, by tag: ``gemm``, ``gemm_int8``, ``conv``,
    ``attention``, ``attention_int8``, ``invariant`` (a product whose
    inputs do not change over a request, such as a cross-attention's
    K/V)."""

    def __init__(self):
        self.ops: Dict[str, float] = {}

    def add(self, tag: str, ops: float) -> None:
        self.ops[tag] = self.ops.get(tag, 0.0) + float(ops)


@contextlib.contextmanager
def counting():
    """Count the work of the reference forwards run inside the block."""
    counter = WorkCounter()
    token = _COUNTER.set(counter)
    try:
        yield counter
    finally:
        _COUNTER.reset(token)


def _count(tag: str, ops: float) -> None:
    counter = _COUNTER.get()
    if counter is not None:
        counter.add(tag, ops)


@dataclasses.dataclass
class Precision:
    """How a reference model computes (module docstring)."""

    amax: Optional[Dict[str, float]] = None  # quantised sites: {site: static abs-max}
    bits: int = 8
    int8_attention: bool = False  # the int8 attention core at the long self-attentions

    @property
    def quantised(self) -> bool:
        return self.amax is not None


FP32 = Precision()


def w(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def quantize_sym(x: torch.Tensor, scale: torch.Tensor, qmax: int) -> torch.Tensor:
    """round half to even, clip to +-qmax."""
    return torch.clamp(torch.round(x / scale), -qmax, qmax)


def quant_matmul(x: torch.Tensor, weight: torch.Tensor, amax: float, bits: int) -> torch.Tensor:
    """``x @ dequant(q(weight)).T`` with quantised activations: per-output-
    channel weight scales abs-max/qmax, an activation scale amax/qmax per
    tensor (amax > 0) or per row (amax = 0), the integer product exact (in
    float64, whose 53 bits hold every partial sum), dequantised in fp32."""
    qmax = 2 ** (bits - 1) - 1
    wf = weight.float()
    wscale = torch.clamp_min(wf.abs().amax(dim=1) / qmax, 1e-12)
    wq = quantize_sym(wf, wscale[:, None], qmax)
    xf = x.float()
    if amax > 0:
        xscale = torch.tensor(amax / qmax, dtype=torch.float32, device=x.device)
    else:
        xscale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / qmax, 1e-12)
    xq = quantize_sym(xf, xscale, qmax)
    acc = torch.matmul(xq.double(), wq.double().t())
    return acc.float() * xscale * wscale


class Linear(nn.Module):
    """``x @ weight.T + bias`` in fp32; at a quantised site (``site`` set,
    under a quantised precision) the W8A8 product, with the site's static
    abs-max or, where the table lacks it, dynamic per-row scales.
    ``invariant`` marks a product whose inputs do not change over a
    request."""

    def __init__(self, din: int, dout: int, bias: bool = True, site: Optional[str] = None,
                 invariant: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dout, din), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(dout), requires_grad=False) if bias else None
        self.site = site
        self.invariant = invariant
        self.precision = FP32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.precision
        rows = x.numel() // x.shape[-1]
        ops = 2.0 * rows * self.weight.shape[0] * self.weight.shape[1]
        if self.site is not None and p.quantised:
            _count("gemm_int8", ops)
            y = quant_matmul(x, self.weight, p.amax.get(self.site, 0.0), p.bits)
        else:
            _count("invariant" if self.invariant else "gemm", ops)
            y = F.linear(w(x), w(self.weight))
        return y if self.bias is None else y + w(self.bias)


class Conv(nn.Module):
    """2-D or 3-D convolution in fp32 (``dims``), weights in their served
    dtype."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0, dims: int = 2,
                 invariant: bool = False):
        super().__init__()
        kernel = (kernel,) * dims if isinstance(kernel, int) else tuple(kernel)
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(cout), requires_grad=False)
        self.stride, self.padding, self.dims = stride, padding, dims
        self.invariant = invariant
        self.precision = FP32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = F.conv2d if self.dims == 2 else F.conv3d
        y = fn(x.float(), w(self.weight), w(self.bias), self.stride, self.padding)
        taps = self.weight[0].numel()
        _count("invariant" if self.invariant else "conv", 2.0 * y.numel() * taps)
        return y


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(channels), requires_grad=False)
        self.groups, self.eps = groups, eps

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, w(self.weight), w(self.bias), self.eps)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(dim), requires_grad=False)
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), w(self.weight), w(self.bias), self.eps)


# -- attention ---------------------------------------------------------------

SCORE_BYTES = 512 * 1024 * 1024  # fp32 scores held at once
INT8_BLOCK_K = {32: 128, 64: 128, 128: 64, 256: 32}  # keys per tile of the int8 core


def softmax_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T scale) v over [BH, S, dh] in fp32, in query chunks so
    the score tensor stays under SCORE_BYTES."""
    bh, sq, dh = q.shape
    sk = k.shape[1]
    _count("attention", 4.0 * bh * sq * sk * dh)
    chunk = max(1, min(sq, SCORE_BYTES // max(1, 4 * bh * sk)))
    out = []
    q, kt, v = q.float(), k.float().transpose(1, 2), v.float()
    for q0 in range(0, sq, chunk):
        s = torch.bmm(q[:, q0:q0 + chunk], kt) * scale
        out.append(torch.bmm(torch.softmax(s, dim=-1), v))
    return torch.cat(out, dim=1)


def int8_attention(q, k, v, scale: float) -> torch.Tensor:
    """The int8 attention core of the W8A8 configuration: q pre-scaled by
    scale*log2(e) and rounded to bf16 (the served dtype of its input),
    q, k and v quantised to int8 with one abs-max scale per tensor, the
    scores an exact integer product, an online softmax in base 2 over key
    tiles of INT8_BLOCK_K[dh] keys with the probabilities requantised as
    p8 = round(127 p) against the running max, the p8 v product exact, and
    the denominator the sum of p8 (times 127) where dh is not a multiple
    of 128, else the sum of p."""
    bh, sq, dh = q.shape
    sk = k.shape[1]
    _count("attention_int8", 4.0 * bh * sq * sk * dh)
    block = INT8_BLOCK_K[dh]
    qs = (q.float() * (scale * math.log2(math.e))).to(torch.bfloat16)

    def quantize(x):
        xf = x.float()
        s = torch.clamp_min(xf.abs().amax(), 1e-12) / 127.0
        return quantize_sym(xf, s, 127), s

    (q8, q_s), (k8, k_s), (v8, v_s) = quantize(qs), quantize(k), quantize(v)
    score_scale, out_scale = q_s * k_s, 127.0 * v_s
    count_column = dh % 128 != 0
    out = []
    rows = max(1, min(sq, SCORE_BYTES // max(1, 8 * bh * block)))
    for q0 in range(0, sq, rows):
        qc = q8[:, q0:q0 + rows].double()
        m = torch.full((bh, qc.shape[1], 1), -1e30, device=q.device)
        den = torch.zeros_like(m)
        acc = torch.zeros((bh, qc.shape[1], dh), device=q.device)
        for n0 in range(0, sk, block):
            s = torch.bmm(qc, k8[:, n0:n0 + block].double().transpose(1, 2)).float() * score_scale
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp2(s - m_new)
            corr = torch.exp2(m - m_new)
            m = m_new
            p8 = torch.round(p * 127.0)
            if count_column:
                den = den * corr + p8.sum(dim=-1, keepdim=True) * 127.0
            else:
                den = den * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.bmm(p8.double(), v8[:, n0:n0 + block].double()).float()
        if count_column:
            out.append(acc / torch.clamp_min(den, 1.0) * out_scale)
        else:
            out.append(acc / torch.clamp_min(den, 1e-30) * (out_scale / (127.0 * 127.0)))
    return torch.cat(out, dim=1)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H*dh] -> [B*H, S, dh]."""
    b, s, d = x.shape
    return x.reshape(b, s, heads, d // heads).transpose(1, 2).reshape(b * heads, s, d // heads)


def merge_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    bh, s, dh = x.shape
    return x.reshape(bh // heads, heads, s, dh).transpose(1, 2).reshape(bh // heads, s, heads * dh)


INT8_ATTENTION_MIN_S = 1024  # the long self-attentions that the int8 core takes


def attention(q, k, v, heads: int, precision: Precision) -> torch.Tensor:
    """Multi-head attention over [B, S, H*dh]; under ``int8_attention`` a
    self-attention of at least INT8_ATTENTION_MIN_S tokens takes the int8
    core."""
    dh = q.shape[-1] // heads
    qh, kh, vh = (split_heads(t, heads) for t in (q, k, v))
    long_self = q.shape[1] >= INT8_ATTENTION_MIN_S and k.shape[1] >= INT8_ATTENTION_MIN_S
    if precision.int8_attention and long_self:
        out = int8_attention(qh, kh, vh, dh**-0.5)
    else:
        out = softmax_attention(qh, kh, vh, dh**-0.5)
    return merge_heads(out, heads)


def set_precision(module: nn.Module, precision: Precision) -> None:
    """Give every part of ``module`` that reads a precision this one."""
    for m in module.modules():
        if hasattr(m, "precision"):
            m.precision = precision


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for fp32 matmuls and convolutions inside the block (a control's
    precision); off otherwise."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """diffusers' sinusoidal embedding with flip_sin_to_cos and shift 0:
    [cos, sin] of t * exp(-log(max_period) * i / half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class MLP2(nn.Module):
    """linear_1 -> SiLU -> linear_2 (diffusers' TimestepEmbedding)."""

    def __init__(self, din: int, dhidden: int, dout: int):
        super().__init__()
        self.linear_1 = Linear(din, dhidden)
        self.linear_2 = Linear(dhidden, dout)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))
