"""Frame-axis (short-sequence) self-attention: a hand-written Hopper kernel
and its plain PyTorch version.

The video UNet's temporal transformers attend over the S = 16 frames of
every pixel row: [N, S, H·dh] projections with N = batch·h·w pixel rows. The
kernel (``csrc/short_attention.cu``) replaces the Pallas TPU kernel
``tweediemix_tpu/ops/short_attention.py::_short_kernel``: per-head softmax
attention within each row's S-band, fp32 scores, row max in the log2
domain, denominator floored at 1e-30, output in the merged [N, S, H·dh]
layout. It reads q, k and v through their row strides (the self-attention's
q/k/v are ``chunk(3)`` views of the merged ``to_qkv`` output) and is bounded
by bytes; the source's header says how. The TPU devices (128/S bands packed
into a 128-row MXU tile with a block-diagonal mask, the head-major
``[H, N·S, dh]`` relayout, the ones-column denominator, a bf16-rounded
pre-scaled q) stay behind.

``short_seq_attention`` launches the kernel for CUDA tensors and raises when
it cannot; it takes the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tweediemix_tpu_torch.ops.cuda_build import check_launch, load_library

MAX_S = 32
HEAD_DIMS = (32, 64, 128)


def short_seq_attention_reference(q, k, v, num_heads: int, scale: float | None = None):
    """Plain version over [N, S, H·dh] q/k/v: the heads split as
    ``ops.attention.split_heads`` splits them, fp32 scores and softmax,
    output in q's dtype."""
    n, s, d = q.shape
    dh = d // num_heads
    if scale is None:
        scale = dh**-0.5
    qh, kh, vh = (t.float().reshape(n, s, num_heads, dh).transpose(1, 2) for t in (q, k, v))
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
    return torch.matmul(p, vh).transpose(1, 2).reshape(n, s, d).to(q.dtype)


def _check(q, k, v, num_heads: int) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected q, k, v of one [N, S, H*dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] < 1 or q.shape[1] < 1 or num_heads < 1 or q.shape[2] % num_heads:
        raise ValueError(f"shape {tuple(q.shape)} does not split into {num_heads} heads")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")


def bind(lib):
    """The typed C entry point of a built short-attention library."""
    fn = lib.tm_short_attention_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


@functools.cache
def _launcher():
    """The built library and its typed C entry point (built on first call)."""
    lib = load_library("short_attention")
    return lib, bind(lib)


def _launch_cuda(q, k, v, num_heads: int, scale: float) -> torch.Tensor:
    n, s, d = q.shape
    dh = d // num_heads
    if dh not in HEAD_DIMS:
        raise ValueError(f"short-attention kernel takes dh in {HEAD_DIMS}, got {dh}")
    if s > MAX_S:
        raise ValueError(f"short-attention kernel takes S <= {MAX_S}, got {s}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"short-attention kernel takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(f"short-attention kernel needs {name} with a unit last stride, "
                             f"row strides in multiples of 8 and a 16-byte aligned start; "
                             f"got strides {t.stride()}")
    lib, fn = _launcher()
    out = torch.empty((n, s, d), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                 n, s, num_heads, dh, scale * math.log2(math.e), stream)
    check_launch(lib, err, "short_attention")
    short_seq_attention.launches += 1
    return out


def short_seq_attention(q, k, v, num_heads: int, scale: float | None = None) -> torch.Tensor:
    """Multi-head self-attention within each row's S-band of [N, S, H·dh]
    q/k/v (S is the frame axis).

    On a CUDA tensor this launches the Hopper kernel (bf16, S <= 32, dh in
    {32, 64, 128}, unit last stride) or raises; ``short_seq_attention.launches``
    counts those launches. On a CPU tensor it returns the plain version.
    Returns [N, S, H·dh] in q's dtype."""
    _check(q, k, v, num_heads)
    if scale is None:
        scale = (q.shape[-1] // num_heads) ** -0.5
    if q.device.type == "cpu":
        return short_seq_attention_reference(q, k, v, num_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"short_seq_attention runs on cuda or cpu tensors, got {q.device}")
    return _launch_cuda(q, k, v, num_heads, float(scale))


short_seq_attention.launches = 0
