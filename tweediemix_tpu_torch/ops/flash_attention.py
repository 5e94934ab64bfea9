"""Non-causal flash attention: a hand-written Hopper kernel and its plain
PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``tweediemix_tpu/ops/flash_attention.py::_flash_kernel``. It computes
softmax(q·kᵀ·scale)·v over ``[BH, S, dh]`` with an online softmax over key
tiles: bf16 operands on the tensor cores (``mma.sync``), fp32 running max,
denominator and accumulator, the scale folded into the fp32 scores, keys
past ``Sk`` masked inside the kernel and the denominator floored at 1e-30.
At the main path's shapes it is bounded by tensor-core operations, not
bytes; the source's header says what its design does about that. The v5e
devices of the TPU version (ones-column denominator, ``head_block``, block
table, VMEM guard, bf16 rounding of the pre-scaled q) stay behind.

``flash_attention`` launches the kernel for CUDA tensors and raises when it
cannot; it takes the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tweediemix_tpu_torch.ops.cuda_build import check_launch, load_library

HEAD_DIMS = (64, 128, 256)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Plain version: fp32 scores and softmax, output in q's dtype.

    Nothing is padded here, so the kernel's key-length mask has nothing to
    cover: every one of the ``Sk`` keys is real."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.bmm(q.float(), k.float().transpose(1, 2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.bmm(p, v.float()).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"expected [BH, S, dh] tensors, got {q.shape}, {k.shape}, {v.shape}")
    bh, _, dh = q.shape
    if k.shape[0] != bh or k.shape[2] != dh or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[1] < 1 or q.shape[1] < 1:
        raise ValueError("empty sequence")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")


@functools.cache
def _launcher():
    """The built library and its typed C entry point (built on first call)."""
    lib = load_library("flash_attention")
    fn = lib.tm_flash_attention_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    return lib, fn


def _launch_cuda(q, k, v, scale: float) -> torch.Tensor:
    bh, sq, dh = q.shape
    sk = k.shape[1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes dh in {HEAD_DIMS}, got {dh}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash kernel takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash kernel needs contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs 16-byte aligned {name}")
    if bh > 65535:
        raise ValueError(f"flash kernel takes BH <= 65535, got {bh}")
    lib, fn = _launcher()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, sq, sk, dh, scale * math.log2(math.e), stream)
    check_launch(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Non-causal attention over q [BH, Sq, dh], k/v [BH, Sk, dh].

    On a CUDA tensor this launches the Hopper kernel (bf16, contiguous,
    dh in {64, 128, 256}) or raises; ``flash_attention.launches`` counts
    those launches. On a CPU tensor it returns the plain version.
    Returns [BH, Sq, dh] in q's dtype."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    return _launch_cuda(q, k, v, float(scale))


flash_attention.launches = 0
