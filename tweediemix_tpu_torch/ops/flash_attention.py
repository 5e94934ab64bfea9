"""Non-causal flash attention: two hand-written Hopper kernels (bf16, and
the int8 core of the W8A8 serving path) and their plain PyTorch versions.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``tweediemix_tpu/ops/flash_attention.py::_flash_kernel``. It computes
softmax(q·kᵀ·scale)·v over ``[BH, S, dh]`` with an online softmax over key
tiles: a Hopper kernel (TMA loads into an mbarrier ring, both products on
``wgmma`` with bf16 operands, a producer warpgroup and two consumer
warpgroups taking turns), fp32 running max, denominator and accumulator,
the scale folded into the fp32 scores, keys past ``Sk`` masked inside the
kernel and the denominator floored at 1e-30. At the main path's shapes it
is bounded by tensor-core operations, not bytes, and at dh 64 the
softmax's exp2 is a bound as high; the source's header says what its
design does about that.
The kernel's C entry point encodes three tensor maps per launch;
``chip_smoke.py`` times the wrapper's host cost per call. The v5e
devices of the TPU version (ones-column denominator, ``head_block``, block
table, VMEM guard, bf16 rounding of the pre-scaled q) stay behind.

``flash_attention`` launches the kernel for CUDA tensors and raises when it
cannot; it takes the plain version only for tensors on the CPU. The int8
core (``flash_attention_int8``, ``csrc/flash_attention_int8.cu``) is
described below, beside its functions.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tweediemix_tpu_torch.ops.cuda_build import check_launch, counts_launches, load_library

HEAD_DIMS = (64, 128, 256)
NEG_INF = -1e30  # the TPU kernels' mask value


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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None,
    int8_qkpv: bool = False,
) -> torch.Tensor:
    """Non-causal attention over q [BH, Sq, dh], k/v [BH, Sk, dh].

    On a CUDA tensor this launches the Hopper kernel (bf16, contiguous,
    dh in {64, 128, 256}) or raises; ``flash_attention.launches`` counts
    those launches. On a CPU tensor it returns the plain version.
    ``int8_qkpv`` takes the int8 attention core instead
    (``flash_attention_int8``). Returns [BH, Sq, dh] in q's dtype."""
    if int8_qkpv:
        return flash_attention_int8(q, k, v, scale)
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    return _launch_cuda(q, k, v, float(scale))


counts_launches(flash_attention, "flash_fwd_kernel")


# -- the int8 attention core (W8A8 serving) -----------------------------------
#
# The kernel (csrc/flash_attention_int8.cu) replaces the Pallas TPU kernel
# tweediemix_tpu/ops/flash_attention.py::_flash_kernel_int8, and its two
# quantise passes replace that wrapper's quantise. q is pre-scaled by
# scale·log2(e) and rounded back to q's dtype, then q, k and v are quantised
# to int8 with per-tensor abs-max scales; the kernel runs both products in
# int32 and requantises the probabilities as p8 = round(127·p) against the
# running max of its key tiles. 8-bit wgmma takes V transposed, so the
# quantise pass writes V^T with the keys of each 32-key step permuted
# (``pack_v_int8``).

# keys per tile of the int8 kernel, by head dim: p8 depends on it, so the
# plain version takes the same block_k on the CPU (the kernel library's
# tm_int8_block_k gives the same numbers)
INT8_BLOCK_K = {64: 128, 128: 64, 256: 32}


def quantize_qkv_int8(q, k, v, scale: float | None = None):
    """The int8 core's inputs: (q8, k8, v8, scales) with q8/k8/v8 int8 and
    scales fp32 [2] = (score_scale = q_s·k_s, out_scale = 127·v_s)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q = (q.float() * (scale * math.log2(math.e))).to(q.dtype)

    def quantize(x):
        xf = x.float()
        s = torch.clamp_min(xf.abs().amax(), 1e-12) / 127.0
        return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s

    (q8, q_s), (k8, k_s), (v8, v_s) = quantize(q), quantize(k), quantize(v)
    return q8, k8, v8, torch.stack([q_s * k_s, 127.0 * v_s])


def permuted_key(kp: int) -> int:
    """The key (within its 32-key step) at position ``kp`` of that step of
    V^T: position 4t+i holds key 2t + (i&1) + 8(i>>1), +16 in the upper half,
    which is where the s32 score layout leaves the thread's p8 values."""
    r = kp & 15
    i = r & 3
    return (kp & 16) + 2 * (r >> 2) + (i & 1) + 8 * (i >> 1)


_KEY_ORDER = [permuted_key(kp) for kp in range(32)]


def pack_v_int8(v8: torch.Tensor, block: int) -> torch.Tensor:
    """Plain version of V^T as the int8 kernel reads it: v8 [BH, Sk, dh] to
    [BH, dh, Skp], the keys padded with zeros to Skp, a multiple of
    ``block`` (a multiple of 32), and permuted within each 32-key step."""
    if block % 32:
        raise ValueError(f"block must be a multiple of 32, got {block}")
    bh, sk, dh = v8.shape
    skp = -(-sk // block) * block
    padded = torch.zeros((bh, skp, dh), dtype=v8.dtype, device=v8.device)
    padded[:, :sk] = v8
    pos = torch.arange(skp, device=v8.device)
    order = torch.tensor(_KEY_ORDER, device=v8.device)
    return padded[:, (pos & ~31) + order[pos & 31]].transpose(1, 2).contiguous()


def flash_attention_int8_core_reference(q8, k8, v8, scales, block_k: int | None = None,
                                        out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the int8 core on natural v8 [BH, Sk, dh]: the
    kernel's blocked online softmax over key blocks of ``block_k`` (default
    the kernel's, ``INT8_BLOCK_K[dh]``; a dh the kernel does not take needs
    an explicit block_k), p8 quantised against the running max.

    The int8 products are taken in fp32, which is exact here: every partial
    sum is an integer below 127²·max(dh, block_k) ≤ 127²·1024 < 2^24."""
    sq, dh = q8.shape[1], q8.shape[2]
    sk = k8.shape[1]
    if block_k is None:
        _check_int8_head_dim(dh)
        block_k = INT8_BLOCK_K[dh]
    score_scale, out_scale = scales[0], scales[1]
    count_column = dh % 128 != 0  # the TPU kernel's 127 column of v
    qf = q8.float()
    m = torch.full((q8.shape[0], sq, 1), NEG_INF, device=q8.device)
    den = torch.zeros_like(m)
    acc = torch.zeros(q8.shape, device=q8.device)
    for n0 in range(0, sk, block_k):
        s = torch.bmm(qf, k8[:, n0 : n0 + block_k].float().transpose(1, 2)) * score_scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        m = m_new
        p8 = torch.round(p * 127.0)
        if count_column:
            den = den * corr + p8.sum(dim=-1, keepdim=True) * 127.0
        else:
            den = den * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.bmm(p8, v8[:, n0 : n0 + block_k].float())
    if count_column:
        out = acc / torch.clamp_min(den, 1.0) * out_scale
    else:
        out = acc / torch.clamp_min(den, 1e-30) * (out_scale / (127.0 * 127.0))
    return out.to(out_dtype)


def flash_attention_int8_reference(q, k, v, scale: float | None = None,
                                   block_k: int | None = None) -> torch.Tensor:
    """Plain version of the int8 attention: quantise, then the blocked core.
    Output in q's dtype."""
    _check(q, k, v)
    q8, k8, v8, scales = quantize_qkv_int8(q, k, v, scale)
    return flash_attention_int8_core_reference(q8, k8, v8, scales, block_k, q.dtype)


def bind_int8(lib):
    """The typed C entry points of a built int8 kernel library: (attention,
    quantise)."""
    attend = lib.tm_flash_attention_int8
    attend.restype = ctypes.c_int
    attend.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    quantize = lib.tm_quantize_qkv_int8
    quantize.restype = ctypes.c_int
    quantize.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                         + [ctypes.c_float, ctypes.c_void_p])
    return attend, quantize


@functools.cache
def _launcher_int8():
    lib = load_library("flash_attention_int8")
    return lib, bind_int8(lib)


def _check_int8_head_dim(dh: int) -> None:
    if dh not in HEAD_DIMS:
        raise ValueError(f"int8 flash kernel takes dh in {HEAD_DIMS}, got {dh}")


def quantize_qkv_int8_fused(q, k, v, scale: float | None = None):
    """The int8 core's inputs from bf16 CUDA q/k/v [BH, S, dh] in two
    hand-written passes (abs-max, then quantise): (q8, k8, vt8, scales), vt8
    = ``pack_v_int8(v8, INT8_BLOCK_K[dh])``, each bitwise equal to
    ``quantize_qkv_int8`` and ``pack_v_int8`` on the card.
    ``quantize_qkv_int8_fused.launches`` counts the calls that launch them."""
    bh, sq, dh = q.shape
    sk = k.shape[1]
    _check_int8_head_dim(dh)
    if scale is None:
        scale = dh ** -0.5
    lib, (_, fn) = _launcher_int8()
    skp = -(-sk // INT8_BLOCK_K[dh]) * INT8_BLOCK_K[dh]
    q8 = torch.empty(q.shape, dtype=torch.int8, device=q.device)
    k8 = torch.empty(k.shape, dtype=torch.int8, device=q.device)
    vt8 = torch.empty((bh, dh, skp), dtype=torch.int8, device=q.device)
    ws = torch.empty(5, dtype=torch.float32, device=q.device)  # abs-max scratch, scales
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q8.data_ptr(), k8.data_ptr(),
                 vt8.data_ptr(), ws.data_ptr(), bh, sq, sk, dh,
                 scale * math.log2(math.e), stream)
    check_launch(lib, err, "quantize_qkv_int8_fused")
    quantize_qkv_int8_fused.launches += 1
    return q8, k8, vt8, ws[3:]


counts_launches(quantize_qkv_int8_fused, "quantize_kernel")


def flash_attention_int8_core(q8, k8, vt8, scales) -> torch.Tensor:
    """Launch the int8 kernel on quantised CUDA inputs, q8 [BH, Sq, dh], k8
    [BH, Sk, dh] and vt8 = ``pack_v_int8(v8, INT8_BLOCK_K[dh])``; returns
    bf16 [BH, Sq, dh]. ``flash_attention_int8.launches`` counts the
    launches."""
    bh, sq, dh = q8.shape
    sk = k8.shape[1]
    _check_int8_head_dim(dh)
    if bh > 65535:
        raise ValueError(f"int8 flash kernel takes BH <= 65535, got {bh}")
    skp = -(-sk // INT8_BLOCK_K[dh]) * INT8_BLOCK_K[dh]
    if k8.shape != (bh, sk, dh) or vt8.shape != (bh, dh, skp):
        raise ValueError(f"int8 flash kernel needs k8 {(bh, sk, dh)} and vt8 {(bh, dh, skp)}, "
                         f"got {tuple(k8.shape)}, {tuple(vt8.shape)}")
    for name, t in (("q8", q8), ("k8", k8), ("vt8", vt8)):
        if t.dtype != torch.int8 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8 flash kernel needs contiguous, 16-byte aligned int8 {name}")
    if scales.dtype != torch.float32 or scales.numel() != 2 or not scales.is_contiguous():
        raise ValueError("int8 flash kernel needs fp32 scales [2]")
    lib, (fn, _) = _launcher_int8()
    out = torch.empty(q8.shape, dtype=torch.bfloat16, device=q8.device)
    with torch.cuda.device(q8.device):
        stream = torch.cuda.current_stream(q8.device).cuda_stream
        err = fn(q8.data_ptr(), k8.data_ptr(), vt8.data_ptr(), scales.data_ptr(),
                 out.data_ptr(), bh, sq, sk, dh, stream)
    check_launch(lib, err, "flash_attention_int8")
    flash_attention_int8.launches += 1
    return out


def flash_attention_int8(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Int8 attention core (the JAX package's ``int8_qkpv``) over q [BH, Sq,
    dh], k/v [BH, Sk, dh].

    On CUDA tensors (bf16, contiguous, dh in {64, 128, 256}) it runs the two
    quantise passes and the Hopper int8 kernel, three launches, or raises;
    on CPU tensors it returns the plain version with the kernel's block_k.
    Returns [BH, Sq, dh] in q's dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_int8_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_int8 runs on cuda or cpu tensors, got {q.device}")
    _check_int8_head_dim(q.shape[-1])
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"int8 flash kernel takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8 flash kernel needs contiguous, 16-byte aligned {name}")
    return flash_attention_int8_core(*quantize_qkv_int8_fused(q, k, v, scale))


counts_launches(flash_attention_int8, "flash_int8_wgmma_kernel")
