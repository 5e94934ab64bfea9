"""The yardstick's arithmetic: the H100's published peaks, each kernel
launch's least time from its shape, which attentions of a UNet call reach
which kernel (the configuration's site arithmetic), and a request's model
work counted over the plain reference on the ``meta`` device.

Peaks (NVIDIA H100 SXM data sheet, dense, at its 700 W limit): 989 TFLOP/s
bf16, 1979 TOP/s int8, 67 TFLOP/s fp32 outside the tensor cores (the
reference precision's decode runs with TF32 off), 3.35 TB/s of HBM.
A launch's bound is the larger of its operations at the peak of its
precision and its bytes at the HBM rate, each input read once and each
output written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12

FLASH_HEAD_DIMS = (64, 128, 256)
FLASH_MIN_TOKENS = 1024
SHORT_HEAD_DIMS = (32, 64, 128)
SHORT_MAX_FRAMES = 32

Shape = Tuple[int, int, int, int]  # (BH or N·H, Sq, Sk, dh)


def flash_bound_s(bh: int, sq: int, sk: int, dh: int) -> float:
    """bf16 flash attention: 4 BH Sq Sk dh operations at the bf16 peak, or
    q, k, v read and o written in bf16."""
    ops = 4.0 * bh * sq * sk * dh
    byt = 2.0 * bh * dh * (2 * sq + 2 * sk)
    return max(ops / PEAK_BF16, byt / HBM_BYTES_PER_S)


def flash_int8_bound_s(bh: int, sq: int, sk: int, dh: int) -> float:
    """The int8 core with its two quantise passes: both products at the
    int8 peak, or the bf16 q, k, v read once and the bf16 output written."""
    ops = 4.0 * bh * sq * sk * dh
    byt = 2.0 * bh * dh * (2 * sq + 2 * sk)
    return max(ops / PEAK_INT8, byt / HBM_BYTES_PER_S)


def short_bound_s(n: int, s: int, heads: int, dh: int) -> float:
    """Frame-axis attention over [N, S, H·dh]: bytes of q, k, v and o in
    bf16, or its operations at the bf16 peak."""
    ops = 4.0 * n * heads * s * s * dh
    byt = 4 * 2.0 * n * s * heads * dh
    return max(ops / PEAK_BF16, byt / HBM_BYTES_PER_S)


# -- which attentions reach which kernel --------------------------------------------


def sdxl_transformers(unet: Dict) -> List[Tuple[int, int]]:
    """(level, blocks) of every spatial transformer of the SDXL UNet, in call
    order."""
    n = len(unet["block_out_channels"])
    lpb, depth = unet["layers_per_block"], unet["transformer_layers_per_block"]
    out = [(lvl, depth[lvl]) for lvl, kind in enumerate(unet["down_block_types"])
           if kind.startswith("CrossAttn") for _ in range(lpb)]
    out.append((n - 1, depth[n - 1]))
    out += [(n - 1 - i, depth[n - 1 - i]) for i, kind in enumerate(unet["up_block_types"])
            if kind.startswith("CrossAttn") for _ in range(lpb + 1)]
    return out


def fusion_flash_shapes(unet: Dict, latent_hw, rows: int) -> Dict[Shape, int]:
    """{(BH, S, S, dh): launches} of one SDXL UNet call of ``rows`` rows: each
    self-attention of at least FLASH_MIN_TOKENS tokens with a head size the
    kernel takes (cross-attention has 77 keys and takes the math path)."""
    h, w = latent_hw
    out: Dict[Shape, int] = {}
    for lvl, blocks in sdxl_transformers(unet):
        tokens = (h >> lvl) * (w >> lvl)
        heads = unet["attention_head_dim"][lvl]
        dh = unet["block_out_channels"][lvl] // heads
        if tokens >= FLASH_MIN_TOKENS and dh in FLASH_HEAD_DIMS:
            key = (rows * heads, tokens, tokens, dh)
            out[key] = out.get(key, 0) + blocks
    return out


def video_transformer_levels(unet: Dict) -> List[int]:
    """Levels of every spatial transformer of the I2VGen-XL UNet, in call
    order (each one block, followed by a temporal transformer)."""
    n = len(unet["block_out_channels"])
    lpb = unet["layers_per_block"]
    out = [lvl for lvl, kind in enumerate(unet["down_block_types"])
           if kind.startswith("CrossAttn") for _ in range(lpb)]
    out.append(n - 1)
    ups = list(reversed(unet["down_block_types"]))
    out += [n - 1 - i for i, kind in enumerate(ups) if kind.startswith("CrossAttn")
            for _ in range(lpb + 1)]
    return out


def video_kernel_shapes(unet: Dict, latent_hw, rows: int, frames: int):
    """({(BH, S, S, dh): launches} of the flash kernel, {(N, S, H, dh):
    launches} of the short kernel) of one I2VGen-XL UNet call of ``rows``
    rows of ``frames`` frames: the spatial self-attentions of at least
    FLASH_MIN_TOKENS tokens, and every frame-axis self-attention (two per
    temporal transformer, two in ``transformer_in`` with 8 heads)."""
    h, w = latent_hw
    hd = unet["attention_head_dim"]
    flash: Dict[Shape, int] = {}
    short: Dict[Shape, int] = {}

    def add(d, key, n=1):
        d[key] = d.get(key, 0) + n

    if frames <= SHORT_MAX_FRAMES and hd in SHORT_HEAD_DIMS:
        add(short, (rows * h * w, frames, 8, hd), 2)
    for lvl in video_transformer_levels(unet):
        hl, wl = h >> lvl, w >> lvl
        heads = max(1, unet["block_out_channels"][lvl] // hd)
        if hl * wl >= FLASH_MIN_TOKENS and hd in FLASH_HEAD_DIMS:
            add(flash, (rows * frames * heads, hl * wl, hl * wl, hd))
        if frames <= SHORT_MAX_FRAMES and hd in SHORT_HEAD_DIMS:
            add(short, (rows * hl * wl, frames, heads, hd), 2)
    return flash, short


def launches(shapes: Dict[Shape, int]) -> int:
    return sum(shapes.values())


def bound_s(shapes: Dict[Shape, int], fn) -> float:
    return sum(n * fn(*shape) for shape, n in shapes.items())


# -- a request's model work -------------------------------------------------------


def least_seconds(ops: Dict[str, float], unet_int8: bool) -> float:
    """The least time of counted work (``reference.ops.WorkCounter`` tags,
    with ``decode_`` for the fp32 VAE): UNet products at the bf16 peak, or
    the int8 peak at quantised sites and in the int8 attention core, and
    the fp32 VAE at the fp32 peak."""
    total = 0.0
    for tag, n in ops.items():
        if tag.startswith("vae_"):
            total += n / PEAK_FP32
        elif tag in ("gemm_int8", "attention_int8") and unet_int8:
            total += n / PEAK_INT8
        else:
            total += n / PEAK_BF16
    return total
