"""Region-mask construction (counterpart of the mask-building part of
``tweediemix_tpu/fusion/masks.py``; rectangle expansion and overlap
resolution belong to the segmentation slice)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def binarize_and_resize_mask(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Binarise a [H, W] mask at 0.5, then nearest-resize it to (h, w).

    ``jax.image.resize(method="nearest")`` samples at half-pixel centres
    (16 → 2 picks source pixels 4 and 12), which is torch's
    ``"nearest-exact"``; torch's ``"nearest"`` would pick 0 and 8."""
    binary = (mask >= 0.5).float()
    return F.interpolate(binary[None, None], size=(h, w), mode="nearest-exact")[0, 0]


def background_mask(fg_masks: torch.Tensor) -> torch.Tensor:
    """bg = clamp(1 - sum(fg), min 0)."""
    return torch.clamp(1.0 - fg_masks.sum(dim=0), min=0.0)


def build_region_masks(fg_masks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[N_fg, H, W] raw foreground masks → [N_fg+1, h, w] latent-resolution
    masks, background last."""
    resized = torch.stack([binarize_and_resize_mask(m, h, w) for m in fg_masks])
    return torch.cat([resized, background_mask(resized)[None]], dim=0)
