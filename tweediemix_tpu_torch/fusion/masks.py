"""Region-mask construction and post-processing (counterpart of
``tweediemix_tpu/fusion/masks.py``).

The fusion sampler binarises each foreground mask at 0.5, nearest-resizes
it to latent resolution and adds the background (clamp(1 - sum(fg), 0))
last. The segmentation stage expands each concept's mask to its filled
bounding rectangle, blacks out the claimed pixels before the next concept
and, for two concepts, resolves the rectangles' overlap (inside the
overlap's bounding box each concept keeps only its true mask pixels; if
more than 80% of concept 0's mask lies in the overlap, concept 1's claim
there is dropped). Every function works on tensors of any device and
keeps their shapes static; an empty mask stays empty.
"""

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


def _bbox(mask: torch.Tensor):
    """(min_y, max_y, min_x, max_x, any_nonzero) of a [H, W] mask's > 0
    pixels, as 0-d tensors; an empty mask gives an inverted box and
    ``any = False``, so callers gate on ``any``."""
    h, w = mask.shape
    nz = mask > 0
    rows, cols = nz.any(dim=1), nz.any(dim=0)
    ridx = torch.arange(h, device=mask.device)
    cidx = torch.arange(w, device=mask.device)
    big = h + w
    min_y = torch.where(rows, ridx, big).min()
    max_y = torch.where(rows, ridx, -1).max()
    min_x = torch.where(cols, cidx, big).min()
    max_x = torch.where(cols, cidx, -1).max()
    return min_y, max_y, min_x, max_x, nz.any()


def _box_region(h: int, w: int, min_y, max_y, min_x, max_x, device=None) -> torch.Tensor:
    """Boolean [h, w] mask of the inclusive box."""
    ridx = torch.arange(h, device=device)[:, None]
    cidx = torch.arange(w, device=device)[None, :]
    return (ridx >= min_y) & (ridx <= max_y) & (cidx >= min_x) & (cidx <= max_x)


def rect_expand(mask: torch.Tensor) -> torch.Tensor:
    """A [H, W] mask → its filled bounding rectangle (empty stays empty)."""
    h, w = mask.shape
    min_y, max_y, min_x, max_x, has = _bbox(mask)
    rect = _box_region(h, w, min_y, max_y, min_x, max_x, mask.device).to(mask.dtype)
    return torch.where(has, rect, torch.zeros_like(rect))


def sequential_blackout(image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero the pixels of ``image`` [H, W, C] that ``mask`` [H, W] claims,
    before the next concept is segmented."""
    return torch.where((mask > 0)[..., None], torch.zeros_like(image), image)


def resolve_overlap_pair(rect0: torch.Tensor, rect1: torch.Tensor, orig0: torch.Tensor,
                         orig1: torch.Tensor, containment_thr: float = 0.8):
    """Two concepts' rectangles and true masks → the adjusted (rect0,
    rect1): inside the bounding box of ``rect0 & rect1`` each keeps only its
    true mask pixels there, and if more than ``containment_thr`` of
    ``orig0`` lies in the overlap, concept 1's claim there is zeroed."""
    h, w = rect0.shape
    overlap = ((rect0 > 0) & (rect1 > 0)).to(rect0.dtype)
    min_y, max_y, min_x, max_x, has = _bbox(overlap)
    box = _box_region(h, w, min_y, max_y, min_x, max_x, rect0.device)
    ov0 = overlap * orig0
    ov1 = overlap * orig1
    contained = ov0.sum() / torch.clamp(orig0.sum(), min=1e-6)
    ov1 = torch.where(contained > containment_thr, torch.zeros_like(ov1), ov1)
    out0 = torch.where(has, torch.where(box, ov0, rect0), rect0)
    out1 = torch.where(has, torch.where(box, ov1, rect1), rect1)
    return out0, out1
