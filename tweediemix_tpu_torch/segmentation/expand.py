"""Mask expansion over an injected predictor (counterpart of
``tweediemix_tpu/segmentation/expand.py``).

For each concept in order: predict its mask, expand it to its filled
bounding rectangle, then black out the mask's pixels before the next
concept is predicted. For two concepts, the rectangles' overlap is resolved
(``fusion/masks.py::resolve_overlap_pair``).
"""

from __future__ import annotations

from typing import Callable, List

import torch

from tweediemix_tpu_torch.fusion.masks import rect_expand, resolve_overlap_pair, sequential_blackout

# predict_fn(image [H, W, 3] float in [0, 1], text) → mask [H, W] float {0, 1}
PredictFn = Callable[[torch.Tensor, str], torch.Tensor]


def expand_masks(predict_fn: PredictFn, image: torch.Tensor, concepts: List[str]) -> torch.Tensor:
    """[N_concepts, H, W] rectangle-expanded, overlap-resolved masks."""
    rects, origs = [], []
    img = image
    for concept in concepts:
        mask = predict_fn(img, concept)
        origs.append(mask)
        rects.append(rect_expand(mask))
        img = sequential_blackout(img, mask)
    if len(rects) == 2:
        rects = list(resolve_overlap_pair(rects[0], rects[1], origs[0], origs[1]))
    return torch.stack(rects)
