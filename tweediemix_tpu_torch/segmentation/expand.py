"""Mask expansion over an injected predictor (counterpart of
``tweediemix_tpu/segmentation/expand.py``).

For each concept in order: predict its mask, then black out the mask's
pixels before the next concept is predicted (``predict_in_turn``). Then
each mask is expanded to its filled bounding rectangle and, for two
concepts, the rectangles' overlap is resolved
(``fusion/masks.py::resolve_overlap_pair``; ``expand_and_resolve``).
"""

from __future__ import annotations

from typing import Callable, List

import torch

from tweediemix_tpu_torch.fusion.masks import rect_expand, resolve_overlap_pair, sequential_blackout

# predict_fn(image [H, W, 3] float in [0, 1], text) → mask [H, W] float {0, 1}
PredictFn = Callable[[torch.Tensor, str], torch.Tensor]


def predict_in_turn(predict_fn: PredictFn, image: torch.Tensor, concepts: List[str]) -> List[torch.Tensor]:
    """Each concept's mask, in order: predicted on the image with the
    earlier concepts' mask pixels blacked out."""
    masks = []
    img = image
    for concept in concepts:
        mask = predict_fn(img, concept)
        masks.append(mask)
        img = sequential_blackout(img, mask)
    return masks


def expand_and_resolve(masks: List[torch.Tensor]) -> torch.Tensor:
    """[N_concepts, H, W]: each mask's filled bounding rectangle, the
    overlap of two resolved."""
    rects = [rect_expand(m) for m in masks]
    if len(rects) == 2:
        rects = list(resolve_overlap_pair(rects[0], rects[1], masks[0], masks[1]))
    return torch.stack(rects)


def expand_masks(predict_fn: PredictFn, image: torch.Tensor, concepts: List[str]) -> torch.Tensor:
    """[N_concepts, H, W] rectangle-expanded, overlap-resolved masks."""
    return expand_and_resolve(predict_in_turn(predict_fn, image, concepts))
