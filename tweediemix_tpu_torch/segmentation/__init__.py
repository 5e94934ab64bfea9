"""Segmentation stage of the fusion sampler (counterpart of
``tweediemix_tpu/segmentation``): a callable from the decoded Tweedie
preview to image-resolution foreground masks.

Only the weights-free ``heuristic`` preset is ported: vertical bands of the
image, one per segmented concept, for smoke runs (not production quality).
The model presets (``sam``: GroundingDINO/OWL-ViT boxes and SAM masks;
``sam-random``) wait for ROADMAP item 13 and raise; they never fall back
to the heuristic.
"""

from __future__ import annotations

import dataclasses
import sys

import torch


@dataclasses.dataclass
class HeuristicSegmenter:
    """Split the image into ``n_concepts`` vertical bands of equal width:
    image [1, H, W, 3] (or [H, W, 3]) → masks [n_concepts, H, W] on the
    image's device."""

    n_concepts: int

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        img = image[0] if image.ndim == 4 else image
        h, w = img.shape[:2]
        edges = torch.linspace(0, w, self.n_concepts + 1, device=img.device)
        xs = torch.arange(w, device=img.device)
        bands = [((xs >= edges[i]) & (xs < edges[i + 1])).float() for i in range(self.n_concepts)]
        return torch.stack([band[None].expand(h, w) for band in bands])


def make_segment_fn(seg_concepts: str, output_path: str, preset: str = "heuristic",
                    sam_checkpoint: str = None, detector_dir: str = None,
                    box_threshold: float = 0.20, detector: str = "auto"):
    """The fusion sampler's ``segment_fn`` for ``+``-separated
    ``seg_concepts``. The arguments after ``preset`` belong to the model
    presets, which are not ported yet."""
    concepts = seg_concepts.split("+")
    if preset == "heuristic":
        print(
            "WARNING: --seg_preset heuristic substitutes luminance-band masks "
            "for real segmentation; use preset 'sam' with weights for quality.",
            file=sys.stderr,
        )
        return HeuristicSegmenter(len(concepts))
    if preset in ("sam", "sam-random"):
        raise NotImplementedError(
            f"seg preset {preset!r} (SAM with a GroundingDINO/OWL-ViT detector) is not "
            "ported to the torch package yet (ROADMAP item 13); pass --mask_dir or "
            "--seg_preset heuristic"
        )
    raise ValueError(
        f"unknown segment preset {preset!r}; use 'sam', 'sam-random', "
        "'heuristic', or --mask_dir"
    )
