"""Segmentation stage of the fusion sampler (counterpart of
``tweediemix_tpu/segmentation``): a callable from the decoded Tweedie
preview to image-resolution foreground masks, run in process at the
sampler's boundary step.

Presets: ``sam`` loads SAM ViT-H and a detector from local checkpoints
(``sam_checkpoint``/``detector_dir``, or the
``TWEEDIEMIX_SAM_CHECKPOINT``/``TWEEDIEMIX_DETECTOR_DIR`` environment
variables): the OWL-ViT base-patch32 detector from an HF directory, or the
reference's GroundingDINO Swin-B (``detector="dino"``, or ``auto`` when it
finds a DINO checkpoint: a single ``.pth`` or a grounding ``config.json``)
with ``vocab.txt`` beside it; a detector that does not load raises and
never falls back to the other. ``sam-random`` draws the tiny models from a
seeded generator (tests, demos); ``heuristic`` substitutes vertical bands
for real segmentation (smoke runs only, NOT production quality).
"""

from __future__ import annotations

import os
import sys

from tweediemix_tpu_torch.segmentation.expand import expand_masks  # noqa: F401
from tweediemix_tpu_torch.segmentation.lang_sam import (  # noqa: F401
    HeuristicSegmenter,
    LangSAM,
    make_model_segment_fn,
)

# default local checkpoint locations for the real-weights preset
SAM_CHECKPOINT_ENV = "TWEEDIEMIX_SAM_CHECKPOINT"
DETECTOR_DIR_ENV = "TWEEDIEMIX_DETECTOR_DIR"


def make_segment_fn(seg_concepts: str, output_path: str, preset: str = "heuristic",
                    sam_checkpoint: str = None, detector_dir: str = None,
                    box_threshold: float = 0.20, detector: str = "auto", device="cuda"):
    """The fusion sampler's ``segment_fn`` for ``+``-separated
    ``seg_concepts``, its models on ``device`` (``output_path`` is kept for
    the JAX package's signature)."""
    concepts = seg_concepts.split("+")
    if preset == "heuristic":
        print(
            "WARNING: --seg_preset heuristic substitutes luminance-band masks "
            "for real segmentation; use preset 'sam' with weights for quality.",
            file=sys.stderr,
        )
        return HeuristicSegmenter(len(concepts))
    if preset == "sam-random":
        return make_model_segment_fn(LangSAM.random_init(device=device), seg_concepts)
    if preset == "sam":
        sam_checkpoint = sam_checkpoint or os.environ.get(SAM_CHECKPOINT_ENV)
        detector_dir = detector_dir or os.environ.get(DETECTOR_DIR_ENV)
        if not sam_checkpoint or not detector_dir:
            raise FileNotFoundError(
                "seg preset 'sam' needs --sam_checkpoint (segment-anything "
                "ViT-H .pth/safetensors) and --detector_dir (HF OWL-ViT dir, or "
                "a GroundingDINO .pth or HF dir with vocab.txt beside it), "
                f"or the {SAM_CHECKPOINT_ENV}/{DETECTOR_DIR_ENV} env vars"
            )
        ls = LangSAM.from_pretrained(sam_checkpoint, detector_dir, box_threshold=box_threshold,
                                     detector=detector, device=device)
        return make_model_segment_fn(ls, seg_concepts)
    raise ValueError(
        f"unknown segment preset {preset!r}; use 'sam', 'sam-random', "
        "'heuristic', or --mask_dir"
    )
