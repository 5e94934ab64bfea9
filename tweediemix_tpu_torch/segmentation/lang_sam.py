"""LangSAM: text → boxes → masks, in process (counterpart of
``tweediemix_tpu/segmentation/lang_sam.py``).

``predict(image, text)`` detects boxes for the phrase, with the OWL-ViT
``TextBoxDetector`` or the reference's own GroundingDINO
(``models/dino.py::DinoDetector``), and segments every box with ``SAM``;
the masks stay on the device. ``make_model_segment_fn`` turns it into the
fusion sampler's ``segment_fn`` (detect → segment → rectangle-expand →
black out → resolve overlap). ``HeuristicSegmenter`` is the weights-free
stand-in for smoke runs.

Image resizes follow ``jax.image.resize(..., "bilinear")``, which
antialiases when it downsamples: torch's ``bilinear`` with
``antialias=True`` (half-pixel centres, the triangle filter widened by the
scale, weights renormalised at the borders) computes the same, up and
down.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from tweediemix_tpu_torch.device import resolve_device
from tweediemix_tpu_torch.segmentation.detector import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    DetectorConfig,
    TextBoxDetector,
)
from tweediemix_tpu_torch.segmentation.expand import expand_masks
from tweediemix_tpu_torch.segmentation.sam import SAM, SAMConfig

# segment-anything's pixel statistics (0-255 scale)
SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Resize the last two axes of x [..., H, W] to (h, w) as
    ``jax.image.resize(..., "bilinear")`` does (antialiased downsampling);
    the same size is the identity."""
    if tuple(x.shape[-2:]) == (h, w):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(1, -1, *x.shape[-2:]), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.reshape(*lead, h, w)


@torch.no_grad()
def seeded_init_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Redraw every parameter and buffer of ``module`` from ``generator``:
    LayerNorm and GroupNorm weights 1 and biases 0, other biases 0,
    matrices and kernels N(0, 1/fan_in), vectors and embedding tables
    N(0, 0.02²), SAM's random Fourier matrix N(0, 1) and its
    relative-position tables 0 (as the JAX package initialises them)."""
    norms = {id(m) for m in module.modules() if isinstance(m, (torch.nn.LayerNorm, torch.nn.GroupNorm))}
    for mod in module.modules():
        for name, t in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
            if id(mod) in norms:
                t.fill_(1.0 if name == "weight" else 0.0)
            elif name == "bias" or name.startswith("rel_pos"):
                t.zero_()
            elif name == "positional_encoding_gaussian_matrix":
                t.copy_(torch.randn(t.shape, generator=generator, device=t.device))
            elif isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)):
                fan_in = t[0].numel()
                t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * fan_in**-0.5)
            elif isinstance(mod, torch.nn.ConvTranspose2d):
                fan_in = t.shape[0]
                t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * fan_in**-0.5)
            else:
                t.copy_(0.02 * torch.randn(t.shape, generator=generator, device=t.device))
    return module


class LangSAM:
    """The detector and SAM on one device: the OWL-ViT ``detector`` with its
    tokenizer, or a GroundingDINO ``dino`` (a ``DinoDetector``, which holds
    its own). Sets TF32 off for matmuls and convolutions in this process:
    the masks are fp32 logits thresholded at 0, and DINO runs in fp32."""

    def __init__(self, sam: SAM, detector: Optional[TextBoxDetector] = None, tokenizer=None,
                 box_threshold: float = 0.20, dino=None):
        if (detector is None) == (dino is None):
            raise ValueError("LangSAM takes one detector: an OWL-ViT detector or a DinoDetector")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.sam = sam.eval()
        self.detector = None if detector is None else detector.eval()
        self.dino = dino
        self.tokenizer = tokenizer
        self.box_threshold = box_threshold

    @property
    def device(self) -> torch.device:
        return self.sam.mask_decoder.iou_token.weight.device

    @classmethod
    def from_pretrained(cls, sam_checkpoint: str, detector_dir: str, box_threshold: float = 0.20,
                        detector: str = "auto", device="cuda") -> "LangSAM":
        """SAM ViT-H from a segment-anything ``.pth``/``.safetensors`` file
        or directory and a detector, on ``device``. ``detector`` "owlvit":
        the OWL-ViT base-patch32 detector and its tokenizer from an HF
        directory (``vocab.json`` beside the weights or under
        ``tokenizer/``); "dino": GroundingDINO Swin-B
        (``DinoConfig.swin_b()``, fp32) from the original repo's ``.pth``
        (``groundingdino_swinb_cogcoor.pth``) or an HF directory, with
        ``vocab.txt`` beside it; "auto" takes a single file, or a directory
        whose ``config.json`` ``model_type`` names grounding, as
        GroundingDINO, else OWL-ViT. The detector loads first; a checkpoint
        that does not load raises, and nothing falls back to the other
        detector."""
        from tweediemix_tpu_torch.models.convert import load_detector, load_dino, load_sam
        from tweediemix_tpu_torch.utils.tokenizer import BertWordPieceTokenizer, CLIPBPETokenizer

        if detector == "auto":
            detector = "dino" if _looks_like_dino(detector_dir) else "owlvit"
        if detector not in ("owlvit", "dino"):
            raise ValueError(f"unknown detector {detector!r}; use 'owlvit', 'dino' or 'auto'")
        device = resolve_device(device)
        if detector == "dino":
            from tweediemix_tpu_torch.models.dino import DinoConfig, DinoDetector

            cfg = DinoConfig.swin_b()
            model = load_dino(detector_dir, cfg, device)
            tok_dir = os.path.dirname(detector_dir) if os.path.isfile(detector_dir) else detector_dir
            dino = DinoDetector(cfg, model, BertWordPieceTokenizer.from_dir(tok_dir))
            sam = load_sam(sam_checkpoint, SAMConfig.vit_h(), device)
            return cls(sam, box_threshold=box_threshold, dino=dino)
        det_cfg = DetectorConfig.owlvit_base_patch32()
        sam = load_sam(sam_checkpoint, SAMConfig.vit_h(), device)
        det = load_detector(detector_dir, det_cfg, device)
        tok_dir = detector_dir
        if not os.path.exists(os.path.join(tok_dir, "vocab.json")):
            tok_dir = os.path.join(detector_dir, "tokenizer")
        tokenizer = CLIPBPETokenizer.from_dir(tok_dir, max_length=det_cfg.text.max_positions)
        return cls(sam, det, tokenizer, box_threshold=box_threshold)

    @classmethod
    def random_init(cls, generator: Optional[torch.Generator] = None, sam_cfg=None, det_cfg=None,
                    tokenizer=None, device="cuda") -> "LangSAM":
        """Seeded random weights (the tiny configs by default) drawn on the
        CPU from ``generator`` (seed 0 without one), moved to ``device``,
        and a hash tokenizer, for runs without checkpoints."""
        from tweediemix_tpu_torch.utils.tokenizer import HashTokenizer

        device = resolve_device(device)
        generator = generator or torch.Generator().manual_seed(0)
        sam_cfg = sam_cfg or SAMConfig.tiny()
        det_cfg = det_cfg or DetectorConfig.tiny()
        sam = seeded_init_(SAM(sam_cfg, device="cpu"), generator).to(device)
        det = seeded_init_(TextBoxDetector(det_cfg, device="cpu"), generator).to(device)
        tokenizer = tokenizer or HashTokenizer(det_cfg.text.vocab_size)
        return cls(sam, det, tokenizer)

    @torch.inference_mode()
    def predict_logits(self, image: torch.Tensor, text: str):
        """image [H, W, 3] in [0, 1] → (mask logits [K, H, W], boxes [K, 4],
        scores [K]), K = ``max_boxes``: the detector's top boxes for the
        phrase, each segmented by SAM, its logits resized to the image."""
        image = image.to(self.device, torch.float32)
        h, w = image.shape[:2]
        chw = image.permute(2, 0, 1)
        if self.dino is not None:
            boxes, scores = self.dino(image, text)
        else:
            mean = torch.tensor(CLIP_IMAGE_MEAN, device=self.device)
            std = torch.tensor(CLIP_IMAGE_STD, device=self.device)
            det_size = self.detector.config.vision.image_size
            det_img = (resize_bilinear(chw, det_size, det_size).permute(1, 2, 0) - mean) / std
            max_len = self.detector.config.text.max_positions
            ids = torch.tensor(self.tokenizer([text]), dtype=torch.long, device=self.device)[:, :max_len]
            boxes, scores = self.detector(det_img[None], ids)

        sam_size = self.sam.config.image_size
        sam_img = resize_bilinear(chw, sam_size, sam_size).permute(1, 2, 0)
        sam_img = (sam_img * 255.0 - torch.tensor(SAM_PIXEL_MEAN, device=self.device)) / torch.tensor(
            SAM_PIXEL_STD, device=self.device)
        mask_logits, _ = self.sam(sam_img[None], boxes)
        return resize_bilinear(mask_logits, h, w), boxes, scores

    def predict(self, image: torch.Tensor, text: str, box_threshold: Optional[float] = None):
        """image [H, W, 3] in [0, 1] → (masks [K, H, W] bool = logits > 0,
        boxes [K, 4], scores [K], valid [K] = scores > threshold)."""
        thr = self.box_threshold if box_threshold is None else box_threshold
        logits, boxes, scores = self.predict_logits(image, text)
        return logits > 0.0, boxes, scores, scores > thr


def _looks_like_dino(detector_dir: str) -> bool:
    """A single checkpoint file, or a directory whose ``config.json`` names
    a grounding model (the JAX package's sniff)."""
    if os.path.isfile(detector_dir):
        return True
    cfg_path = os.path.join(detector_dir, "config.json")
    if os.path.exists(cfg_path):
        import json

        with open(cfg_path) as f:
            return "grounding" in json.load(f).get("model_type", "")
    return False


@dataclasses.dataclass
class HeuristicSegmenter:
    """Split the image into ``n_concepts`` vertical bands of equal width:
    image [1, H, W, 3] (or [H, W, 3]) → masks [n_concepts, H, W] on the
    image's device. Smoke runs only: not a segmentation."""

    n_concepts: int

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        img = image[0] if image.ndim == 4 else image
        h, w = img.shape[:2]
        edges = torch.linspace(0, w, self.n_concepts + 1, device=img.device)
        xs = torch.arange(w, device=img.device)
        bands = [((xs >= edges[i]) & (xs < edges[i + 1])).float() for i in range(self.n_concepts)]
        return torch.stack([band[None].expand(h, w) for band in bands])


def make_model_segment_fn(lang_sam: LangSAM, seg_concepts: str) -> Callable:
    """The fusion sampler's ``segment_fn``: preview image [1, H, W, 3] (or
    [H, W, 3]) → [N, H, W] masks, one per ``+``-separated concept, through
    detect → segment → rectangle-expand → black out → resolve overlap.

    No-detection contract: where no box clears the threshold for a concept
    (the reference crashes there), the top-scoring box is taken, with a
    warning naming the concept, and ``segment_fn.no_detections`` lists
    (concept, top score) for the last call. ``segment_fn.top_scores``
    lists (concept, top score) of every concept, ``segment_fn.areas`` the
    share of the image each returned mask covers, and
    ``segment_fn.seconds`` the last call's wall time (ending in a device
    synchronise)."""
    concepts: List[str] = seg_concepts.split("+")

    def predict_best(img, text):
        masks, _, scores, valid = lang_sam.predict(img, text)
        top = float(scores[0])
        segment_fn.top_scores.append((text, top))
        if not bool(valid.any()):
            segment_fn.no_detections.append((text, top))
            warnings.warn(
                f"segmentation: no box cleared box_threshold={lang_sam.box_threshold} for "
                f"concept {text!r} (top score {top:.4f}); falling back to the top-scoring box "
                "(the reference crashes here)", stacklevel=2)
        best = torch.argmax(torch.where(valid, scores, -torch.inf))
        return masks[best].float()

    def segment_fn(preview_image: torch.Tensor) -> torch.Tensor:
        segment_fn.no_detections, segment_fn.top_scores = [], []
        t0 = time.perf_counter()
        img = preview_image[0] if preview_image.ndim == 4 else preview_image
        out = expand_masks(predict_best, img.to(lang_sam.device, torch.float32), concepts)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        segment_fn.seconds = time.perf_counter() - t0
        segment_fn.areas = out.mean(dim=(1, 2)).tolist()
        return out

    segment_fn.no_detections, segment_fn.top_scores, segment_fn.areas = [], [], []
    segment_fn.seconds = 0.0
    return segment_fn
