"""Text-conditioned open-vocabulary box detector in the OWL-ViT layout
(counterpart of ``tweediemix_tpu/segmentation/detector.py``).

``(image, text) → boxes (xyxy in [0, 1]), scores``, computed as HF's
``OwlViTForObjectDetection`` computes it and under its parameter names
(``owlvit.vision_model.…``, ``owlvit.text_model.…``, ``class_head.dense0``,
``box_head.dense2``, ``layer_norm``), so a ``google/owlvit-base-patch32``
directory loads without renaming (``models/convert.py::load_detector``):

* a CLIP ViT image tower (class token, pre/post LayerNorm, quick-gelu)
  whose patch features are merged with the class token
  (``post_ln(seq)[1:] * cls``) and LayerNormed again;
* a CLIP text tower and projection give one query embedding per phrase
  (pooled at the first EOS);
* class head: normalised patch·query similarity with a learned per-patch
  logit shift and an (elu + 1) logit scale, through a sigmoid;
* box head: a 3-layer exact-gelu MLP over the patch features plus a static
  logit-space centre/size bias per patch, sigmoid → cxcywh → xyxy.

The top ``max_boxes`` boxes come back sorted by score; equal scores keep
the lower patch index first, as ``jax.lax.top_k`` orders them. The towers'
attention (577 and 16 tokens) is plain torch math, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tweediemix_tpu_torch.device import resolve_device
from tweediemix_tpu_torch.models.clip import (
    CLIP_IMAGE_MEAN,  # noqa: F401  (the OwlViTProcessor normalisation)
    CLIP_IMAGE_STD,  # noqa: F401
    CLIPTextConfig,
    CLIPTextModel,
    CLIPVisionConfig,
    CLIPVisionTransformer,
)


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    vision: CLIPVisionConfig = dataclasses.field(
        default_factory=lambda: CLIPVisionConfig(
            image_size=768, patch_size=32, hidden_size=768,
            intermediate_size=3072, num_layers=12, num_heads=12,
            hidden_act="quick_gelu", projection_dim=None,
        )
    )
    text: CLIPTextConfig = dataclasses.field(
        default_factory=lambda: CLIPTextConfig(
            hidden_size=512, intermediate_size=2048, num_layers=12,
            num_heads=8, max_positions=16, hidden_act="quick_gelu",
            projection_dim=512,
        )
    )
    embed_dim: int = 512
    max_boxes: int = 8

    @staticmethod
    def owlvit_base_patch32(**kw) -> "DetectorConfig":
        """google/owlvit-base-patch32 (the defaults)."""
        return DetectorConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "DetectorConfig":
        defaults = dict(
            vision=CLIPVisionConfig.tiny(projection_dim=None),
            text=CLIPTextConfig.tiny(max_positions=16, projection_dim=32),
            embed_dim=32,
            max_boxes=4,
        )
        defaults.update(kw)
        return DetectorConfig(**defaults)


def _box_bias(g: int) -> np.ndarray:
    """OWL-ViT's static per-patch box bias in logit space, [g·g, 4]: the
    patch 'centres' are the normalised (col + 1, row + 1) / g corners (an
    upstream quirk kept for weight compatibility), the size prior 1/g."""
    coords = np.stack(
        np.meshgrid(np.arange(1, g + 1), np.arange(1, g + 1)), axis=-1
    ).astype(np.float32) / g  # [g, g, 2] = (x, y) per (row, col)
    coords = coords.reshape(-1, 2)
    coord_bias = np.log(coords + 1e-4) - np.log1p(-coords + 1e-4)
    size = np.full_like(coords, 1.0 / g)
    size_bias = np.log(size + 1e-4) - np.log1p(-size + 1e-4)
    return np.concatenate([coord_bias, size_bias], axis=-1)


class OwlViTVisionTower(CLIPVisionTransformer):
    """The CLIP ViT of OWL-ViT (``pre_layernorm``), returning the
    post-LayerNormed full sequence (class token + patches)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__(cfg, pre_norm="pre_layernorm")


class OwlViTModel(CLIPTextModel):
    """HF's ``owlvit`` scope: the text tower and its projection (the
    ``CLIPTextModel`` it inherits; ``forward`` gives its outputs) and the
    vision tower beside them. The contrastive head (``visual_projection``,
    ``logit_scale``) is not part of detection and is left out."""

    def __init__(self, config: DetectorConfig, device="cuda"):
        super().__init__(config.text, device=device)
        with torch.device(resolve_device(device)):
            self.vision_model = OwlViTVisionTower(config.vision)
        self.to(config.vision.dtype)


class OwlViTClassHead(nn.Module):
    def __init__(self, d: int, embed_dim: int):
        super().__init__()
        self.dense0 = nn.Linear(d, embed_dim)
        self.logit_shift = nn.Linear(d, 1)
        self.logit_scale = nn.Linear(d, 1)


class OwlViTBoxHead(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.dense0 = nn.Linear(d, d)
        self.dense1 = nn.Linear(d, d)
        self.dense2 = nn.Linear(d, 4)


class TextBoxDetector(nn.Module):
    """forward(pixels [1, S, S, 3] CLIP-normalised, text_ids [1, T]) →
    (boxes [max_boxes, 4] xyxy in [0, 1], scores [max_boxes]), in fp32.
    Parameters are created on ``device``."""

    def __init__(self, config: DetectorConfig, device="cuda"):
        super().__init__()
        self.config = cfg = config
        d = cfg.vision.hidden_size
        self.owlvit = OwlViTModel(cfg, device=device)
        with torch.device(resolve_device(device)):
            self.layer_norm = nn.LayerNorm(d, eps=1e-5)
            self.class_head = OwlViTClassHead(d, cfg.embed_dim)
            self.box_head = OwlViTBoxHead(d)
        self.to(cfg.vision.dtype)

    def forward(self, pixels: torch.Tensor, text_ids: torch.Tensor):
        cfg = self.config
        g = cfg.vision.image_size // cfg.vision.patch_size
        seq = self.owlvit.vision_model(pixels)
        feats = self.layer_norm(seq[:, 1:, :] * seq[:, :1, :])
        query = self.owlvit(text_ids)[2]

        img_cls = self.class_head.dense0(feats)
        img_n = img_cls / (torch.linalg.vector_norm(img_cls, dim=-1, keepdim=True) + 1e-6)
        q_n = query / (torch.linalg.vector_norm(query, dim=-1, keepdim=True) + 1e-6)
        logits = torch.einsum("bpd,bd->bp", img_n.float(), q_n.float())
        shift = self.class_head.logit_shift(feats)[..., 0].float()
        scale = F.elu(self.class_head.logit_scale(feats)[..., 0].float()) + 1.0
        scores = torch.sigmoid((logits + shift) * scale)[0]

        h = F.gelu(self.box_head.dense0(feats))
        h = F.gelu(self.box_head.dense1(h))
        raw = self.box_head.dense2(h)[0].float()
        bias = torch.from_numpy(_box_bias(g)).to(raw.device)
        cxcywh = torch.sigmoid(raw + bias)
        cxcy, wh = cxcywh[:, :2], cxcywh[:, 2:]
        boxes = torch.clamp(torch.cat([cxcy - wh / 2, cxcy + wh / 2], dim=-1), 0.0, 1.0)

        top = torch.sort(scores, descending=True, stable=True).indices[: cfg.max_boxes]
        return boxes[top], scores[top]
