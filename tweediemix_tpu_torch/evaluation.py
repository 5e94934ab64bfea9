"""Quantitative evaluation: CLIP text- and image-alignment scores
(counterpart of ``tweediemix_tpu/evaluation.py``).

The TweedieMix paper (arXiv 2410.05591) reports CLIP text and image
similarity following the Custom Diffusion protocol:

- **CLIP-T**: cosine similarity between a generated image's CLIP image
  embedding and the CLIP text embedding of its prompt, with the learned
  modifier tokens (``<new1>`` …) stripped from the prompt;
- **CLIP-I**: mean cosine similarity between the generated image's
  embedding and the embeddings of the concept's real instance images.

Both run on the port's CLIP towers (``models/clip.py``) in fp32: the text
tower's pooled output through ``text_projection`` and the vision tower's
class token through ``visual_projection``, each L2-normalised. An HF
``CLIPModel`` directory (both towers and projections in one state dict,
e.g. ``openai/clip-vit-large-patch14``) loads through
``models/convert.py::load_clip_model``. TF32 is turned off in this process,
as ``LangSAM`` does, so the scores on the card are fp32 scores.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import List, Sequence

import numpy as np
import torch

from tweediemix_tpu_torch.device import resolve_device
from tweediemix_tpu_torch.models.clip import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    CLIPTextConfig,
    CLIPTextModel,
    CLIPVisionConfig,
    CLIPVisionModel,
)
from tweediemix_tpu_torch.segmentation.lang_sam import resize_bilinear

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def clip_preprocess(img01: torch.Tensor, image_size: int) -> torch.Tensor:
    """[H, W, 3] in [0, 1] → [S, S, 3] normalised with CLIP's statistics:
    shortest-side bilinear resize (antialiased, as ``jax.image.resize``)
    and centre crop, the CLIPImageProcessor pipeline."""
    h, w = img01.shape[:2]
    if h <= w:
        th, tw = image_size, max(image_size, int(round(w * image_size / h)))
    else:
        th, tw = max(image_size, int(round(h * image_size / w))), image_size
    resized = resize_bilinear(img01.permute(2, 0, 1), th, tw).permute(1, 2, 0)
    y0, x0 = (th - image_size) // 2, (tw - image_size) // 2
    crop = resized[y0 : y0 + image_size, x0 : x0 + image_size]
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=crop.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=crop.device)
    return (crop - mean) / std


def strip_modifier_tokens(prompt: str, modifier_tokens: Sequence[str]) -> str:
    """Remove learned placeholder tokens (``<new1>`` …) from an eval prompt:
    the CLIP-T protocol scores the natural-language prompt."""
    for tok in modifier_tokens:
        if tok:
            prompt = prompt.replace(tok, " ")
    return re.sub(r"\s+", " ", prompt).strip()


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-8)


@dataclasses.dataclass
class CLIPScorer:
    """Joint-space CLIP embedder and the two alignment metrics, on the
    towers' device."""

    text_model: CLIPTextModel
    vision_model: CLIPVisionModel
    tokenizer: object  # CLIPBPETokenizer / HashTokenizer contract

    def __post_init__(self):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.text_model.eval()
        self.vision_model.eval()

    @property
    def device(self) -> torch.device:
        return self.vision_model.visual_projection.weight.device

    @property
    def image_size(self) -> int:
        return self.vision_model.config.image_size

    # -- construction --------------------------------------------------------

    @staticmethod
    def configs(config: dict, eos_token_id: int):
        """(CLIPTextConfig, CLIPVisionConfig) from an HF CLIPModel
        ``config.json``, with its defaults; the text tower pools at
        ``eos_token_id`` (the tokenizer's: openai/clip-* configs carry a
        historical ``eos_token_id`` of 2 while HF pools at 49407)."""
        tc, vc = config.get("text_config", {}), config.get("vision_config", {})
        proj = config.get("projection_dim", tc.get("projection_dim", 512))
        text_cfg = CLIPTextConfig(
            vocab_size=tc.get("vocab_size", 49408),
            hidden_size=tc.get("hidden_size", 512),
            intermediate_size=tc.get("intermediate_size", 2048),
            num_layers=tc.get("num_hidden_layers", 12),
            num_heads=tc.get("num_attention_heads", 8),
            max_positions=tc.get("max_position_embeddings", 77),
            hidden_act=tc.get("hidden_act", "quick_gelu"),
            projection_dim=proj,
            eos_token_id=eos_token_id,
        )
        vision_cfg = CLIPVisionConfig(
            image_size=vc.get("image_size", 224),
            patch_size=vc.get("patch_size", 32),
            hidden_size=vc.get("hidden_size", 768),
            intermediate_size=vc.get("intermediate_size", 3072),
            num_layers=vc.get("num_hidden_layers", 12),
            num_heads=vc.get("num_attention_heads", 12),
            hidden_act=vc.get("hidden_act", "quick_gelu"),
            projection_dim=proj,
        )
        return text_cfg, vision_cfg

    @classmethod
    def from_pretrained(cls, clip_dir: str, device="cuda") -> "CLIPScorer":
        """An HF CLIPModel directory: ``config.json`` with ``text_config``/
        ``vision_config``, one state dict (``.safetensors`` or ``.bin``)
        holding both towers and projections, and the tokenizer files
        (``vocab.json``, ``merges.txt``) beside them. A missing, unexpected
        or mis-shaped tensor raises."""
        from tweediemix_tpu_torch.models.convert import load_clip_model
        from tweediemix_tpu_torch.utils.tokenizer import CLIPBPETokenizer

        device = resolve_device(device)
        with open(os.path.join(clip_dir, "config.json")) as f:
            config = json.load(f)
        tokenizer = CLIPBPETokenizer.from_dir(clip_dir)
        text_cfg, vision_cfg = cls.configs(config, tokenizer.eos_token_id)
        text, vision = load_clip_model(clip_dir, text_cfg, vision_cfg, device)
        return cls(text, vision, tokenizer)

    @classmethod
    def tiny(cls, seed: int = 0, device="cuda") -> "CLIPScorer":
        """Seeded random tiny towers (torch's initialisation on the CPU
        after ``torch.manual_seed(seed)``, moved to ``device``) and a hash
        tokenizer: tests and smoke runs only."""
        from tweediemix_tpu_torch.utils.tokenizer import HashTokenizer

        device = resolve_device(device)
        text_cfg = CLIPTextConfig.tiny(projection_dim=32)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            text = CLIPTextModel(text_cfg, device="cpu")
            vision = CLIPVisionModel(CLIPVisionConfig.tiny(), device="cpu")
        return cls(text.to(device), vision.to(device), HashTokenizer(vocab_size=text_cfg.vocab_size))

    # -- embeddings -----------------------------------------------------------

    @torch.inference_mode()
    def embed_texts(self, texts: Sequence[str]) -> torch.Tensor:
        ids = torch.tensor(self.tokenizer(list(texts)), dtype=torch.long, device=self.device)
        return _l2norm(self.text_model(ids)[2].float())

    @torch.inference_mode()
    def embed_images(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        """images: [H, W, 3] uint8 (or [0, 1] float) arrays."""
        pixels = []
        for im in images:
            arr = torch.from_numpy(np.array(im)).to(self.device)
            arr = arr.float() / 255.0 if arr.dtype == torch.uint8 else arr.float()
            pixels.append(clip_preprocess(arr, self.image_size))
        return _l2norm(self.vision_model(torch.stack(pixels)).float())

    # -- metrics --------------------------------------------------------------

    def clip_t(self, images: Sequence[np.ndarray], prompts: Sequence[str],
               modifier_tokens: Sequence[str] = ()) -> float:
        """Mean image↔prompt cosine similarity (prompts modifier-stripped);
        ``prompts`` is one prompt for all images or one per image."""
        prompts = list(prompts)
        if len(prompts) == 1:
            prompts = prompts * len(images)
        if len(prompts) != len(images):
            raise ValueError(f"{len(prompts)} prompts for {len(images)} images")
        prompts = [strip_modifier_tokens(p, modifier_tokens) for p in prompts]
        ie = self.embed_images(images)
        te = self.embed_texts(prompts)
        return float((ie * te).sum(dim=-1).mean())

    def clip_i(self, images: Sequence[np.ndarray], concept_images: Sequence[np.ndarray]) -> float:
        """Mean pairwise generated↔instance cosine similarity."""
        ge = self.embed_images(images)
        ce = self.embed_images(concept_images)
        return float((ge @ ce.T).mean())


def load_image_paths(path_or_glob: str) -> List[str]:
    """A directory (all image files, sorted) or a glob pattern."""
    if os.path.isdir(path_or_glob):
        files = sorted(os.path.join(path_or_glob, f) for f in os.listdir(path_or_glob)
                       if f.lower().endswith(IMAGE_EXTENSIONS))
    else:
        files = sorted(glob.glob(path_or_glob))
    if not files:
        raise FileNotFoundError(f"no images found at {path_or_glob!r}")
    return files


def load_images(path_or_glob: str) -> List[np.ndarray]:
    """uint8 [H, W, 3] arrays through the port's reader (PNG without PIL)."""
    from tweediemix_tpu_torch.utils.image import read_image

    return [read_image(p) for p in load_image_paths(path_or_glob)]
