"""Plain OWL-ViT (``google/owlvit-base-patch32``; arXiv 2205.06230), as
``OwlViTForObjectDetection`` computes it, under its parameter names.

* image tower: a CLIP ViT-B/32 (patch convolution without bias, a class
  token, position embeddings, ``pre_layernorm``, pre-LN layers with
  quick-GELU MLPs, ``post_layernorm`` over the whole sequence);
* text tower: a CLIP text transformer (causal attention, quick-GELU),
  ``final_layer_norm``, the state at the first end token projected by
  ``text_projection``;
* the patch features: each patch's state times the class token's, through
  ``layer_norm``;
* class head: the cosine of the projected patch (``dense0``) and the query,
  plus ``logit_shift``, times ``elu(logit_scale) + 1``, through a sigmoid;
* box head: ``dense0``, GELU, ``dense1``, GELU, ``dense2``, plus the static
  bias of each patch (logit of its grid corner (col + 1, row + 1) / g and
  of the size 1 / g), through a sigmoid, (cx, cy, w, h) -> xyxy.

Departures from upstream, which the configuration states:

* the image is resized to the tower's square by ``sam.resize``
  (``jax.image.resize`` bilinear, antialiased), not by the processor's
  resampling, then normalised with CLIP's mean and std;
* the text's ids come from ``hash_ids`` (one id per word from CRC-32,
  begin and end tokens, padded with the end token): no BPE vocabulary is
  available; with causal attention the pooled state does not see the
  padding, so no padding mask is applied;
* the boxes are clipped to [0, 1].

Everything is fp32 with TF32 off; the products are counted through
``ops.counting``. Nothing here imports the measured program.
"""

from __future__ import annotations

import zlib
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops
from benchmark.reference.ops import LayerNorm, Linear
from benchmark.reference.sam import Conv2d, Embedding, empty, resize

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def hash_ids(text: str, vocab: int, length: int) -> List[int]:
    """Begin token (vocab - 2), one id per lower-cased word (CRC-32 modulo
    vocab - 2), end token (vocab - 1), padded with the end token."""
    words = [w for w in text.lower().split() if w][:length - 2]
    ids = [vocab - 2] + [zlib.crc32(w.encode()) % (vocab - 2) for w in words] + [vocab - 1]
    return ids + [vocab - 1] * (length - len(ids))


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Linear(dim, dim), Linear(dim, dim)
        self.v_proj, self.out_proj = Linear(dim, dim), Linear(dim, dim)

    def forward(self, x, causal: bool):
        b, t, d = x.shape
        hd = d // self.heads
        q, k, v = (ops.split_heads(p(x), self.heads) for p in (self.q_proj, self.k_proj, self.v_proj))
        ops._count("attention", 4.0 * b * self.heads * t * t * hd)
        s = torch.bmm(q * hd**-0.5, k.transpose(1, 2))
        if causal:
            keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
            s = s.masked_fill(~keep, torch.finfo(torch.float32).min)
        o = torch.bmm(s.softmax(dim=-1), v)
        return self.out_proj(ops.merge_heads(o, self.heads))


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(dim, hidden), Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.self_attn = SelfAttention(d, cfg["num_attention_heads"])
        self.layer_norm1 = LayerNorm(d, eps)
        self.mlp = MLP(d, cfg["intermediate_size"])
        self.layer_norm2 = LayerNorm(d, eps)

    def forward(self, x, causal: bool):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class Encoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg["num_hidden_layers"]))

    def forward(self, x, causal: bool):
        for layer in self.layers:
            x = layer(x, causal)
        return x


class VisionEmbeddings(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        d, p = cfg["hidden_size"], cfg["patch_size"]
        self.class_embedding = empty(d)
        self.patch_embedding = Conv2d(3, d, p, stride=p, bias=False)
        self.position_embedding = Embedding((cfg["image_size"] // p) ** 2 + 1, d)


class VisionTower(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.embeddings = VisionEmbeddings(cfg)
        self.pre_layernorm = LayerNorm(d, eps)
        self.encoder = Encoder(cfg)
        self.post_layernorm = LayerNorm(d, eps)

    def forward(self, pixels):
        """[B, S, S, 3] normalised -> the post-LayerNormed sequence [B, 1 + P, D]."""
        e = self.embeddings
        x = e.patch_embedding(pixels.float().permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = e.class_embedding.float().expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + e.position_embedding.weight.float()
        x = self.encoder(self.pre_layernorm(x), causal=False)
        return self.post_layernorm(x)


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.token_embedding = Embedding(cfg["vocab_size"], cfg["hidden_size"])
        self.position_embedding = Embedding(cfg["max_position_embeddings"], cfg["hidden_size"])


class TextTower(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.eos = cfg["eos_token_id"]
        self.embeddings = TextEmbeddings(cfg)
        self.encoder = Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg["hidden_size"], cfg["layer_norm_eps"])

    def forward(self, ids):
        """[B, T] -> the final-LayerNormed state at each row's first end token."""
        e = self.embeddings
        t = ids.shape[1]
        x = F.embedding(ids, e.token_embedding.weight.float()) + e.position_embedding.weight[:t].float()
        x = self.final_layer_norm(self.encoder(x, causal=True))
        first = (ids == self.eos).int().argmax(dim=1)
        return x[torch.arange(ids.shape[0], device=ids.device), first]


class OwlViTModel(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        t = cfg["text_config"]
        self.vision_model = VisionTower(cfg["vision_config"])
        self.text_model = TextTower(t)
        self.text_projection = Linear(t["hidden_size"], cfg["projection_dim"], bias=False)


class ClassHead(nn.Module):
    def __init__(self, d: int, embed: int):
        super().__init__()
        self.dense0 = Linear(d, embed)
        self.logit_shift, self.logit_scale = Linear(d, 1), Linear(d, 1)


class BoxHead(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.dense0, self.dense1, self.dense2 = Linear(d, d), Linear(d, d), Linear(d, 4)


def box_bias(g: int, device) -> torch.Tensor:
    """[g * g, 4]: the logits of each patch's grid corner ((col + 1) / g,
    (row + 1) / g) and of the size 1 / g."""
    ar = torch.arange(1, g + 1, dtype=torch.float64, device=device) / g
    xy = torch.stack(torch.meshgrid(ar, ar, indexing="xy"), dim=-1).reshape(-1, 2)
    size = torch.full_like(xy, 1.0 / g)

    def logit(v):
        return torch.log(v + 1e-4) - torch.log1p(-v + 1e-4)

    return torch.cat([logit(xy), logit(size)], dim=-1).float()


class OwlViT(nn.Module):
    """``cfg``: the configuration file's ``detector`` object."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        v = cfg["vision_config"]
        d = v["hidden_size"]
        self.owlvit = OwlViTModel(cfg)
        self.layer_norm = LayerNorm(d, v["layer_norm_eps"])
        self.class_head = ClassHead(d, cfg["projection_dim"])
        self.box_head = BoxHead(d)

    def forward(self, pixels, ids):
        """pixels [1, S, S, 3] normalised, ids [1, T] -> (boxes [P, 4] xyxy
        in [0, 1], scores [P]) of every patch, in patch order."""
        seq = self.owlvit.vision_model(pixels)
        feats = self.layer_norm(seq[:, 1:] * seq[:, :1])
        query = self.owlvit.text_projection(self.owlvit.text_model(ids))
        img = self.class_head.dense0(feats)
        img = img / (torch.linalg.vector_norm(img, dim=-1, keepdim=True) + 1e-6)
        query = query / (torch.linalg.vector_norm(query, dim=-1, keepdim=True) + 1e-6)
        ops._count("gemm", 2.0 * img.shape[1] * img.shape[2])
        logits = torch.einsum("bpd,bd->bp", img, query)
        scale = F.elu(self.class_head.logit_scale(feats)[..., 0]) + 1.0
        scores = torch.sigmoid((logits + self.class_head.logit_shift(feats)[..., 0]) * scale)[0]
        h = F.gelu(self.box_head.dense0(feats))
        h = F.gelu(self.box_head.dense1(h))
        g = self.cfg["vision_config"]["image_size"] // self.cfg["vision_config"]["patch_size"]
        box = torch.sigmoid(self.box_head.dense2(h)[0] + box_bias(g, pixels.device))
        xy, wh = box[:, :2], box[:, 2:]
        return torch.cat([xy - 0.5 * wh, xy + 0.5 * wh], dim=-1).clamp(0.0, 1.0), scores

    def pixels(self, image: torch.Tensor) -> torch.Tensor:
        """image [H, W, 3] in [0, 1] -> the tower's input [1, S, S, 3]."""
        s = self.cfg["vision_config"]["image_size"]
        x = resize(image.float().permute(2, 0, 1), s, s).permute(1, 2, 0)
        mean = torch.tensor(CLIP_MEAN, device=image.device)
        std = torch.tensor(CLIP_STD, device=image.device)
        return ((x - mean) / std)[None]

    def ids(self, text: str, device) -> torch.Tensor:
        t = self.cfg["text_config"]
        return torch.tensor([hash_ids(text, t["vocab_size"], t["max_position_embeddings"])],
                            device=device)

    def detect(self, image: torch.Tensor, text: str):
        """(boxes, scores) of every patch for the phrase on the image."""
        return self(self.pixels(image), self.ids(text, image.device))


def top(boxes: torch.Tensor, scores: torch.Tensor, k: int):
    """The ``k`` highest scores and their boxes, highest first; equal scores
    keep the lower patch first."""
    order = torch.sort(scores, descending=True, stable=True).indices[:k]
    return boxes[order], scores[order]
