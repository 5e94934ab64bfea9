"""CLIP text encoders (the dual SDXL pair) with modifier-token surgery, and
the CLIP vision tower (counterpart of ``tweediemix_tpu/models/clip.py``).

The reference takes, for each prompt, the *penultimate* hidden state of both
SDXL text encoders concatenated on the feature axis, plus the pooled,
projected embedding of the second encoder. Modifier tokens are appended to
both tokenizers and their embedding rows set from the concept checkpoint.

Module and parameter names are those of the HF ``CLIPTextModel`` /
``CLIPTextModelWithProjection`` checkpoints
(``text_model.encoder.layers.0.self_attn.q_proj.weight``), so a checkpoint
loads without renaming; so are the vision tower's (HF ``CLIPVisionModel`` /
``CLIPVisionModelWithProjection``: ``vision_model.embeddings.patch_embedding``,
``vision_model.pre_layrnorm``, ``visual_projection``). The towers' attention
over 77 (text) or 257 (ViT-H/14 image) tokens is plain torch math, as it is
plain ``einsum``/softmax in the JAX package: scores in fp32, masked with the
fp32 minimum where the tower is causal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tweediemix_tpu_torch.device import resolve_device

# CLIP image-preprocessing statistics (CLIPImageProcessor defaults)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    hidden_act: str = "quick_gelu"
    projection_dim: Optional[int] = None
    eos_token_id: int = 49407
    dtype: torch.dtype = torch.float32
    # not ported yet: rematerialisation for --train_text_encoder raises when set
    remat: bool = False

    def __post_init__(self):
        if self.remat:
            raise NotImplementedError("CLIPTextConfig.remat (training) is not ported to the torch package yet")
        if self.hidden_act not in ("quick_gelu", "gelu"):
            raise ValueError(f"unknown hidden_act {self.hidden_act!r}")

    @staticmethod
    def sdxl_text_encoder(**kw) -> "CLIPTextConfig":
        """CLIP ViT-L/14 text tower (SDXL text_encoder)."""
        return CLIPTextConfig(**kw)

    @staticmethod
    def sdxl_text_encoder_2(**kw) -> "CLIPTextConfig":
        """OpenCLIP bigG text tower (SDXL text_encoder_2, with projection)."""
        defaults = dict(
            hidden_size=1280, intermediate_size=5120, num_layers=32,
            num_heads=20, hidden_act="gelu", projection_dim=1280,
        )
        defaults.update(kw)
        return CLIPTextConfig(**defaults)

    @staticmethod
    def i2vgen_text_encoder(**kw) -> "CLIPTextConfig":
        """OpenCLIP ViT-H/14 text tower (ali-vilab/i2vgen-xl text_encoder)."""
        defaults = dict(
            hidden_size=1024, intermediate_size=4096, num_layers=24,
            num_heads=16, hidden_act="gelu",
        )
        defaults.update(kw)
        return CLIPTextConfig(**defaults)

    @staticmethod
    def tiny(**kw) -> "CLIPTextConfig":
        defaults = dict(
            vocab_size=1000, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=2, max_positions=77, eos_token_id=999,
        )
        defaults.update(kw)
        return CLIPTextConfig(**defaults)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)  # exact (erf) GELU


class CLIPAttention(nn.Module):
    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, causal: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Self-attention over [B, T, D]; ``causal`` [T, T] (True = attend)
        masks the scores, None attends everywhere (the vision towers)."""
        b, t, d = x.shape
        hd = d // self.num_heads

        def split(a):
            return a.reshape(b, t, self.num_heads, hd).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd**-0.5)
        if causal is not None:
            s = s.masked_fill(~causal, torch.finfo(torch.float32).min)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.matmul(p, v).transpose(1, 2).reshape(b, t, d)
        return self.out_proj(o)


class CLIPMLP(nn.Module):
    def __init__(self, d: int, hidden: int, act: str):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)

    def forward(self, x):
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """One pre-LN transformer layer; ``cfg`` is a ``CLIPTextConfig`` or a
    ``CLIPVisionConfig`` (hidden_size, num_heads, intermediate_size,
    hidden_act)."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(d, eps=1e-5)
        self.self_attn = CLIPAttention(d, cfg.num_heads)
        self.layer_norm2 = nn.LayerNorm(d, eps=1e-5)
        self.mlp = CLIPMLP(d, cfg.intermediate_size, cfg.hidden_act)

    def forward(self, x, causal=None):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden_size)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    """forward(input_ids [B, T]) → (penultimate_hidden, final_hidden, pooled,
    penultimate_ln).

    ``penultimate_hidden`` is the input of the last layer without the final
    LayerNorm (HF's ``hidden_states[-2]``, SDXL's prompt embedding).
    ``pooled`` is the final-LN hidden at the *first* position equal to
    ``eos_token_id`` (0 where a row has none), projected by
    ``text_projection`` (no bias) when ``projection_dim`` is set.
    ``penultimate_ln`` is ``final_layer_norm(hidden_states[-2])`` (the
    I2VGen-XL prompt embedding). Parameters are created on ``device`` in
    ``config.dtype``.
    """

    def __init__(self, config: CLIPTextConfig, device="cuda"):
        super().__init__()
        self.config = cfg = config
        with torch.device(resolve_device(device)):
            self.text_model = CLIPTextTransformer(cfg)
            if cfg.projection_dim is not None:
                self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)
        self.to(cfg.dtype)

    def forward(self, input_ids: torch.Tensor):
        cfg = self.config
        tm = self.text_model
        b, t = input_ids.shape
        pos = tm.embeddings.position_embedding.weight[:t]
        x = tm.embeddings.token_embedding(input_ids) + pos
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        penultimate = x
        for i, layer in enumerate(tm.encoder.layers):
            if i == cfg.num_layers - 1:
                penultimate = x
            x = layer(x, causal)
        final = tm.final_layer_norm(x)
        penultimate_ln = tm.final_layer_norm(penultimate)
        # the first EOS: the count of positions before it (t where there is none)
        before = (input_ids != cfg.eos_token_id).long().cumprod(dim=1).sum(dim=1)
        eos_pos = torch.where(before < t, before, torch.zeros_like(before))
        pooled = final[torch.arange(b, device=x.device), eos_pos]
        if cfg.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return penultimate, final, pooled, penultimate_ln


# ---------------------------------------------------------------------------
# the vision tower


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    hidden_act: str = "quick_gelu"
    projection_dim: Optional[int] = 1024
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.hidden_act not in ("quick_gelu", "gelu"):
            raise ValueError(f"unknown hidden_act {self.hidden_act!r}")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def vit_h(**kw) -> "CLIPVisionConfig":
        """OpenCLIP ViT-H/14 image tower (ali-vilab/i2vgen-xl image_encoder)."""
        defaults = dict(hidden_size=1280, intermediate_size=5120,
                        num_layers=32, num_heads=16, patch_size=14,
                        hidden_act="gelu", projection_dim=1024)
        defaults.update(kw)
        return CLIPVisionConfig(**defaults)

    @staticmethod
    def tiny(**kw) -> "CLIPVisionConfig":
        defaults = dict(image_size=32, patch_size=8, hidden_size=32,
                        intermediate_size=64, num_layers=2, num_heads=2,
                        projection_dim=32)
        defaults.update(kw)
        return CLIPVisionConfig(**defaults)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, d)
        nn.init.normal_(self.class_embedding, std=0.02)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] → [B, 1 + patches, D]: the class token, then the
        patches in row-major order, plus the position embeddings."""
        x = self.patch_embedding(pixels.permute(0, 3, 1, 2).to(self.patch_embedding.weight.dtype))
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight.to(x.dtype)


class CLIPVisionTransformer(nn.Module):
    """The CLIP ViT: embeddings, a pre-LayerNorm (HF's ``pre_layrnorm``;
    OWL-ViT names it ``pre_layernorm``), the non-causal encoder and the
    post-LayerNorm; ``forward`` returns the post-LayerNormed sequence
    [B, 1 + patches, D] (class token first)."""

    def __init__(self, cfg: CLIPVisionConfig, pre_norm: str = "pre_layrnorm"):
        super().__init__()
        self.pre_norm = pre_norm
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.add_module(pre_norm, nn.LayerNorm(cfg.hidden_size, eps=1e-5))
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = getattr(self, self.pre_norm)(self.embeddings(pixels))
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x)


class CLIPVisionModel(nn.Module):
    """CLIP image tower → projected image embedding: forward(pixels
    [B, H, W, 3], normalised with ``CLIP_IMAGE_MEAN``/``CLIP_IMAGE_STD``) →
    the post-LayerNormed class token through ``visual_projection`` (no
    bias) when ``projection_dim`` is set, [B, projection_dim] (the
    I2VGen-XL image embedding). Parameters are created on ``device`` in
    ``config.dtype``."""

    def __init__(self, config: CLIPVisionConfig, device="cuda"):
        super().__init__()
        self.config = cfg = config
        with torch.device(resolve_device(device)):
            self.vision_model = CLIPVisionTransformer(cfg)
            if cfg.projection_dim is not None:
                self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)
        self.to(cfg.dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        pooled = self.vision_model(pixels)[:, 0]
        if self.config.projection_dim is not None:
            pooled = self.visual_projection(pooled)
        return pooled


# ---------------------------------------------------------------------------
# modifier-token embedding surgery (in place on a CLIPTextModel)


def _token_table(model: CLIPTextModel) -> nn.Embedding:
    return model.text_model.embeddings.token_embedding


def resize_token_embeddings(model: CLIPTextModel, new_vocab_size: int,
                            generator: Optional[torch.Generator] = None) -> CLIPTextModel:
    """Grow the token-embedding table to ``new_vocab_size`` rows: new rows
    are 0.01·N(0, 1) drawn from ``generator`` (on the table's device), or
    zeros without one. A table that is already large enough (a
    ``--train_text_encoder`` tower saved with its modifier rows) is left
    as it is."""
    emb = _token_table(model)
    old, d = emb.weight.shape
    if new_vocab_size > old:
        w = emb.weight.detach()
        if generator is not None:
            extra = 0.01 * torch.randn(new_vocab_size - old, d, generator=generator,
                                       device=w.device, dtype=torch.float32)
        else:
            extra = torch.zeros(new_vocab_size - old, d, device=w.device)
        grown = nn.Embedding(new_vocab_size, d, device=w.device, dtype=w.dtype)
        with torch.no_grad():
            grown.weight.copy_(torch.cat([w, extra.to(w.dtype)]))
        model.text_model.embeddings.token_embedding = grown
        model.config = dataclasses.replace(model.config, vocab_size=new_vocab_size)
    return model


@torch.no_grad()
def set_token_embedding_rows(model: CLIPTextModel, rows: dict) -> CLIPTextModel:
    """Overwrite embedding rows {token_id: vector}."""
    w = _token_table(model).weight
    for tid, vec in rows.items():
        w[int(tid)] = torch.as_tensor(vec, dtype=torch.float32).to(w.device, w.dtype)
    return model


def nearest_tokens(embed, embedding_table, top_k: int = 1):
    """Dot-score nearest vocabulary rows for an embedding (the reference's
    ``find_disc`` probe). Returns (ids [top_k], scores [top_k])."""
    table = torch.as_tensor(embedding_table).float()
    scores = table @ torch.as_tensor(embed).float().to(table.device)
    top = torch.topk(scores, top_k)
    return top.indices, top.values


# ---------------------------------------------------------------------------
# the dual-encoder SDXL text stack


class DualTextEncoder:
    """SDXL prompt encoding: the penultimate hidden states of both towers
    concatenated on the feature axis, plus tower 2's pooled projection."""

    def __init__(self, model1: CLIPTextModel, model2: CLIPTextModel):
        self.model1 = model1.eval()
        self.model2 = model2.eval()

    @property
    def device(self) -> torch.device:
        return _token_table(self.model1).weight.device

    @torch.inference_mode()
    def encode_ids(self, ids1, ids2):
        """[B, 77] token ids per tokenizer → (ctx [B, 77, d1+d2], pooled
        [B, proj2]), in the towers' dtype on their device."""
        ids1 = torch.as_tensor(ids1, dtype=torch.long).to(self.device)
        ids2 = torch.as_tensor(ids2, dtype=torch.long).to(self.device)
        pen1 = self.model1(ids1)[0]
        pen2, _, pooled2, _ = self.model2(ids2)
        return torch.cat([pen1, pen2], dim=-1), pooled2

    def load_tower_state(self, state1=None, state2=None):
        """Replace whole towers' weights with HF-named state dicts (the
        ``text_encoder``/``text_encoder_2`` entries of a
        ``--train_text_encoder`` checkpoint). A saved table that already
        holds modifier rows sets the tower's vocabulary size."""
        for model, state in ((self.model1, state1), (self.model2, state2)):
            if state is None:
                continue
            vocab = state["text_model.embeddings.token_embedding.weight"].shape[0]
            table = _token_table(model)
            if vocab != table.weight.shape[0]:
                model.text_model.embeddings.token_embedding = nn.Embedding(
                    vocab, table.weight.shape[1], device=table.weight.device,
                    dtype=table.weight.dtype)
                model.config = dataclasses.replace(model.config, vocab_size=vocab)
            state = {k: v for k, v in state.items() if not k.endswith("position_ids")}
            model.load_state_dict(state)

    def add_modifier_tokens(self, token_ids_1: Sequence[int], embeds_1,
                            token_ids_2: Sequence[int], embeds_2):
        """Grow both towers' embedding tables with zero rows to fit the new
        ids, then set the modifier rows."""
        for model, ids, embeds in ((self.model1, token_ids_1, embeds_1),
                                   (self.model2, token_ids_2, embeds_2)):
            new_size = max(model.config.vocab_size, max(ids) + 1)
            resize_token_embeddings(model, new_size)
            set_token_embedding_rows(model, dict(zip(ids, embeds)))
