"""Plain SAM ViT-H (segment-anything's ``build_sam_vit_h``; arXiv
2304.02643) for box prompts, and the in-loop segmentation contract that
turns its masks into the fusion sampler's region masks.

The model, under segment-anything's parameter names:

* image encoder: 16x16 patches, absolute position embeddings, blocks of
  pre-LN attention and a GELU MLP; windowed blocks attend inside 14x14
  windows of the grid zero-padded to a multiple of 14 (the padded tokens
  get ``qkv``'s bias and take part as keys), global blocks over the whole
  grid; every block adds the decomposed relative-position bias, built here
  in full ([B, q_h, q_w, k_h, k_w]) before the softmax; a conv/LayerNorm2d
  neck to ``prompt_embed_dim`` channels;
* prompt encoder: random-Fourier position encoding; a box is its two
  corners, each encoded and given its corner embedding
  (``point_embeddings.2``/``.3``); the dense prompt is ``no_mask_embed``;
* mask decoder: the two-way transformer (token self-attention, token to
  image and image to token cross-attention at ``1 / attention_downsample_rate``
  width, a ReLU MLP, a final token to image attention), 4x upscaling by two
  transposed convolutions, the hypernetwork MLPs and the IoU head.

Departures from upstream, which the configuration states:

* box prompts only: the point and mask prompts' parameters
  (``point_embeddings.0``/``.1``, ``not_a_point_embed``,
  ``mask_downscaling``) are not held;
* one mask per box, mask token 0 (upstream's ``multimask_output=False``);
* a box comes as xyxy normalised to [0, 1] and its corners are encoded
  there, without upstream's half-pixel offset;
* the two-way transformer's LayerNorms take eps 1e-6, as the
  ``facebook/sam-vit-huge`` card's configuration does (segment-anything's
  ``nn.LayerNorm`` default is 1e-5);
* the image is resized to the encoder's square, and the mask logits
  straight to the image, by ``resize`` (``jax.image.resize`` bilinear:
  antialiased when it shrinks), in place of upstream's resize of the
  longest side, padding and two resizes back; at 1024x1024 both are the
  identity and one upsampling.

The segmentation contract (the fusion sampler's ``segment_fn``): for each
phrase in order, the detector's top boxes on the image, SAM's mask logits
for each, the mask of the best box (the highest score above the
threshold, else the top one) at logit > 0; the mask's pixels are blacked
out before the next phrase; each mask becomes its filled bounding
rectangle, and two rectangles' overlap is resolved (``resolve_overlap``).

Everything is fp32 with TF32 off (``ops.tf32``); the work of the products
is counted through ``ops.counting`` (``gemm``, ``attention``, ``conv``).
Nothing here imports the measured program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops
from benchmark.reference.ops import FP32, LayerNorm, Linear

PIXEL_MEAN = (123.675, 116.28, 103.53)  # segment-anything's, on the 0-255 scale
PIXEL_STD = (58.395, 57.12, 57.375)
ENCODER_EPS = 1e-6
DECODER_EPS = 1e-6


def empty(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class Conv2d(nn.Module):
    """A convolution of NCHW in fp32, with or without a bias."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
                 bias: bool = True):
        super().__init__()
        self.weight = empty(cout, cin, kernel, kernel)
        self.bias = empty(cout) if bias else None
        self.stride, self.padding = stride, padding

    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        y = F.conv2d(x.float(), self.weight.float(), b, self.stride, self.padding)
        ops._count("conv", 2.0 * y.numel() * self.weight[0].numel())
        return y


class ConvTranspose2d(nn.Module):
    """A transposed convolution of NCHW (kernel = stride) in fp32."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.weight = empty(cin, cout, kernel, kernel)
        self.bias = empty(cout)
        self.kernel = kernel

    def forward(self, x):
        ops._count("conv", 2.0 * x.numel() * self.weight[0].numel())
        return F.conv_transpose2d(x.float(), self.weight.float(), self.bias.float(),
                                  stride=self.kernel)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of NCHW, as segment-anything writes it."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight, self.bias = empty(channels), empty(channels)
        self.eps = eps

    def forward(self, x):
        x = x.float()
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight.float()[:, None, None] * x + self.bias.float()[:, None, None]


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act):
        super().__init__()
        self.lin1, self.lin2 = Linear(dim, hidden), Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


# -- image encoder ---------------------------------------------------------------


def window_partition(x: torch.Tensor, win: int):
    """[B, H, W, C] -> ([B * windows, win, win, C], padded (H, W)): the grid
    zero-padded at its bottom and right to multiples of ``win``."""
    b, h, w, c = x.shape
    ph, pw = (win - h % win) % win, (win - w % win) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win, win, c), (hp, wp)


def window_unpartition(x: torch.Tensor, win: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // (hp * wp // win // win)
    x = x.view(b, hp // win, wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


def get_rel_pos(q_size: int, k_size: int, table: torch.Tensor) -> torch.Tensor:
    """[q_size, k_size, dim]: the table's row for each relative position
    (the table holds 2 * max(q_size, k_size) - 1 rows; no interpolation)."""
    q = torch.arange(q_size, device=table.device)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size, device=table.device)[None, :] * max(q_size / k_size, 1.0)
    idx = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
    return table[idx.long()]


def rel_pos_bias(q: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                 q_hw: Tuple[int, int], k_hw: Tuple[int, int]) -> torch.Tensor:
    """The decomposed relative-position bias in full, [B, q_h * q_w, k_h * k_w]:
    bias[(i, j), (k, l)] = q[i, j] . Rh[i, k] + q[i, j] . Rw[j, l]."""
    (qh, qw), (kh, kw) = q_hw, k_hw
    rh = get_rel_pos(qh, kh, rel_h.float())
    rw = get_rel_pos(qw, kw, rel_w.float())
    b, _, dim = q.shape
    r_q = q.reshape(b, qh, qw, dim)
    ops._count("attention", 2.0 * b * qh * qw * (kh + kw) * dim)
    bias_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    bias_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    full = bias_h[:, :, :, :, None] + bias_w[:, :, :, None, :]
    return full.reshape(b, qh * qw, kh * kw)


class EncoderAttention(nn.Module):
    def __init__(self, dim: int, heads: int, input_size: int):
        super().__init__()
        self.heads = heads
        self.qkv, self.proj = Linear(dim, 3 * dim), Linear(dim, dim)
        self.rel_pos_h = empty(2 * input_size - 1, dim // heads)
        self.rel_pos_w = empty(2 * input_size - 1, dim // heads)

    def forward(self, x):
        b, h, w, c = x.shape
        n, hd = h * w, c // self.heads
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * self.heads, n, hd).unbind(0)
        ops._count("attention", 4.0 * b * self.heads * n * n * hd)
        attn = (q * hd**-0.5) @ k.transpose(-2, -1)
        attn = attn + rel_pos_bias(q, self.rel_pos_h, self.rel_pos_w, (h, w), (h, w))
        attn = attn.softmax(dim=-1)
        out = (attn @ v).view(b, self.heads, h, w, hd).permute(0, 2, 3, 1, 4)
        return self.proj(out.reshape(b, h, w, c))


class EncoderBlock(nn.Module):
    """``window`` 0: global attention over the grid."""

    def __init__(self, dim: int, heads: int, mlp: int, window: int, grid: int):
        super().__init__()
        self.window = window
        self.norm1 = LayerNorm(dim, ENCODER_EPS)
        self.attn = EncoderAttention(dim, heads, window or grid)
        self.norm2 = LayerNorm(dim, ENCODER_EPS)
        self.mlp = MLPBlock(dim, mlp, F.gelu)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window:
            hw = x.shape[1:3]
            x, pad_hw = window_partition(x, self.window)
        x = self.attn(x)
        if self.window:
            x = window_unpartition(x, self.window, pad_hw, hw)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch)


class ImageEncoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        d, p = cfg["encoder_embed_dim"], cfg["prompt_embed_dim"]
        grid = cfg["image_size"] // cfg["vit_patch_size"]
        self.patch_embed = PatchEmbed(cfg["vit_patch_size"], d)
        self.pos_embed = empty(1, grid, grid, d)
        glob = set(cfg["encoder_global_attn_indexes"])
        self.blocks = nn.ModuleList(
            EncoderBlock(d, cfg["encoder_num_heads"], d * cfg["mlp_ratio"],
                         0 if i in glob else cfg["window_size"], grid)
            for i in range(cfg["encoder_depth"]))
        self.neck = nn.Sequential(Conv2d(d, p, 1, bias=False), LayerNorm2d(p),
                                  Conv2d(p, p, 3, padding=1, bias=False), LayerNorm2d(p))

    def forward(self, pixels):
        """[B, S, S, 3] normalised -> [B, prompt_embed_dim, g, g]."""
        x = self.patch_embed.proj(pixels.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = x + self.pos_embed.float()
        for block in self.blocks:
            x = block(x)
        return self.neck(x.permute(0, 3, 1, 2))


# -- prompt encoder and mask decoder -----------------------------------------------


class Embedding(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = empty(n, dim)


class RandomFourier(nn.Module):
    def __init__(self, feats: int):
        super().__init__()
        self.positional_encoding_gaussian_matrix = empty(2, feats)

    def forward(self, coords):
        """coords in [0, 1], [..., 2] -> [..., 2 * feats]."""
        c = (2.0 * coords.float() - 1.0) @ self.positional_encoding_gaussian_matrix.float()
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.pe_layer = RandomFourier(dim // 2)
        self.point_embeddings = nn.ModuleDict({"2": Embedding(1, dim), "3": Embedding(1, dim)})
        self.no_mask_embed = Embedding(1, dim)

    def boxes(self, boxes):
        """[N, 4] xyxy in [0, 1] -> the sparse prompt [N, 2, D]."""
        pe = self.pe_layer(boxes.reshape(-1, 2, 2))
        pe[:, 0] = pe[:, 0] + self.point_embeddings["2"].weight[0].float()
        pe[:, 1] = pe[:, 1] + self.point_embeddings["3"].weight[0].float()
        return pe

    def dense_pe(self, grid: int, device):
        """[D, g, g]: the encoding at each grid cell's centre."""
        ones = torch.ones((grid, grid), device=device)
        y = (ones.cumsum(0) - 0.5) / grid
        x = (ones.cumsum(1) - 0.5) / grid
        return self.pe_layer(torch.stack([x, y], dim=-1)).permute(2, 0, 1)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj, self.k_proj = Linear(dim, inner), Linear(dim, inner)
        self.v_proj, self.out_proj = Linear(dim, inner), Linear(inner, dim)

    def forward(self, q, k, v):
        o = ops.attention(self.q_proj(q), self.k_proj(k), self.v_proj(v), self.heads, FP32)
        return self.out_proj(o)


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp: int, downsample: int, skip_first_pe: bool):
        super().__init__()
        self.self_attn = Attention(dim, heads)
        self.norm1 = LayerNorm(dim, DECODER_EPS)
        self.cross_attn_token_to_image = Attention(dim, heads, downsample)
        self.norm2 = LayerNorm(dim, DECODER_EPS)
        self.mlp = MLPBlock(dim, mlp, F.relu)
        self.norm3 = LayerNorm(dim, DECODER_EPS)
        self.norm4 = LayerNorm(dim, DECODER_EPS)
        self.cross_attn_image_to_token = Attention(dim, heads, downsample)
        self.skip_first_pe = skip_first_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        d, heads = cfg["prompt_embed_dim"], cfg["transformer_num_heads"]
        down = cfg["attention_downsample_rate"]
        self.layers = nn.ModuleList(
            TwoWayBlock(d, heads, cfg["transformer_mlp_dim"], down, i == 0)
            for i in range(cfg["transformer_depth"]))
        self.final_attn_token_to_image = Attention(d, heads, down)
        self.norm_final_attn = LayerNorm(d, DECODER_EPS)

    def forward(self, image, image_pe, tokens):
        """image, image_pe [B, D, g, g], tokens [B, T, D] -> (tokens, image
        [B, g*g, D])."""
        keys = image.flatten(2).permute(0, 2, 1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        attn = self.final_attn_token_to_image(queries + tokens, keys + key_pe, keys)
        return self.norm_final_attn(queries + attn), keys


class MLP(nn.Module):
    def __init__(self, din: int, hidden: int, dout: int, depth: int):
        super().__init__()
        widths = [din] + [hidden] * (depth - 1) + [dout]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        d, m = cfg["prompt_embed_dim"], cfg["num_multimask_outputs"] + 1
        self.transformer = TwoWayTransformer(cfg)
        self.iou_token = Embedding(1, d)
        self.mask_tokens = Embedding(m, d)
        self.output_upscaling = nn.Sequential(
            ConvTranspose2d(d, d // 4, 2), LayerNorm2d(d // 4), nn.GELU(),
            ConvTranspose2d(d // 4, d // 8, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(d, d, d // 8, 3) for _ in range(m))
        self.iou_prediction_head = MLP(d, cfg["iou_head_hidden_dim"], m, cfg["iou_head_depth"])

    def forward(self, image, image_pe, sparse, dense):
        """image [1, D, g, g], image_pe [D, g, g], sparse [N, 2, D], dense
        [D] -> (mask logits [N, masks, 4g, 4g], iou [N, masks])."""
        m = self.mask_tokens.weight.shape[0]
        out = torch.cat([self.iou_token.weight, self.mask_tokens.weight]).float()
        tokens = torch.cat([out[None].expand(sparse.shape[0], -1, -1), sparse], dim=1)
        src = image.expand(tokens.shape[0], -1, -1, -1) + dense.float()[None, :, None, None]
        pos = image_pe[None].expand(tokens.shape[0], -1, -1, -1)
        b, c, h, w = src.shape
        hs, src = self.transformer(src, pos, tokens)
        src = src.transpose(1, 2).reshape(b, c, h, w)
        up = self.output_upscaling(src)
        hyper = torch.stack([mlp(hs[:, 1 + i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)],
                            dim=1)
        b, c, h, w = up.shape
        ops._count("gemm", 2.0 * b * m * c * h * w)
        masks = (hyper @ up.reshape(b, c, h * w)).reshape(b, -1, h, w)
        return masks, self.iou_prediction_head(hs[:, 0])


class SAM(nn.Module):
    """``cfg``: the configuration file's ``sam`` object."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoder(cfg)
        self.prompt_encoder = PromptEncoder(cfg["prompt_embed_dim"])
        self.mask_decoder = MaskDecoder(cfg)

    def encode(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(pixels)

    def decode(self, feats: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """feats [1, D, g, g], boxes [N, 4] -> mask token 0's logits [N, 4g, 4g]."""
        pe = self.prompt_encoder
        masks, _ = self.mask_decoder(feats, pe.dense_pe(feats.shape[-1], feats.device),
                                     pe.boxes(boxes), pe.no_mask_embed.weight[0])
        return masks[:, 0]


# -- the segmentation contract ------------------------------------------------------


def resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in]: ``jax.image.resize``'s linear weights, antialiased: a
    triangle kernel at half-pixel centres, widened by n_in / n_out when it
    shrinks, normalised over the inputs."""
    inv = n_in / n_out
    width = max(inv, 1.0)
    at = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * inv - 0.5
    src = torch.arange(n_in, dtype=torch.float64, device=device)
    wts = torch.clamp(1.0 - (at[:, None] - src[None, :]).abs() / width, min=0.0)
    wts = wts / wts.sum(dim=1, keepdim=True)
    return wts.float()


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The last two axes of x [..., H, W] resized to (h, w) (the same size is
    the identity)."""
    if tuple(x.shape[-2:]) == (h, w):
        return x.float()
    wh = resize_weights(x.shape[-2], h, x.device)
    ww = resize_weights(x.shape[-1], w, x.device)
    return wh @ x.float() @ ww.t()


def sam_pixels(image: torch.Tensor, size: int) -> torch.Tensor:
    """image [H, W, 3] in [0, 1] -> the encoder's input [1, S, S, 3]."""
    x = resize(image.float().permute(2, 0, 1), size, size).permute(1, 2, 0)
    mean = torch.tensor(PIXEL_MEAN, device=image.device)
    std = torch.tensor(PIXEL_STD, device=image.device)
    return ((x * 255.0 - mean) / std)[None]


def mask_logits(sam: SAM, image: torch.Tensor, boxes: torch.Tensor, feats=None):
    """(mask logits [N, H, W] of each box, resized to the image, and the
    encoder's features); ``feats`` of this image skip the encoder."""
    if feats is None:
        feats = sam.encode(sam_pixels(image, sam.cfg["image_size"]))
    h, w = image.shape[:2]
    return resize(sam.decode(feats, boxes), h, w), feats


def best_mask(logits: torch.Tensor, scores: torch.Tensor, threshold: float) -> torch.Tensor:
    """[H, W] in {0, 1}: logit > 0 of the highest-scoring box above the
    threshold, or of the top box where none is above it."""
    above = scores > threshold
    pick = scores.argmax() if not bool(above.any()) else torch.where(above, scores, -torch.inf).argmax()
    return (logits[pick] > 0).float()


def blackout(image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[H, W, C] with the mask's pixels set to 0."""
    out = image.clone()
    out[mask > 0] = 0.0
    return out


def rect_expand(mask: torch.Tensor) -> torch.Tensor:
    """The mask's filled bounding rectangle (an empty mask stays empty)."""
    out = torch.zeros_like(mask)
    ys, xs = torch.nonzero(mask > 0, as_tuple=True)
    if ys.numel():
        out[int(ys.min()):int(ys.max()) + 1, int(xs.min()):int(xs.max()) + 1] = 1.0
    return out


def resolve_overlap(r0, r1, m0, m1, containment: float = 0.8):
    """Two rectangles and their masks: inside the bounding box of the
    rectangles' overlap each keeps only its mask's pixels of the overlap,
    and concept 1 keeps none there where more than ``containment`` of
    concept 0's mask lies in the overlap."""
    overlap = ((r0 > 0) & (r1 > 0)).float()
    box = rect_expand(overlap) > 0
    if not bool(box.any()):
        return r0, r1
    o0, o1 = overlap * m0, overlap * m1
    if float(o0.sum() / m0.sum().clamp_min(1e-6)) > containment:
        o1 = torch.zeros_like(o1)
    return torch.where(box, o0, r0), torch.where(box, o1, r1)


def region_masks(masks: List[torch.Tensor]) -> torch.Tensor:
    """[N, H, W]: each phrase's mask as its rectangle, two resolved."""
    rects = [rect_expand(m) for m in masks]
    if len(rects) == 2:
        rects = list(resolve_overlap(rects[0], rects[1], masks[0], masks[1]))
    return torch.stack(rects)
