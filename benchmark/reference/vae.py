"""Plain AutoencoderKL (diffusers' layout, as configured by
``stabilityai/stable-diffusion-xl-base-1.0/vae/config.json`` and the
I2VGen-XL ``vae/config.json``) in fp32: the encoder for a video's first
frame, the decoder for every image and frame. Inputs and outputs are NHWC.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.ops import Conv, GroupNorm, Linear, softmax_attention


class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, 1e-6)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(groups, cout, 1e-6)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (self.conv_shortcut(x) if self.conv_shortcut is not None else x.float()) + h


class MidAttention(nn.Module):
    """Single-head self-attention over every pixel."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, 1e-6)
        self.to_q, self.to_k, self.to_v = Linear(ch, ch), Linear(ch, ch), Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        out = softmax_attention(self.to_q(y), self.to_k(y), self.to_v(y), c**-0.5)
        return self.to_out[0](out).reshape(b, h, w, c).permute(0, 3, 1, 2) + x.float()


class Mid(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(ch, ch, groups), Resnet(ch, ch, groups)])
        self.attentions = nn.ModuleList([MidAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Stage(nn.Module):
    def __init__(self, resnets, down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if down is not None:
            self.downsamplers = nn.ModuleList(down)
        if up is not None:
            self.upsamplers = nn.ModuleList(up)


class Sampler(nn.Module):
    def __init__(self, ch: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = Conv(ch, ch, 3, stride=2 if down else 1, padding=0 if down else 1)

    def forward(self, x):
        if self.down:  # diffusers' asymmetric (0, 1) padding
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Encoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        chs, g, lpb = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["layers_per_block"]
        self.conv_in = Conv(cfg["in_channels"], chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cin = chs[0]
        for i, ch in enumerate(chs):
            res = []
            for _ in range(lpb):
                res.append(Resnet(cin, ch, g))
                cin = ch
            self.down_blocks.append(Stage(res, down=[Sampler(ch, True)] if i < len(chs) - 1 else []))
        self.mid_block = Mid(chs[-1], g)
        self.conv_norm_out = GroupNorm(g, chs[-1], 1e-6)
        self.conv_out = Conv(chs[-1], 2 * cfg["latent_channels"], 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for stage in self.down_blocks:
            for r in stage.resnets:
                x = r(x)
            for d in stage.downsamplers:
                x = d(x)
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(x))))


class Decoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        rev, g, lpb = list(reversed(cfg["block_out_channels"])), cfg["norm_num_groups"], cfg["layers_per_block"]
        self.conv_in = Conv(cfg["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = Mid(rev[0], g)
        self.up_blocks = nn.ModuleList()
        cin = rev[0]
        for i, ch in enumerate(rev):
            res = []
            for _ in range(lpb + 1):
                res.append(Resnet(cin, ch, g))
                cin = ch
            self.up_blocks.append(Stage(res, up=[Sampler(ch, False)] if i < len(rev) - 1 else []))
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6)
        self.conv_out = Conv(rev[-1], cfg["out_channels"], 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for stage in self.up_blocks:
            for r in stage.resnets:
                x = r(x)
            for u in stage.upsamplers:
                x = u(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAE(nn.Module):
    """``cfg``: the configuration file's ``vae`` object (diffusers' keys)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        lc = cfg["latent_channels"]
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv(2 * lc, 2 * lc, 1)
        self.post_quant_conv = Conv(lc, lc, 1)

    def encode_sample(self, image: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """[B,H,W,3] in [-1,1] and standard-normal ``noise`` [B,h,w,4] ->
        the scaled posterior sample mean + exp(logvar/2) noise, logvar
        clipped to [-30, 20], times ``scaling_factor``."""
        m = self.quant_conv(self.encoder(image.float().permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        mean, logvar = m.chunk(2, dim=-1)
        z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise.float()
        return z * self.cfg["scaling_factor"]

    def decode_image(self, latent: torch.Tensor) -> torch.Tensor:
        """A diffusion latent [B,h,w,4] -> an image [B,H,W,3] in [0, 1]:
        divided by ``scaling_factor``, decoded, mapped from [-1, 1] and
        clamped."""
        z = latent.float() / self.cfg["scaling_factor"]
        img = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        return torch.clamp(img / 2 + 0.5, 0.0, 1.0)
