"""Class (regularisation) images for prior preservation (counterpart of
``tweediemix_tpu/training/class_gen.py``).

The reference samples ``num_class_images`` images of the class prompt with
the base SDXL pipeline when the class directory is empty. Here: a plain
text-to-image DDIM loop with classifier-free guidance (re-noised with the
guided eps, eta 0, unlike the fusion sampler), batched over seeds, and PNGs
written with the port's own writer. Everything runs under ``no_grad``, not
``inference_mode``, so no tensor it leaves behind is an inference tensor
that training could not differentiate through later.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tweediemix_tpu_torch.schedulers.ddim import DDIMTable, cfg as cfg_combine
from tweediemix_tpu_torch.utils.image import write_png


@torch.no_grad()
def text2img_scan(table: DDIMTable, unet_fn, ctx2, pooled2, x, guidance_scale: float):
    """Guided DDIM sampling: ``ctx2``/``pooled2`` rows are [uncond, cond],
    x [S, h, w, 4] the initial noise; ``unet_fn(x, t, ctx, pooled)`` →
    eps. Returns the final x0 [S, h, w, 4]."""
    s = x.shape[0]
    ctx = ctx2.repeat_interleave(s, dim=0)
    pooled = pooled2.repeat_interleave(s, dim=0)
    timesteps = [int(t) for t in table.timesteps]
    for i, t in enumerate(timesteps):
        eps = unet_fn(torch.cat([x, x]), t, ctx, pooled)
        e = cfg_combine(eps[:s], eps[s:], guidance_scale)
        x0 = table.tweedie(x, e, table.alpha(t))
        if i == len(timesteps) - 1:
            return x0
        x = table.renoise(x0, e, table.alpha(t - table.skip))
    return x


@torch.no_grad()
def generate_class_images(out_dir: str, num_images: int, prompt_ctx2, prompt_pooled2, unet_fn,
                          decode_fn, latent_hw, n_steps: int = 50, guidance_scale: float = 6.0,
                          batch: int = 4, seed: int = 0, device="cuda") -> int:
    """Write ``{i:05d}.png`` into ``out_dir`` (``decode_fn`` maps x0 to
    [n, H, W, 3] in [0, 1]); returns the count. The initial noise comes from
    a generator on ``device`` seeded with ``seed``."""
    os.makedirs(out_dir, exist_ok=True)
    table = DDIMTable.create(n_steps=n_steps)
    h, w = latent_hw
    gen = torch.Generator(device=device).manual_seed(seed)
    written = 0
    while written < num_images:
        n = min(batch, num_images - written)
        x = torch.randn((n, h, w, 4), generator=gen, device=device)
        imgs = decode_fn(text2img_scan(table, unet_fn, prompt_ctx2, prompt_pooled2, x,
                                       guidance_scale))
        pixels = (imgs.float().cpu().numpy() * 255.0).astype(np.uint8)
        for i in range(n):
            write_png(os.path.join(out_dir, f"{written + i:05d}.png"), pixels[i])
        written += n
    return written
