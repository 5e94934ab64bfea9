"""Multi-concept fusion pipeline: embeddings → sampler → VAE decode
(counterpart of the sampling half of ``tweediemix_tpu/fusion/pipeline.py``).

The pipeline is built from a UNet and a VAE that already hold their weights
(random ones from ``from_random_weights``, or converted from the JAX
package's parameter trees by ``models.convert``) and samples from
precomputed text embeddings. Prompt encoding and concept-checkpoint loading
come with the text-encoder slice.

Numerics: the reference decodes in fp32. cuDNN would run fp32 convolutions
in TF32 by default, so the pipeline turns TF32 off for matmuls
(``torch.backends.cuda.matmul.allow_tf32 = False``) and convolutions
(``torch.backends.cudnn.allow_tf32 = False``) in this process.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from tweediemix_tpu_torch.device import resolve_device
from tweediemix_tpu_torch.fusion.sampler import FusionConfig, FusionSampler, TextEmbeds
from tweediemix_tpu_torch.models.unet2d import (
    UNet2DConditionModel,
    UNetConfig,
    precompute_cross_kv,
)
from tweediemix_tpu_torch.models.vae import (
    AutoencoderKL,
    VAEConfig,
    postprocess_image,
    unscale_latents,
)
from tweediemix_tpu_torch.schedulers.ddim import DDIMTable


class TweedieMixPipeline:
    def __init__(
        self,
        unet: UNet2DConditionModel,
        vae: AutoencoderKL,
        fusion_config: FusionConfig,
        table: Optional[DDIMTable] = None,
        segment_fn=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.unet = unet.to(self.device).eval()
        self.vae = vae.to(self.device).eval()
        self.fusion_config = fusion_config
        self.table = table or DDIMTable.create(n_steps=fusion_config.n_timesteps)
        self.sampler = FusionSampler(
            self.table, fusion_config, self._unet_fn,
            decode_preview_fn=self.decode_preview, segment_fn=segment_fn,
            kv_builder=self._kv_builder,
        )
        # wall seconds of each phase of the last sample(): the sampler's
        # phases plus the final decode
        self.phase_seconds: dict[str, float] = {}
        # the final latent of the last sample(), before the decode
        self.last_latent: Optional[torch.Tensor] = None

    @classmethod
    def from_random_weights(
        cls,
        unet_config: UNetConfig,
        vae_config: VAEConfig,
        fusion_config: FusionConfig,
        seed: int = 0,
        device="cuda",
    ) -> "TweedieMixPipeline":
        """A pipeline with seeded random (non-zero) weights, for runs at
        full width before real weights are available. Under
        ``unet_config.quant`` the int8 weights are quantised from the fp32
        draw; static activation scales are then set with
        ``ops.quant.load_static_scales(pipe.unet, table)``."""
        device = resolve_device(device)
        torch.manual_seed(seed)
        unet = UNet2DConditionModel(unet_config, device=device)
        vae = AutoencoderKL(vae_config, device=device)
        return cls(unet, vae, fusion_config, device=device)

    def _unet_fn(self, x, t, ctx, pooled, idx, cross_kv=None):
        cfg = self.fusion_config
        time_ids = torch.tensor(
            [[cfg.height, cfg.width, 0, 0, cfg.height, cfg.width]],
            dtype=torch.float32, device=x.device,
        ).expand(x.shape[0], 6)
        return self.unet(x, t, ctx, pooled, time_ids, idx, cross_kv=cross_kv)

    def _kv_builder(self, ctx_rows, idx):
        return precompute_cross_kv(self.unet, ctx_rows, idx)

    @torch.inference_mode()
    def decode_preview(self, x0):
        z = unscale_latents(x0.float(), self.vae.config, preview=True)
        return postprocess_image(self.vae.decode(z))

    @torch.inference_mode()
    def decode_final(self, x):
        z = unscale_latents(x.float(), self.vae.config)
        return postprocess_image(self.vae.decode(z))

    @torch.inference_mode()
    def sample(self, embeds: TextEmbeds, seed: int = 0, fg_masks=None, num_seeds: int = 1,
               x_init: Optional[torch.Tensor] = None):
        """Run the fusion trajectory and decode each seed; returns
        [S, H, W, 3] in [0, 1]."""
        x = self.sampler.run(embeds, seed, fg_masks=fg_masks, num_seeds=num_seeds, x_init=x_init)
        t0 = time.perf_counter()
        imgs = torch.cat([self.decode_final(x[s : s + 1]) for s in range(x.shape[0])], dim=0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phase_seconds = dict(self.sampler.phase_seconds, decode=time.perf_counter() - t0)
        self.last_latent = x
        return imgs


def save_image(img: torch.Tensor, path: str):
    """[1, H, W, 3] float [0, 1] → PNG."""
    from PIL import Image

    arr = (img[0].float().cpu().numpy() * 255.0).astype(np.uint8)
    Image.fromarray(arr).save(path)
