"""Image-to-video pipeline with first-frame feature injection (counterpart
of ``tweediemix_tpu/video/pipeline.py``; the jitted scan becomes a Python
loop).

* The conditioning image's first-frame VAE latent with the linear
  frame-position ramp; a zero image embedding for the unconditional CFG row.
* A 50-step loop with CFG 9 and the I2VGen-XL "angle rotation" DDIM step
  (``schedulers.ddim.video_rotation_step``) over the UNSHIFTED alpha table
  (unlike the fusion sampler, no 1.0 is prepended).
* First-frame injection on the first ``injection_timestep`` fraction of the
  steps: host flags, so each step's UNet call takes its own branch.
* Chunked per-frame fp32 VAE decode.

The context tokens, the projected image latents and every spatial
cross-attention's K/V run once per trajectory (``precompute_video_cache``).
``generate`` takes the text contexts and the CLIP image embedding as
tensors; ``cli/run_video.py`` encodes them from a prompt and a picture.

``generate(..., mesh_devices=n)`` shards the clips over a one-axis mesh
(``parallel/mesh.py``), the counterpart of the JAX package's
``_sharded_loop``: each device's UNet replica runs the whole loop for its
clips' interleaved rows (so each clip's CFG pair stays on one device), with
its own step-invariant cache, and the shards step in lockstep with no
communication until the final latents are gathered for the decode on the
first device.

Numerics: the VAE runs in fp32 with TF32 off for matmuls and convolutions in
this process, as in ``fusion.pipeline``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tweediemix_tpu_torch.device import resolve_device
from tweediemix_tpu_torch.fusion.sampler import row_seed
from tweediemix_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNet3DConfig,
    precompute_video_cache,
)
from tweediemix_tpu_torch.models.vae import (
    AutoencoderKL,
    VAEConfig,
    postprocess_image,
    scale_latents,
    unscale_latents,
)
from tweediemix_tpu_torch.parallel.mesh import (
    Mesh,
    as_mesh,
    gather_rows,
    on_device,
    replicate,
    run_sharded,
)
from tweediemix_tpu_torch.schedulers.ddim import cfg as cfg_combine, make_betas, video_rotation_step
from tweediemix_tpu_torch.utils.image import write_gif
from tweediemix_tpu_torch.utils.profiling import phase, span


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    """Defaults of the reference's run_video.py."""

    n_timesteps: int = 50
    guidance_scale: float = 9.0
    num_frames: int = 16
    height: int = 512
    width: int = 512
    fps: int = 8
    injection_timestep: float = 0.02  # fraction of steps with injection
    interp_ratio: float = 0.7
    decode_chunk_size: int = 1
    latent_factor: int = 8  # the VAE's spatial downscale (tiny test VAEs: 2)
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1

    @property
    def latent_hw(self):
        return self.height // self.latent_factor, self.width // self.latent_factor

    @property
    def injection_steps(self) -> int:
        return int(self.n_timesteps * self.injection_timestep)


class VideoDDIM:
    """Unshifted alpha table on the host: ``alpha(t)`` is ā_t for t >= 0 and
    ā_0 for t < 0, as a Python float of the fp32 value."""

    def __init__(self, cfg: VideoConfig):
        acp = np.cumprod(1.0 - make_betas(cfg.num_train_timesteps, cfg.beta_start, cfg.beta_end,
                                          cfg.beta_schedule))
        self.acp = acp.astype(np.float32)
        self.final_alpha_cumprod = float(self.acp[0])
        self.skip = cfg.num_train_timesteps // cfg.n_timesteps
        ts = (np.arange(cfg.n_timesteps) * self.skip).round()[::-1].astype(np.int64)
        self.timesteps = ts + cfg.steps_offset

    def alpha(self, t: int) -> float:
        t = int(t)
        if t < 0:
            return self.final_alpha_cumprod
        return float(self.acp[min(t, self.acp.shape[0] - 1)])


class I2VPipeline:
    """Image-to-video sampling from a UNet3D and a VAE that hold their
    weights. Rows of every UNet call are CLIP-INTERLEAVED: row 2i is clip
    i's unconditional row, row 2i+1 its conditional one."""

    def __init__(self, config: VideoConfig, unet: UNet3DConditionModel, vae: AutoencoderKL,
                 device="cuda"):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.table = VideoDDIM(config)
        self.unet = unet.to(self.device).eval()
        self.vae = vae.to(self.device).eval()
        # wall seconds of each phase of the last generate(): precompute
        # (first-frame encode and the step-invariant UNet cache), loop, decode
        self.phase_seconds: dict[str, float] = {}
        # the final latent [B, F, h, w, 4] of the last generate(), before the decode
        self.last_latent: Optional[torch.Tensor] = None

    @classmethod
    def from_random_weights(cls, unet_config: UNet3DConfig, vae_config: VAEConfig,
                            config: VideoConfig, seed: int = 0, device="cuda") -> "I2VPipeline":
        """A pipeline with seeded random (non-zero) weights, for runs at full
        width before real weights are available."""
        device = resolve_device(device)
        torch.manual_seed(seed)
        unet = UNet3DConditionModel(unet_config, device=device)
        vae = AutoencoderKL(vae_config, device=device)
        return cls(config, unet, vae, device=device)

    # -- conditioning -------------------------------------------------------

    def prepare_image_latents(self, frame0: torch.Tensor) -> torch.Tensor:
        """First-frame latent [B, h, w, 4] → [B, F, h, w, 4]: frame 0, then
        frames filled with the position ramp 1/(F-1), 2/(F-1), …, 1."""
        f = self.config.num_frames
        ramp = torch.tensor([(i + 1) / (f - 1) for i in range(f - 1)], dtype=frame0.dtype,
                            device=frame0.device)
        rest = torch.ones_like(frame0)[:, None] * ramp[None, :, None, None, None]
        return torch.cat([frame0[:, None], rest], dim=1)

    def posterior_noise(self, seed: int, shape, num_clips: int) -> torch.Tensor:
        """[B, *shape] standard normal for the VAE posterior sample; clip b
        from its own generator, so it is the same at any batch size."""
        return torch.stack([
            torch.randn(shape, generator=torch.Generator(device=self.device).manual_seed(
                row_seed(seed, 2 * b + 1)), device=self.device)
            for b in range(num_clips)])

    def init_latents(self, seed: int, num_clips: int) -> torch.Tensor:
        """[B, F, h, w, 4] standard normal; clip b from its own generator."""
        h, w = self.config.latent_hw
        return torch.stack([
            torch.randn((self.config.num_frames, h, w, 4), generator=torch.Generator(
                device=self.device).manual_seed(row_seed(seed, 2 * b)), device=self.device)
            for b in range(num_clips)])

    @torch.inference_mode()
    def encode_first_frame(self, image: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [-1, 1] → scaled latent [B, h, w, 4], sampled from
        the VAE posterior with the given standard-normal ``noise``."""
        mean, logvar = self.vae.encode(image.to(self.device))
        z = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
        return scale_latents(z, self.vae.config)

    # -- sampling -------------------------------------------------------------

    @torch.inference_mode()
    def loop(self, x, ctx2, image_latents2, image_emb2, fps2, cache) -> torch.Tensor:
        """The denoising trajectory from ``x`` [B, F, h, w, 4] (fp32) with
        the interleaved conditioning rows [2B, ...]; ``cache`` is
        ``precompute_video_cache``'s output for those rows. Returns the
        final latent."""
        return self._loop_shards([(self.unet, x, (ctx2, image_latents2, image_emb2, fps2),
                                   cache)])[0]

    def _loop_shards(self, shards) -> list:
        """``loop`` for several (unet, x, rows, cache) shards at once, each
        on its own device: every step runs each shard's UNet call in turn,
        so the shards' devices work side by side. Returns each shard's
        final latent."""
        cfg, tbl = self.config, self.table
        xs = [x for _, x, _, _ in shards]
        for i, t in enumerate(tbl.timesteps):
            inject = i < cfg.injection_steps
            with span("video.step", step=i, t=int(t), rows=2 * sum(x.shape[0] for x in xs),
                      inject=inject):
                for k, (unet, _, (ctx2, image_latents2, image_emb2, fps2), cache) in enumerate(
                        shards):
                    cached_ctx, cached_il, cross_kv = cache
                    x = xs[k]
                    b = x.shape[0]
                    with on_device(x.device):
                        eps = unet(x.repeat_interleave(2, dim=0), int(t), ctx2, image_latents2,
                                   image_emb2, fps2, inject, inject, cfg.interp_ratio,
                                   cached_ctx=cached_ctx, cached_il=cached_il, cross_kv=cross_kv)
                        er = eps.reshape(b, 2, *eps.shape[1:])
                        e = cfg_combine(er[:, 0], er[:, 1], cfg.guidance_scale)
                        xs[k] = video_rotation_step(x, e, tbl.alpha(t),
                                                    tbl.alpha(int(t) - tbl.skip))
        return xs

    @torch.inference_mode()
    def generate(self, text_ctx, uncond_ctx, image, image_embedding, seed: int = 0,
                 x_init: Optional[torch.Tensor] = None,
                 posterior_noise: Optional[torch.Tensor] = None,
                 mesh_devices=1) -> torch.Tensor:
        """Decoded video [F, H, W, 3] in [0, 1] (one clip) or [B, F, H, W, 3].

        ``text_ctx``/``uncond_ctx`` [1 or B, S, D] and ``image_embedding``
        [1 or B, 1, D] broadcast over the B clips of ``image`` [B, H, W, 3]
        (in [-1, 1]). Noise comes from ``seed`` (clip b's initial latent and
        VAE posterior noise from their own generators), unless ``x_init``
        [B, F, h, w, 4] and ``posterior_noise`` [B, h, w, 4] are given.
        ``mesh_devices`` > 1 (or a ``Mesh``) shards the clips over that many
        devices; B must divide over them."""
        cfg = self.config
        dev = self.device
        b = image.shape[0]
        mesh = None if mesh_devices == 1 else as_mesh(mesh_devices, dev)
        if mesh is not None and b % mesh.size:
            raise AssertionError(f"clip batch {b} must divide over {mesh.size} devices")

        def rows(a):
            a = a.to(dev)
            return a if a.shape[0] == b else a.expand(b, *a.shape[1:])

        def interleave(uncond_rows, cond_rows):
            return torch.stack([uncond_rows, cond_rows], dim=1).reshape(
                2 * b, *uncond_rows.shape[1:])

        h, w = cfg.latent_hw
        secs = {}
        with span("request", seed=seed, rows=b):
            with phase(secs, "precompute", dev):
                if posterior_noise is None:
                    posterior_noise = self.posterior_noise(seed, (h, w, 4), b)
                frame0 = self.encode_first_frame(image, posterior_noise.to(dev))
                img_lat = self.prepare_image_latents(frame0)
                img_lat2 = interleave(img_lat, img_lat)
                ctx2 = interleave(rows(uncond_ctx), rows(text_ctx))
                emb = rows(image_embedding)
                img_emb2 = interleave(torch.zeros_like(emb), emb)  # the uncond row's zero embedding
                fps2 = torch.full((2 * b,), float(cfg.fps), device=dev)
                x = self.init_latents(seed, b) if x_init is None else x_init.to(dev, torch.float32)
                if mesh is None:
                    cache = precompute_video_cache(self.unet, ctx2, img_lat2, img_emb2, fps2)
                else:
                    shards = self._shards(mesh, x, (ctx2, img_lat2, img_emb2, fps2))
            with phase(secs, "loop", dev):
                if mesh is None:
                    x = self.loop(x, ctx2, img_lat2, img_emb2, fps2, cache)
                else:
                    x = gather_rows(mesh, self._loop_shards(shards), dev)
            with phase(secs, "decode", dev):
                out = self.decode_video(x)
        self.phase_seconds = secs
        self.last_latent = x
        return out[0] if b == 1 else out

    def _shards(self, mesh: Mesh, x, rows) -> list:
        """This process's (unet, x, rows, cache) shards of the clips: shard i
        takes clips [i·B/n, (i+1)·B/n), i.e. their interleaved rows, on
        mesh device i's replica, with its own step-invariant cache."""
        per = x.shape[0] // mesh.size
        unets = replicate(mesh, self.unet)
        shards, calls = [], []
        for i in mesh.local_shards():
            device = mesh.devices[i]
            shard_rows = tuple(a[2 * i * per:2 * (i + 1) * per].to(device) for a in rows)
            shards.append((unets[i], x[i * per:(i + 1) * per].to(device), shard_rows))
            calls.append((i, (unets[i], *shard_rows)))
        caches = run_sharded(mesh, [precompute_video_cache] * mesh.size, calls)
        return [(*shard, cache) for shard, cache in zip(shards, caches)]

    @torch.inference_mode()
    def decode_video(self, latents: torch.Tensor) -> torch.Tensor:
        """[B, F, h, w, 4] → [B, F, H, W, 3] in [0, 1], decoded
        ``decode_chunk_size`` frames at a time (the last chunk takes what is
        left when the size does not divide B·F)."""
        bsz, f = latents.shape[:2]
        z = unscale_latents(latents.float(), self.vae.config).reshape(bsz * f, *latents.shape[2:])
        c = max(1, self.config.decode_chunk_size)
        out = torch.cat([postprocess_image(self.vae.decode(chunk)) for chunk in torch.split(z, c)])
        return out.reshape(bsz, f, *out.shape[1:])


def export_gif(video: torch.Tensor, path: str, fps: int = 8):
    """[F, H, W, 3] float in [0, 1] → animated GIF through the port's own
    writer (``utils.image.write_gif``, no imaging package): the frames'
    pixels truncated from ×255 as the JAX package's ``export_gif`` makes
    them, each shown ``int(1000 / fps)`` ms, looping forever."""
    arr = (video.float().cpu().numpy() * 255.0).astype(np.uint8)
    write_gif(path, arr, duration_ms=int(1000 / fps))
