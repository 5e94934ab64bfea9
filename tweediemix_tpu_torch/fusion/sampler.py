"""Multi-concept Tweedie fusion sampling (counterpart of
``tweediemix_tpu/fusion/sampler.py``; the jitted scans become Python loops).

* Prologue (step 0): a batch-(N+1) forward and the resampling loop
  (composed Tweedie ``(N-1)·x0_multi − Σ x0_single``, re-noise to the next
  t with the unconditional eps, one joint forward there, Tweedie back up).
* Joint: batch-2 [uncond, multi-concept] CFG steps up to ``t_cond``.
* Jumping: joint forwards marching ``t −= jump_stride`` for a clean Tweedie
  preview, from which the region masks come (or from precomputed masks).
* Fused: batch-(N+1) [uncond, concept_1..N] forwards where ``concept_idx``
  selects the stacked K/V (or LoRA) slot per row; per-concept CFG; fused
  Tweedie ``x0 = Σ mask_c ⊙ x0_c``; re-noise with the unconditional eps.
  The final step returns the Tweedie itself.

``x`` carries a leading seed axis [S, h, w, 4]; UNet row k*S+s pairs
embedding row k with seed s. Each phase builds its cross-attention K/V
cache once, outside its loop, where its ``kv_builder`` gives one (the
pipeline's gives none on a card, where the UNet call's CUDA graph builds
the K/V inside, ``models/unet_graph.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tweediemix_tpu_torch.device import resolve_device
from tweediemix_tpu_torch.fusion.masks import build_region_masks
from tweediemix_tpu_torch.schedulers.ddim import DDIMTable, cfg as cfg_combine
from tweediemix_tpu_torch.utils.profiling import phase, span


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Sampling hyperparameters (flag parity with the reference's
    fusion_sampling.py)."""

    n_timesteps: int = 50
    guidance_scale: float = 0.8
    t_cond: float = 0.2
    t_stop: float = 1.0  # fusion-window end fraction; 1.0 = fuse to the end (CD)
    resampling_steps: int = 10
    jumping_steps: int = 5
    jump_stride: int = 150
    height: int = 1024
    width: int = 1024
    num_concepts: int = 3  # N, including the background concept (last)

    @property
    def latent_hw(self):
        return self.height // 8, self.width // 8

    @property
    def t_cond_idx(self) -> int:
        return int(self.n_timesteps * self.t_cond)

    @property
    def fused_end_idx(self) -> int:
        """Last fused step index (inclusive)."""
        return min(int(self.n_timesteps * self.t_stop), self.n_timesteps - 1)

    def unet_calls(self) -> int:
        """UNet forwards in one trajectory."""
        prologue = 1 + 2 * self.resampling_steps
        joint = (self.t_cond_idx - 1) + (self.n_timesteps - 1 - self.fused_end_idx)
        fused = self.fused_end_idx + 1 - self.t_cond_idx
        return prologue + joint + self.jumping_steps + fused


class TextEmbeds(NamedTuple):
    """Precomputed prompt embeddings, row layouts fixed per phase.

    joint:   [2, T, D] = [uncond, multi-concept prompt]
    single:  [N-1, T, D] = per-concept single prompts (no background)
    concept: [N+1, T, D] = [uncond, concept_1 .. concept_N]
    (each with matching pooled [., P]). A leaf may carry a per-seed axis at
    position 1 ([K, S, T, D] / [K, S, P]).
    """

    joint_ctx: torch.Tensor
    joint_pooled: torch.Tensor
    single_ctx: torch.Tensor
    single_pooled: torch.Tensor
    concept_ctx: torch.Tensor
    concept_pooled: torch.Tensor


def _rows(a: torch.Tensor, s: int, base_ndim: int) -> torch.Tensor:
    """Embed-major/seed-minor UNet rows (row k*S+s = embed k, seed s)."""
    if a.ndim == base_ndim:
        return torch.repeat_interleave(a, s, dim=0)
    if a.ndim != base_ndim + 1 or a.shape[1] != s:
        raise ValueError(f"per-seed embeds of shape {tuple(a.shape)} do not match {s} seeds")
    return a.reshape(a.shape[0] * s, *a.shape[2:])


# unet_fn: (x [B,h,w,4] fp32, t int, ctx [B,S,D], pooled [B,P], concept_idx
# [B], cross_kv=None) -> eps [B,h,w,4] fp32
UNetFn = Callable[..., torch.Tensor]


def row_seed(seed: int, row: int) -> int:
    """Generator seed of seed-row ``row``: independent of the batch size."""
    return int(np.random.SeedSequence([seed, row]).generate_state(1, np.uint64)[0] >> 1)


def step_span(phase_name: str, step: int, t: int, rows: int):
    """The span of one sampler iteration: its UNet call and the update
    around it."""
    return span("fusion.step", phase=phase_name, step=step, t=t, rows=rows)


class FusionSampler:
    def __init__(
        self,
        table: DDIMTable,
        config: FusionConfig,
        unet_fn: UNetFn,
        decode_preview_fn: Optional[Callable] = None,
        segment_fn: Optional[Callable] = None,
        kv_builder: Optional[Callable] = None,
    ):
        if table.n_steps != config.n_timesteps:
            raise ValueError(f"table has {table.n_steps} steps, config {config.n_timesteps}")
        if not 1 <= config.t_cond_idx < config.n_timesteps:
            raise ValueError(f"t_cond index {config.t_cond_idx} outside [1, {config.n_timesteps})")
        self.table = table
        self.config = config
        self.unet_fn = unet_fn
        self.decode_preview_fn = decode_preview_fn
        self.segment_fn = segment_fn
        # optional (ctx_rows, concept_idx) -> cross-attention K/V cache
        # (models.unet2d.precompute_cross_kv) or None, built once per phase
        self.kv_builder = kv_builder
        # wall seconds of each phase of the last run(), device work included
        self.phase_seconds: dict[str, float] = {}

    # -- helpers -----------------------------------------------------------

    def _call_unet(self, xin, t, ctx, pooled, idx, kv):
        if kv is None:
            return self.unet_fn(xin, t, ctx, pooled, idx)
        return self.unet_fn(xin, t, ctx, pooled, idx, cross_kv=kv)

    def _joint_rows(self, embeds: TextEmbeds, s: int):
        ctx = _rows(embeds.joint_ctx, s, 3)
        return ctx, _rows(embeds.joint_pooled, s, 2), torch.zeros(
            2 * s, dtype=torch.long, device=ctx.device)

    def _joint_kv(self, embeds: TextEmbeds, s: int):
        if self.kv_builder is None:
            return None
        ctx, _, idx = self._joint_rows(embeds, s)
        return self.kv_builder(ctx, idx)

    def _joint_eps(self, embeds: TextEmbeds, x, t, kv=None):
        s = x.shape[0]
        ctx, pooled, idx = self._joint_rows(embeds, s)
        eps = self._call_unet(torch.cat([x, x], dim=0), t, ctx, pooled, idx, kv)
        return eps[:s], eps[s:]

    def _prologue_rows(self, embeds: TextEmbeds, s: int):
        n = self.config.num_concepts
        ctx = torch.cat([_rows(embeds.joint_ctx, s, 3), _rows(embeds.single_ctx, s, 3)], dim=0)
        pooled = torch.cat(
            [_rows(embeds.joint_pooled, s, 2), _rows(embeds.single_pooled, s, 2)], dim=0)
        return ctx, pooled, torch.zeros((n + 1) * s, dtype=torch.long, device=ctx.device)

    def _prologue_eps(self, embeds: TextEmbeds, x, t, kv=None):
        n = self.config.num_concepts
        ctx, pooled, idx = self._prologue_rows(embeds, x.shape[0])
        return self._call_unet(torch.cat([x] * (n + 1), dim=0), t, ctx, pooled, idx, kv)

    # -- phases ------------------------------------------------------------

    def prologue(self, embeds: TextEmbeds, x):
        """Step 0: batch-(N+1) forward + resampling. Returns (x, x0)."""
        cfg, tbl = self.config, self.table
        g, n = cfg.guidance_scale, cfg.num_concepts
        t = int(tbl.timesteps[0])
        at, at_next = tbl.alpha(t), tbl.alpha(t - tbl.skip)
        s = x.shape[0]
        kv_pro = kv_joint = None
        if self.kv_builder is not None:
            pctx, _, pidx = self._prologue_rows(embeds, s)
            kv_pro = self.kv_builder(pctx, pidx)
            kv_joint = self._joint_kv(embeds, s)

        with step_span("prologue", 0, t, (n + 1) * s):
            eps = self._prologue_eps(embeds, x, t, kv=kv_pro)
        for _ in range(cfg.resampling_steps):
            with step_span("resampling", 0, t - tbl.skip, 2 * s):
                eps_u = eps[:s]
                eps_m = cfg_combine(eps_u, eps[s : 2 * s], g)
                x0 = (n - 1) * tbl.tweedie(x, eps_m, at)
                for cc in range(n - 1):
                    eps_s = cfg_combine(eps_u, eps[(2 + cc) * s : (3 + cc) * s], g)
                    x0 = x0 - tbl.tweedie(x, eps_s, at)
                x_next = tbl.renoise(x0, eps_u, at_next)
                eu2, ec2 = self._joint_eps(embeds, x_next, t - tbl.skip, kv=kv_joint)
                x0_next = tbl.tweedie(x_next, cfg_combine(eu2, ec2, g), at_next)
                x = tbl.renoise(x0_next, eu2, at)  # back up to t with the uncond eps
            with step_span("prologue", 0, t, (n + 1) * s):
                eps = self._prologue_eps(embeds, x, t, kv=kv_pro)

        eps_u = eps[:s]
        x0 = tbl.tweedie(x, cfg_combine(eps_u, eps[s : 2 * s], g), at)
        return tbl.renoise(x0, eps_u, at_next), x0

    def joint_scan(self, embeds: TextEmbeds, x, start: int, stop: int):
        """Joint CFG steps for indices [start, stop); returns (x, last x0).
        The trajectory's final step returns the Tweedie instead of
        re-noising."""
        cfg, tbl = self.config, self.table
        if stop <= start:
            return x, None
        kv = self._joint_kv(embeds, x.shape[0])
        x0 = None
        for i in range(start, stop):
            t = int(tbl.timesteps[i])
            with step_span("joint", i, t, 2 * x.shape[0]):
                eps_u, eps_c = self._joint_eps(embeds, x, t, kv=kv)
                x0 = tbl.tweedie(x, cfg_combine(eps_u, eps_c, cfg.guidance_scale), tbl.alpha(t))
                if i == cfg.n_timesteps - 1:
                    x = x0
                else:
                    x = tbl.renoise(x0, eps_u, tbl.alpha(t - tbl.skip))
        return x, x0

    def jumping(self, embeds: TextEmbeds, x):
        """Jumping Tweedie preview: from the latent after the boundary step,
        march joint forwards with t -= jump_stride; return the last x0."""
        cfg, tbl = self.config, self.table
        t0 = int(tbl.timesteps[cfg.t_cond_idx])
        kv = self._joint_kv(embeds, x.shape[0])
        x0 = torch.zeros_like(x)
        for j in range(cfg.jumping_steps):
            tt = t0 - j * cfg.jump_stride
            with step_span("jumping", j, tt, 2 * x.shape[0]):
                eps_u, eps_c = self._joint_eps(embeds, x, tt, kv=kv)
                x0 = tbl.tweedie(x, cfg_combine(eps_u, eps_c, cfg.guidance_scale), tbl.alpha(tt))
                x = tbl.renoise(x0, eps_u, tbl.alpha(tt - cfg.jump_stride))
        return x0

    def fused_scan(self, embeds: TextEmbeds, x, masks, start: int, stop: int):
        """Masked Tweedie fusion steps for indices [start, stop).
        masks: [N, h, w] (shared) or [S, N, h, w] (per seed), background
        last."""
        cfg, tbl = self.config, self.table
        n = cfg.num_concepts
        if stop <= start:
            return x
        s = x.shape[0]
        concept_idx = torch.repeat_interleave(
            torch.arange(n + 1, dtype=torch.long, device=x.device), s)
        m = masks[:, None, :, :, None] if masks.ndim == 3 else masks.permute(1, 0, 2, 3)[..., None]
        m = m.to(x.dtype)
        ctx_rows = _rows(embeds.concept_ctx, s, 3)
        pooled_rows = _rows(embeds.concept_pooled, s, 2)
        kv = None if self.kv_builder is None else self.kv_builder(ctx_rows, concept_idx)
        for i in range(start, stop):
            t = int(tbl.timesteps[i])
            with step_span("fused", i, t, (n + 1) * s):
                eps = self._call_unet(torch.cat([x] * (n + 1), dim=0), t, ctx_rows, pooled_rows,
                                      concept_idx, kv)
                eps_u = eps[:s]
                eps_cc = cfg_combine(eps_u, eps[s:].reshape(n, s, *x.shape[1:]),
                                     cfg.guidance_scale)
                x0 = (m * tbl.tweedie(x[None], eps_cc, tbl.alpha(t))).sum(dim=0)
                x = (x0 if i == cfg.n_timesteps - 1
                     else tbl.renoise(x0, eps_u, tbl.alpha(t - tbl.skip)))
        return x

    # -- end to end ---------------------------------------------------------

    def init_latent(self, seed: int, num_seeds: int = 1, device="cuda"):
        """[S, h, w, 4] standard normal; row s comes from its own generator,
        so it is the same whatever the batch size."""
        h, w = self.config.latent_hw
        device = resolve_device(device)
        rows = []
        for si in range(num_seeds):
            gen = torch.Generator(device=device).manual_seed(row_seed(seed, si))
            rows.append(torch.randn((h, w, 4), generator=gen, device=device))
        return torch.stack(rows) * self.table.init_noise_sigma

    def run(self, embeds: TextEmbeds, seed: int = 0, fg_masks=None, num_seeds: int = 1,
            x_init: Optional[torch.Tensor] = None):
        """Full trajectory; returns the final latent x0 [S, h, w, 4] (before
        the VAE decode). ``fg_masks`` (image-resolution [N-1, H, W]) skips the
        in-loop segmentation; ``x_init`` overrides the initial latent."""
        cfg = self.config
        device = embeds.joint_ctx.device
        self.phase_seconds = secs = {}
        with phase(secs, "prologue", device):
            x = self.init_latent(seed, num_seeds, device) if x_init is None else x_init
            x, x0 = self.prologue(embeds, x)
        with phase(secs, "joint", device):
            x, x0_last = self.joint_scan(embeds, x, start=1, stop=cfg.t_cond_idx)
            if x0_last is None:
                x0_last = x0
        with phase(secs, "jumping", device):
            preview_x0 = self.jumping(embeds, x) if cfg.jumping_steps > 0 else x0_last
        with phase(secs, "fused", device):
            masks = self.compute_masks(preview_x0, fg_masks)
            x = self.fused_scan(embeds, x, masks, start=cfg.t_cond_idx, stop=cfg.fused_end_idx + 1)
            if cfg.fused_end_idx + 1 < cfg.n_timesteps:
                # LoRA t_stop tail: back to joint CFG
                x, _ = self.joint_scan(embeds, x, start=cfg.fused_end_idx + 1, stop=cfg.n_timesteps)
        return x

    def compute_masks(self, preview_x0, fg_masks):
        """Region masks: [N, h, w] shared across seeds (precomputed path) or
        [S, N, h, w] per seed (segmentation of each seed's preview)."""
        cfg = self.config
        h, w = cfg.latent_hw
        if fg_masks is not None:
            fg_masks = torch.as_tensor(fg_masks, device=preview_x0.device)
            if fg_masks.shape[0] != cfg.num_concepts - 1:
                raise ValueError(f"{fg_masks.shape[0]} fg masks for {cfg.num_concepts} concepts")
            return build_region_masks(fg_masks, h, w)
        if self.decode_preview_fn is None or self.segment_fn is None:
            raise ValueError("no fg_masks supplied and no decode/segment fns configured")
        per_seed = []
        for si in range(preview_x0.shape[0]):
            with span("preview", seed_row=si):
                preview_img = self.decode_preview_fn(preview_x0[si : si + 1])
            with span("segment", seed_row=si):
                fg = torch.as_tensor(self.segment_fn(preview_img), device=preview_x0.device)
            if fg.shape[0] != cfg.num_concepts - 1:
                raise ValueError(f"segment_fn gave {fg.shape[0]} masks for {cfg.num_concepts} concepts")
            per_seed.append(build_region_masks(fg, h, w))
        masks = torch.stack(per_seed)
        return masks[0] if masks.shape[0] == 1 else masks
