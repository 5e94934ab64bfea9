"""Plain sampling loops of the two configurations, driven by a noise
predictor that the caller supplies.

* ``FusionReference``: TweedieMix's multi-concept fusion (arXiv
  2410.05591; the reference's ``fusion_sampling.py`` with its
  ``sample_catdog.sh`` settings): DDIM over the alpha table with 1.0
  prepended, a resampling prologue on the composed Tweedie
  (N-1) x0_multi - sum x0_single, joint CFG steps up to t_cond, a jumping
  Tweedie preview, then masked Tweedie fusion of the per-concept CFG
  predictions, re-noised with the unconditional prediction.
* ``VideoReference``: I2VGen-XL's "angle rotation" DDIM step with CFG over
  the unshifted alpha table.

The noise predictor is called once per UNet call of the configuration, in
order, with the latent the loop would feed it. In a run's check it returns
the program's recorded prediction and compares the latent with the
program's, so the loop is followed step by step from the program's own
predictions: a random-weight trajectory is chaotic, and whole trajectories
of two implementations part after a few steps.

Noise: every seed's initial latent comes from its own CUDA (or CPU)
generator, seeded from numpy's ``SeedSequence([seed, row])``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch


def row_seed(seed: int, row: int) -> int:
    return int(np.random.SeedSequence([seed, row]).generate_state(1, np.uint64)[0] >> 1)


def gaussian(seed: int, row: int, shape, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(row_seed(seed, row))
    return torch.randn(shape, generator=gen, device=device)


def alphas_cumprod(cfg: Dict) -> np.ndarray:
    """Cumulative products of 1 - beta for the "scaled_linear" schedule, in
    float64, as float32 values."""
    betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5,
                        cfg["num_train_timesteps"], dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def timesteps(cfg: Dict) -> List[int]:
    """"leading" spacing with steps_offset: 981, 961, ..., 1 for 50 steps."""
    skip = cfg["num_train_timesteps"] // cfg["n_timesteps"]
    return [int(i * skip + cfg["steps_offset"]) for i in reversed(range(cfg["n_timesteps"]))]


def sqrt32(a) -> float:
    return float(np.sqrt(np.float32(a)))


def cfg_mix(eu, ec, g):
    return eu + g * (ec - eu)


class FusionReference:
    """``cfg``: the configuration file's ``sampling`` object. ``dtype`` is
    the precision of the update arithmetic (float32; a control takes
    bfloat16)."""

    def __init__(self, cfg: Dict, dtype=torch.float32):
        self.cfg = cfg
        acp = alphas_cumprod(cfg)
        self.table = np.concatenate([[np.float32(1.0)], acp]).astype(np.float32)
        self.final = float(acp[0])
        self.skip = cfg["num_train_timesteps"] // cfg["n_timesteps"]
        self.ts = timesteps(cfg)
        self.dtype = dtype

    def alpha(self, t: int) -> float:
        if t < 0:
            return self.final
        return float(self.table[min(t, len(self.table) - 1)])

    def tweedie(self, x, eps, at):
        return ((x - sqrt32(1.0 - at) * eps) / sqrt32(at)).to(self.dtype)

    def renoise(self, x0, eps, at):
        return (sqrt32(at) * x0 + sqrt32(1.0 - at) * eps).to(self.dtype)

    @property
    def t_cond_idx(self) -> int:
        return int(self.cfg["n_timesteps"] * self.cfg["t_cond"])

    def region_masks(self, fg: torch.Tensor) -> torch.Tensor:
        """[N-1, H, W] foreground masks -> [N, h, w]: each binarised at 0.5
        and resized to the latent by sampling at pixel centres, the
        background clamp(1 - sum, 0) last."""
        h, w = self.cfg["height"] // 8, self.cfg["width"] // 8
        big = (fg >= 0.5).float()
        ys = ((torch.arange(h, device=fg.device) + 0.5) * fg.shape[1] / h).long()
        xs = ((torch.arange(w, device=fg.device) + 0.5) * fg.shape[2] / w).long()
        small = big[:, ys][:, :, xs]
        return torch.cat([small, torch.clamp(1.0 - small.sum(0), min=0.0)[None]])

    def run(self, x: torch.Tensor, masks: torch.Tensor, predict: Callable) -> torch.Tensor:
        """x [S, h, w, 4]; ``predict(x, t, phase)`` -> eps [K*S, h, w, 4] for
        the K embedding rows of ``phase`` ("prologue": uncond, multi,
        singles; "joint": uncond, multi; "fused": uncond, concepts).
        Returns the final latent (the last step's Tweedie)."""
        c = self.cfg
        g, n, s = c["guidance_scale"], c["num_concepts"], x.shape[0]
        x = x.to(self.dtype)
        t = self.ts[0]
        at, at_next = self.alpha(t), self.alpha(t - self.skip)

        def composed(eps):
            eu = eps[:s]
            x0 = (n - 1) * self.tweedie(x, cfg_mix(eu, eps[s:2 * s], g), at)
            for cc in range(n - 1):
                x0 = x0 - self.tweedie(x, cfg_mix(eu, eps[(2 + cc) * s:(3 + cc) * s], g), at)
            return x0.to(self.dtype), eu

        eps = predict(x, t, "prologue")
        for _ in range(c["resampling_steps"]):
            x0, eu = composed(eps)
            xn = self.renoise(x0, eu, at_next)
            e2 = predict(xn, t - self.skip, "joint")
            x0n = self.tweedie(xn, cfg_mix(e2[:s], e2[s:], g), at_next)
            x = self.renoise(x0n, e2[:s], at)
            eps = predict(x, t, "prologue")
        eu = eps[:s]
        x = self.renoise(self.tweedie(x, cfg_mix(eu, eps[s:2 * s], g), at), eu, at_next)

        last = c["n_timesteps"] - 1
        for i in range(1, self.t_cond_idx):
            t = self.ts[i]
            e = predict(x, t, "joint")
            x0 = self.tweedie(x, cfg_mix(e[:s], e[s:], g), self.alpha(t))
            x = x0 if i == last else self.renoise(x0, e[:s], self.alpha(t - self.skip))

        xj = x
        t0 = self.ts[self.t_cond_idx]
        for j in range(c["jumping_steps"]):
            tt = t0 - j * c["jump_stride"]
            e = predict(xj, tt, "joint")
            x0 = self.tweedie(xj, cfg_mix(e[:s], e[s:], g), self.alpha(tt))
            xj = self.renoise(x0, e[:s], self.alpha(tt - c["jump_stride"]))

        m = masks[:, None, :, :, None].to(self.dtype)
        for i in range(self.t_cond_idx, c["n_timesteps"]):
            t = self.ts[i]
            e = predict(x, t, "fused")
            eu = e[:s]
            ec = cfg_mix(eu, e[s:].reshape(n, s, *x.shape[1:]), g)
            x0 = (m * self.tweedie(x[None], ec, self.alpha(t))).sum(dim=0).to(self.dtype)
            x = x0 if i == last else self.renoise(x0, eu, self.alpha(t - self.skip))
        return x

    def calls(self) -> List[str]:
        """The phase of each UNet call, in order."""
        c = self.cfg
        out = ["prologue"]
        for _ in range(c["resampling_steps"]):
            out += ["joint", "prologue"]
        out += ["joint"] * (self.t_cond_idx - 1 + c["jumping_steps"])
        return out + ["fused"] * (c["n_timesteps"] - self.t_cond_idx)


class VideoReference:
    """``cfg``: the configuration file's ``sampling`` object (video)."""

    def __init__(self, cfg: Dict, dtype=torch.float32):
        self.cfg = cfg
        self.acp = alphas_cumprod(cfg)
        self.skip = cfg["num_train_timesteps"] // cfg["n_timesteps"]
        self.ts = timesteps(cfg)
        self.dtype = dtype

    def alpha(self, t: int) -> float:
        return float(self.acp[0]) if t < 0 else float(self.acp[min(t, len(self.acp) - 1)])

    def injection_steps(self) -> int:
        return int(self.cfg["n_timesteps"] * self.cfg["injection_timestep"])

    def image_latents(self, frame0: torch.Tensor) -> torch.Tensor:
        """[B, h, w, 4] -> [B, F, h, w, 4]: frame 0, then frames of the
        constant ramp value i/(F-1), i = 1..F-1."""
        f = self.cfg["num_frames"]
        ramp = torch.tensor([(i + 1) / (f - 1) for i in range(f - 1)], device=frame0.device)
        rest = torch.ones_like(frame0)[:, None] * ramp[None, :, None, None, None]
        return torch.cat([frame0[:, None], rest], dim=1)

    def run(self, x: torch.Tensor, predict: Callable) -> torch.Tensor:
        """x [B, F, h, w, 4]; ``predict(x, t, inject)`` -> eps [2B, ...]
        (rows interleaved: uncond, cond per clip)."""
        g = self.cfg["guidance_scale"]
        x = x.to(self.dtype)
        for i, t in enumerate(self.ts):
            e = predict(x, t, i < self.injection_steps())
            e = e.reshape(x.shape[0], 2, *x.shape[1:])
            ep = cfg_mix(e[:, 0], e[:, 1], g)
            at, an = self.alpha(t), self.alpha(t - self.skip)
            sa, sb = sqrt32(at), sqrt32(1.0 - at)
            eps_rot = sa * ep + sb * x
            x0 = sa * x - sb * ep
            x = (sqrt32(an) * x0 + sqrt32(1.0 - an) * eps_rot).to(self.dtype)
        return x

