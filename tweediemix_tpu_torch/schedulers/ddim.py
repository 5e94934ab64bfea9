"""DDIM timestep/alpha tables with the TweedieMix conventions (counterpart of
``tweediemix_tpu/schedulers/ddim.py``).

The reference prepends 1.0 to ``alphas_cumprod`` (so ``alpha(t)`` reads the
cumulative product up to ``t-1``), keeps ``final_alpha_cumprod`` for
``t < 0`` and steps with ``skip = num_train_timesteps // n_steps``. The
table lives on the host: the sampler reads alphas as Python floats, so no
step waits on the device for them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_betas(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    schedule: str = "scaled_linear",
) -> np.ndarray:
    """Beta schedule; defaults match the SDXL DDIMScheduler config."""
    if schedule == "scaled_linear":
        return (
            np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64)
            ** 2
        )
    if schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    raise ValueError(f"unknown beta schedule {schedule!r}")


def _sqrt32(a: float) -> float:
    """sqrt in fp32 arithmetic, as the reference computes it on fp32 alphas."""
    return float(np.sqrt(np.float32(a)))


@dataclasses.dataclass(frozen=True)
class DDIMTable:
    """Precomputed DDIM schedule with the TweedieMix alpha-shift convention.

    timesteps: int64[S] descending sampling timesteps (981..1 for 50 steps).
    alphas_cumprod: fp32[T+1]; entry 0 is the prepended 1.0.
    final_alpha_cumprod: used for ``t < 0``.
    skip: ``num_train_timesteps // n_steps``.
    """

    timesteps: torch.Tensor
    alphas_cumprod: torch.Tensor
    final_alpha_cumprod: float
    skip: int
    init_noise_sigma: float = 1.0

    @classmethod
    def create(
        cls,
        n_steps: int = 50,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        schedule: str = "scaled_linear",
        steps_offset: int = 1,
        set_alpha_to_one: bool = False,
    ) -> "DDIMTable":
        betas = make_betas(num_train_timesteps, beta_start, beta_end, schedule)
        acp = np.cumprod(1.0 - betas)
        final = 1.0 if set_alpha_to_one else float(np.float32(acp[0]))
        skip = num_train_timesteps // n_steps
        # diffusers "leading" spacing + steps_offset, as used by SDXL
        ts = (np.arange(0, n_steps) * skip).round()[::-1].astype(np.int64) + steps_offset
        shifted = np.concatenate([[1.0], acp])
        return cls(
            timesteps=torch.from_numpy(ts.copy()),
            alphas_cumprod=torch.from_numpy(shifted.astype(np.float32)),
            final_alpha_cumprod=final,
            skip=skip,
        )

    @property
    def n_steps(self) -> int:
        return int(self.timesteps.shape[0])

    def alpha(self, t: int) -> float:
        """ā(t) with the shifted table; t < 0 → final_alpha_cumprod."""
        t = int(t)
        if t < 0:
            return self.final_alpha_cumprod
        return float(self.alphas_cumprod[min(t, self.alphas_cumprod.shape[0] - 1)])

    @staticmethod
    def tweedie(x: torch.Tensor, eps: torch.Tensor, at: float) -> torch.Tensor:
        """x0-hat = (x - sqrt(1-ā)·eps) / sqrt(ā)."""
        return (x - _sqrt32(1.0 - at) * eps) / _sqrt32(at)

    @staticmethod
    def renoise(x0: torch.Tensor, eps: torch.Tensor, at_next: float) -> torch.Tensor:
        """x_{t-1} = sqrt(ā_next)·x0 + sqrt(1-ā_next)·eps (the fusion sampler
        always re-noises with the unconditional eps)."""
        return _sqrt32(at_next) * x0 + _sqrt32(1.0 - at_next) * eps


def cfg(eps_uncond: torch.Tensor, eps_cond: torch.Tensor, scale: float) -> torch.Tensor:
    """Classifier-free guidance combine."""
    return eps_uncond + scale * (eps_cond - eps_uncond)


def video_rotation_step(x: torch.Tensor, eps_pred: torch.Tensor, at: float,
                        at_next: float) -> torch.Tensor:
    """The I2VGen-XL "angle rotation" DDIM step: (x_t, eps) are rotated as
    an orthogonal basis,

        eps_rot = sqrt(ā)·eps_pred + sqrt(1-ā)·x_t
        x0      = sqrt(ā)·x_t     - sqrt(1-ā)·eps_pred
        x_next  = sqrt(ā_next)·x0 + sqrt(1-ā_next)·eps_rot
    """
    sa, sb = _sqrt32(at), _sqrt32(1.0 - at)
    eps_rot = sa * eps_pred + sb * x
    x0 = sa * x - sb * eps_pred
    return _sqrt32(at_next) * x0 + _sqrt32(1.0 - at_next) * eps_rot


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: float = 0.0):
    """CFG rescale of arXiv 2305.08891 §3.4."""
    dims = tuple(range(1, noise_pred_text.ndim))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def add_noise(x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor,
              alphas_cumprod_unshifted: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) for training, per row of ``t``
    (diffusers' ``scheduler.add_noise``, on the unshifted table)."""
    at = alphas_cumprod_unshifted.to(x0.device)[t].float()
    at = at.reshape(at.shape + (1,) * (x0.ndim - at.ndim))
    return torch.sqrt(at) * x0 + torch.sqrt(1.0 - at) * noise


def training_alphas_cumprod(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    schedule: str = "scaled_linear",
) -> torch.Tensor:
    """The unshifted ā table (index t is the original t) for the training
    loss, fp32."""
    betas = make_betas(num_train_timesteps, beta_start, beta_end, schedule)
    return torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32))
