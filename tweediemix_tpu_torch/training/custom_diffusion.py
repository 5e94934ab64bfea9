"""Single-concept personalisation: trainable selection, the diffusion loss
and a UNet-only train step (counterpart of
``tweediemix_tpu/training/custom_diffusion.py``).

* The trainable parameters are chosen by name, as the JAX package's optax
  mask chooses leaves (the reference's ``create_custom_diffusion``
  ``requires_grad`` surgery): ``crossattn_kv`` trains only the
  cross-attentions' ``to_k``/``to_v`` weights, ``crossattn`` every ``attn2``
  parameter, ``lora`` every stacked LoRA factor.
* The loss is the reference's masked MSE on the eps prediction over
  instance rows plus ``prior_loss_weight`` times the plain MSE over prior
  rows, with a random timestep per row.
* Gradient clipping and AdamW (or AdamW8bit) run on the trainable subset
  (``optim.FullOptimizer``).

The first context token's K/V detach lives in the model
(``UNetConfig.detach_first_token_kv``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional

import torch
from torch import nn

from tweediemix_tpu_torch.schedulers.ddim import add_noise
from tweediemix_tpu_torch.training.optim import AdamW, FullOptimizer

FREEZE_MODELS = ("crossattn_kv", "crossattn", "lora")
_CROSS_KV_WEIGHT = re.compile(r"(^|\.)attn2\.to_[kv]\.weight$")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters (defaults as the reference's singleconcept_train.sh).
    ``learning_rate`` is a float or a function of the optimizer step
    (``lr_schedules.get_lr_schedule``)."""

    learning_rate: float | Callable[[int], float] = 1e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    prior_loss_weight: float = 1.0
    with_prior_preservation: bool = True
    freeze_model: str = "crossattn_kv"  # crossattn_kv | crossattn | lora
    num_train_timesteps: int = 1000
    # int8 blockwise moments (the reference's bitsandbytes AdamW8bit)
    use_8bit_adam: bool = False


def is_trainable(name: str, freeze_model: str = "crossattn_kv") -> bool:
    """Whether a UNet parameter (its state-dict name) trains under
    ``freeze_model``."""
    if freeze_model == "crossattn_kv":
        return bool(_CROSS_KV_WEIGHT.search(name))
    if freeze_model == "crossattn":
        return "attn2" in name.split(".")
    if freeze_model == "lora":
        return "_lora_" in name.rsplit(".", 1)[-1]
    raise ValueError(f"freeze_model must be one of {FREEZE_MODELS}, got {freeze_model!r}")


def trainable_mask(module: nn.Module, freeze_model: str = "crossattn_kv") -> Dict[str, bool]:
    """{parameter name: trainable} over ``module.named_parameters()``."""
    return {name: is_trainable(name, freeze_model) for name, _ in module.named_parameters()}


def make_optimizer(cfg: TrainConfig, params, accumulation_steps: int = 1) -> FullOptimizer:
    """Clip, then AdamW or AdamW8bit, over ``params`` only (the trainable
    leaves): a frozen parameter never reaches the optimizer, so it has no
    moments and takes no decay."""
    if cfg.use_8bit_adam:
        from tweediemix_tpu_torch.training.adam8bit import AdamW8bit as adam
    else:
        adam = AdamW
    params = list(params)
    inner = adam(params, lr=cfg.learning_rate, b1=cfg.adam_beta1, b2=cfg.adam_beta2,
                 eps=cfg.adam_epsilon, weight_decay=cfg.adam_weight_decay)
    return FullOptimizer(params, inner, cfg.max_grad_norm, accumulation_steps)


def draw_noise(latents: torch.Tensor, cfg: TrainConfig, generator: Optional[torch.Generator]):
    """(t [B] int64, noise like ``latents``) from ``generator``."""
    b = latents.shape[0]
    t = torch.randint(0, cfg.num_train_timesteps, (b,), generator=generator,
                      device=latents.device)
    noise = torch.randn(latents.shape, generator=generator, device=latents.device,
                        dtype=latents.dtype)
    return t, noise


def loss_counts(batch_rows: int, is_prior: Optional[torch.Tensor], device=None) -> torch.Tensor:
    """[rows, instance rows, prior rows] (fp32) of a batch, the divisors of
    ``diffusion_loss``."""
    prior = torch.zeros((), device=device) if is_prior is None else is_prior.float().sum()
    rows = torch.full_like(prior, float(batch_rows))
    return torch.stack([rows, rows - prior, prior])


def diffusion_loss(pred: torch.Tensor, noise: torch.Tensor, mask: torch.Tensor,
                   is_prior: Optional[torch.Tensor], cfg: TrainConfig,
                   counts: Optional[torch.Tensor] = None):
    """Masked MSE of the eps prediction (fp32): per row, the squared error
    summed over the pixels where ``mask`` [B, h, w, 1] is set and over the
    channels, over the count of those pixels; with prior preservation the
    instance rows' mean plus ``prior_loss_weight`` times the prior rows'
    plain MSE. Returns (loss, metrics).

    ``counts`` (``loss_counts`` of the whole batch) is given when these
    rows are one rank's share of a data-parallel batch: the means then
    divide by the whole batch's counts, so the ranks' losses, and their
    gradients, sum to the whole batch's. (A contiguous split of the
    [instance rows; prior rows] layout can leave a rank with rows of one
    kind only, so dividing by its own counts would not.)"""
    se = (pred - noise) ** 2
    masked_mse = (se * mask).sum(dim=(1, 2, 3)) / mask.sum(dim=(1, 2, 3)).clamp(min=1.0)
    if is_prior is None or not cfg.with_prior_preservation:
        loss = masked_mse.mean() if counts is None else masked_mse.sum() / counts[0]
        return loss, {"loss": loss}
    plain_mse = se.mean(dim=(1, 2, 3))
    inst_w = 1.0 - is_prior
    n_inst, n_prior = (inst_w.sum(), is_prior.sum()) if counts is None else (counts[1], counts[2])
    inst = (masked_mse * inst_w).sum() / n_inst.clamp(min=1.0)
    prior = (plain_mse * is_prior).sum() / n_prior.clamp(min=1.0)
    total = inst + cfg.prior_loss_weight * prior
    return total, {"loss": total, "instance_loss": inst, "prior_loss": prior}


def make_train_step(unet: nn.Module, cfg: TrainConfig, acp: torch.Tensor,
                    optimizer: FullOptimizer):
    """A UNet-only train step on precomputed text embeddings: ``step(batch,
    generator=None, timesteps=None, noise=None) -> metrics``, where
    ``batch`` holds latents [B, h, w, 4] (encoded and scaled), mask
    [B, h, w, 1], ctx, pooled, time_ids and optionally is_prior.
    ``timesteps``/``noise`` replace the draws from ``generator``."""

    def step(batch, generator=None, timesteps=None, noise=None):
        latents = batch["latents"]
        if timesteps is None or noise is None:
            timesteps, noise = draw_noise(latents, cfg, generator)
        for p in optimizer.params:
            p.grad = None
        noisy = add_noise(latents, noise, timesteps, acp)
        pred = unet(noisy, timesteps, batch["ctx"], batch["pooled"], batch["time_ids"])
        loss, metrics = diffusion_loss(pred, noise, batch["mask"], batch.get("is_prior"), cfg)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step
