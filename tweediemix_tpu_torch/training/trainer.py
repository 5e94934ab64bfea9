"""The full personalisation trainer: the UNet's Custom-Diffusion K/V or LoRA
factors and the modifier-token embeddings of both text towers, with
delta checkpoints (counterpart of ``tweediemix_tpu/training/trainer.py``).

* Modifier tokens are added to both tokenizers; the loss differentiates
  through both CLIP towers so their embedding rows learn, and the gradient
  of every other row is zeroed before the clip (the reference's grad
  zeroing). AdamW's decay still moves those rows, as in the JAX package.
* The trainable parameters are named ``"<model>/<parameter>"`` with model
  one of ``MODELS``. Under a bf16 bulk each trainable parameter becomes an
  fp32 master: a LoRA factor is simply fp32 (its product runs in fp32
  anyway); any other computes in the module's dtype through a
  parametrization that casts the master at use, as flax's
  ``Dense(dtype=bf16)`` casts an fp32 kernel. The gradient is that of the
  bf16 product, accumulated into the fp32 master.
* The VAE encode runs outside the step on frozen weights.
* ``delta-{step}.bin`` checkpoints use the reference's schema
  (``concepts/delta.py``); LoRA factors are written under the reference's
  processor names in torch's [out, in] layout, so the fusion CLI's LoRA mode
  reads them. Resume checkpoints are ``torch.save`` files of the port's own
  state (the trainable masters, the optimizer, the micro-step count); a
  JAX package's orbax resume directory is not read.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn.utils import parametrize

from tweediemix_tpu_torch.concepts.delta import save_reference_delta
from tweediemix_tpu_torch.parallel.mesh import all_reduce_sum
from tweediemix_tpu_torch.schedulers.ddim import add_noise
from tweediemix_tpu_torch.training.custom_diffusion import (
    TrainConfig,
    diffusion_loss,
    draw_noise,
    loss_counts,
    make_optimizer,
    trainable_mask,
)
from tweediemix_tpu_torch.training.optim import FullOptimizer

MODELS = ("unet", "te1", "te2")
TOKEN_TABLE = "text_model.embeddings.token_embedding.weight"
_PARAMETRIZED = re.compile(r"\.parametrizations\.(\w+)\.original$")
_LORA_FACTOR = re.compile(r"^(.*\.attn[12])\.(to_q|to_k|to_v|to_out)_lora_(down|up)$")


def full_trainable_mask(models: Mapping[str, nn.Module], freeze_model: str,
                        train_text_embeddings: bool,
                        train_text_encoder: bool = False) -> Dict[str, Dict[str, bool]]:
    """{model: {parameter name: trainable}} over ``MODELS``: the UNet by
    ``freeze_model``; with ``train_text_encoder`` both towers whole (the
    reference's ``--train_text_encoder``), else only their token tables and
    only when modifier tokens train (``train_text_embeddings``)."""

    def tower(module):
        return {name: train_text_encoder or (train_text_embeddings and name == TOKEN_TABLE)
                for name, _ in module.named_parameters()}

    return {"unet": trainable_mask(models["unet"], freeze_model),
            "te1": tower(models["te1"]), "te2": tower(models["te2"])}


class _CastTo(nn.Module):
    """Parametrization: the fp32 master, cast to the module's dtype at use."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype

    def forward(self, master: torch.Tensor) -> torch.Tensor:
        return master.to(self.dtype)


def _owner(module: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, _, leaf = name.rpartition(".")
    return (module.get_submodule(path) if path else module), leaf


def promote_trainable_to_fp32(models: Mapping[str, nn.Module],
                              mask: Mapping[str, Mapping[str, bool]]) -> Dict[str, nn.Parameter]:
    """Make every trainable parameter an fp32 master (module docstring),
    freeze every other parameter of the models, and return the trainable
    ones as {"<model>/<name>": parameter}, in the models' order."""
    params = {}
    for key in MODELS:
        module = models[key]
        for name, on in mask[key].items():
            owner, leaf = _owner(module, name)
            p = getattr(owner, leaf)
            if not on:
                p.requires_grad_(False)
                continue
            if p.dtype != torch.float32:
                master = nn.Parameter(p.detach().float())
                setattr(owner, leaf, master)
                if not _LORA_FACTOR.match(name):
                    parametrize.register_parametrization(owner, leaf, _CastTo(p.dtype), unsafe=True)
                p = master
            p.requires_grad_(True)
            params[f"{key}/{name}"] = p
    return params


def plain_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` under its plain names: a parametrized
    parameter appears once, as its fp32 master."""
    return {_PARAMETRIZED.sub(r".\1", k): v for k, v in module.state_dict().items()}


def make_full_optimizer(cfg: TrainConfig, params: Mapping[str, nn.Parameter],
                        accumulation_steps: int = 1) -> FullOptimizer:
    """Clip + AdamW (or AdamW8bit) over the trainable parameters, stepping
    every ``accumulation_steps`` micro steps on their mean gradient."""
    return make_optimizer(cfg, params.values(), accumulation_steps)


def embedding_row_mask(vocab_size: int, modifier_ids, device=None) -> torch.Tensor:
    """[V, 1] fp32: 1 only on the modifier rows."""
    m = torch.zeros((vocab_size, 1), device=device)
    m[[int(i) for i in modifier_ids]] = 1.0
    return m


@dataclasses.dataclass
class FullTrainState:
    """The trainable masters, their optimizer and the micro-step count;
    ``grads`` holds the last micro step's gradients, row-masked and before
    the clip."""

    params: Dict[str, nn.Parameter]
    optimizer: FullOptimizer
    step: int = 0
    grads: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def encode_latents(vae, pixels: torch.Tensor, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Pixels [B, H, W, 3] in [-1, 1] → scaled latents (fp32) from one draw
    of the VAE posterior; ``noise`` replaces the draw from ``generator``."""
    from tweediemix_tpu_torch.models.vae import scale_latents

    with torch.no_grad():
        mean, logvar = vae.encode(pixels)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                dtype=torch.float32)
        z = mean.float() + torch.exp(0.5 * logvar.float()) * noise.to(mean.device)
        return scale_latents(z, vae.config).float()


def make_full_train_step(unet: nn.Module, te1: nn.Module, te2: nn.Module, cfg: TrainConfig,
                         acp: torch.Tensor, row_mask_1: Optional[torch.Tensor],
                         row_mask_2: Optional[torch.Tensor], time_ids: torch.Tensor,
                         data_parallel: bool = False):
    """``step(state, batch, generator=None, timesteps=None, noise=None) ->
    metrics``. ``batch``: latents [B, h, w, 4] (encoded and scaled), mask
    [B, h, w, 1], ids_one/ids_two [B, 77], is_prior [B], all on the UNet's
    device. The step draws t and the noise from ``generator`` unless
    ``timesteps``/``noise`` are given, differentiates the loss with respect
    to ``state.params``, zeroes the non-modifier rows of the token tables'
    gradients, hands them to ``state.optimizer`` and counts the micro
    step.

    With ``data_parallel`` the batch is this rank's share of a global batch
    (``torch.distributed`` is initialised; ``timesteps``/``noise`` are then
    this rank's rows of the global draw): the loss divides by the global
    batch's counts (``diffusion_loss``), the trainable gradients are summed
    over the ranks before the row masks and the optimizer's clip, so every
    rank takes the same step, and the metrics are the global batch's."""
    row_masks = {f"te1/{TOKEN_TABLE}": row_mask_1, f"te2/{TOKEN_TABLE}": row_mask_2}

    def step(state: FullTrainState, batch, generator=None, timesteps=None, noise=None):
        latents = batch["latents"]
        b = latents.shape[0]
        if timesteps is None or noise is None:
            timesteps, noise = draw_noise(latents, cfg, generator)
        for p in state.params.values():
            p.grad = None
        pen1 = te1(batch["ids_one"])[0]
        pen2, _, pooled, _ = te2(batch["ids_two"])
        ctx = torch.cat([pen1, pen2], dim=-1)
        noisy = add_noise(latents, noise, timesteps, acp)
        pred = unet(noisy, timesteps, ctx, pooled, time_ids.expand(b, -1))
        counts = None
        if data_parallel:
            counts = loss_counts(b, batch["is_prior"], latents.device)
            all_reduce_sum([counts])
        loss, metrics = diffusion_loss(pred, noise, batch["mask"], batch["is_prior"], cfg, counts)
        loss.backward()
        if data_parallel:
            all_reduce_sum([p.grad for p in state.params.values() if p.grad is not None])
            metrics = dict(zip(metrics, _summed([v.detach() for v in metrics.values()])))
        for key, row_mask in row_masks.items():
            p = state.params.get(key)
            if row_mask is not None and p is not None and p.grad is not None:
                p.grad = p.grad * row_mask.to(p.grad.dtype)
        state.grads = {k: p.grad for k, p in state.params.items() if p.grad is not None}
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


def _summed(values):
    """Scalars summed over the ranks (each rank's loss is its share of the
    global batch's)."""
    flat = torch.stack(values)
    all_reduce_sum([flat])
    return list(flat.unbind())


# ---------------------------------------------------------------------------
# checkpoints


def reference_lora_name(name: str) -> str:
    """A stacked factor's name → the reference's LoRA processor name
    (``…attn1.to_q_lora_down`` → ``…attn1.processor.to_q_lora.down.weight``)."""
    m = _LORA_FACTOR.match(name)
    return f"{m.group(1)}.processor.{m.group(2)}_lora.{m.group(3)}.weight"


def extract_delta(params: Mapping[str, torch.Tensor], modifier_tokens: Sequence[str],
                  modifier_ids_1: Sequence[int], modifier_ids_2: Sequence[int]):
    """The trainable UNet parameters and the modifier rows in the delta
    schema: (unet {name: [out, in] fp32}, tokens 1 {tok: row}, tokens 2).
    A LoRA factor's trained slot 0 ([din, r] / [r, dout]) goes out
    transposed under its reference name."""
    unet = {}
    for key, p in params.items():
        model, name = key.split("/", 1)
        if model != "unet":
            continue
        if _LORA_FACTOR.match(name):
            unet[reference_lora_name(name)] = p.detach()[0].t()
        else:
            unet[name] = p.detach()
    tokens = []
    for model, ids in (("te1", modifier_ids_1), ("te2", modifier_ids_2)):
        table = params.get(f"{model}/{TOKEN_TABLE}")
        tokens.append({tok: table.detach()[int(i)] for tok, i in zip(modifier_tokens, ids)}
                      if table is not None else {})
    return unet, tokens[0], tokens[1]


def save_delta_checkpoint(path: str, state: FullTrainState, modifier_tokens: Sequence[str],
                          modifier_ids_1: Sequence[int], modifier_ids_2: Sequence[int],
                          text_encoders: Optional[Tuple[nn.Module, nn.Module]] = None) -> None:
    """Write ``delta-{step}.bin``; ``text_encoders`` (with
    ``--train_text_encoder``) adds both towers' whole HF-named state dicts
    (the reference's ``save_text_encoder`` branch)."""
    unet, tok1, tok2 = extract_delta(state.params, modifier_tokens, modifier_ids_1,
                                     modifier_ids_2)
    te = (None, None) if text_encoders is None else tuple(plain_state_dict(m) for m in text_encoders)
    save_reference_delta(path, unet, tok1, tok2, text_encoder=te[0], text_encoder_2=te[1])


def save_resume_checkpoint(ckpt_dir: str, state: FullTrainState, step: int) -> str:
    """``<ckpt_dir>/state_<step>.pt`` (``step`` in optimizer steps): the
    masters, the optimizer's state and the micro-step count."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"state_{step}.pt")
    torch.save(dict(step=state.step, params={k: p.detach() for k, p in state.params.items()},
                    optimizer=state.optimizer.state_dict()), path)
    return path


@torch.no_grad()
def load_resume_checkpoint(ckpt_dir: str, step: int, state: FullTrainState) -> FullTrainState:
    """Restore ``state`` in place from ``save_resume_checkpoint``'s file."""
    saved = torch.load(os.path.join(ckpt_dir, f"state_{step}.pt"), map_location="cpu",
                       weights_only=True)
    if set(saved["params"]) != set(state.params):
        raise ValueError("the resume checkpoint's trainable parameters differ from this run's")
    for key, p in state.params.items():
        p.copy_(saved["params"][key])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = saved["step"]
    return state
