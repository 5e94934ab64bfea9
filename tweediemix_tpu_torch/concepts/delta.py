"""Concept-delta checkpoints: load, save, and stack into the UNet's weights
(counterpart of ``tweediemix_tpu/concepts/delta.py``).

The reference stores each personalised concept as a "delta dict"
``{'unet': {torch_param_name: tensor}, 'modifier_token': {tok: emb},
'modifier_token_2': {tok: emb}}`` written with ``torch.save``; a
``--train_text_encoder`` checkpoint adds whole text-tower state dicts under
``text_encoder`` (and here ``text_encoder_2``). A UNet entry may be stored
compressed as a pair ``[u, v]`` whose product is the weight.

Everything here works on the port's state-dict names, which are the
checkpoint's (diffusers) names, in torch's [out, in] layout. Custom
Diffusion deltas become the stacked cross-attention weights
``attn2.to_{k,v}_stack`` [N+1, ctx, inner] (slot 0 = the base weight, the
[in, out] layout of ``models/unet2d.py``); LoRA deltas become stacked
factors ``to_{q,k,v,out}_lora_{down,up}`` ([N+1, din, r] / [N+1, r, dout],
slot 0 = zeros).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import torch

_CROSS_KV = re.compile(r"\.attn2\.to_[kv]\.weight$")
_LORA_REF = re.compile(r"^(.*\.attn[12])\.(?:processor\.)?(to_q|to_k|to_v|to_out)_lora\.(down|up)\.weight$")
_LORA_FACTOR = re.compile(r"\.attn[12]\.to_(q|k|v|out)_lora_(down|up)$")

DeltaWeights = Mapping[str, torch.Tensor]


def _float(tensor) -> torch.Tensor:
    if isinstance(tensor, (list, tuple)) and len(tensor) == 2:
        tensor = tensor[0].float() @ tensor[1].float()  # low-rank compressed delta
    return tensor.float()


def load_reference_delta(path: str) -> Dict:
    """Load a reference ``delta-*.bin`` into fp32 tensors:
    ``{'unet': {name: [out, in] tensor}, 'modifier_token': {tok: vector},
    'modifier_token_2': {tok: vector}}``, plus ``text_encoder`` /
    ``text_encoder_2`` HF-named state dicts where the file has them. A
    compressed ``[u, v]`` entry is expanded to ``u @ v``."""
    st = torch.load(path, map_location="cpu", weights_only=True)
    out = {"unet": {name: _float(t) for name, t in st.get("unet", {}).items()}}
    for coll in ("modifier_token", "modifier_token_2"):
        out[coll] = {tok: emb.float() for tok, emb in st.get(coll, {}).items()}
    for key in ("text_encoder", "text_encoder_2"):
        if key in st:
            out[key] = {k: v.float() if v.is_floating_point() else v for k, v in st[key].items()}
    return out


def save_reference_delta(path: str, unet_deltas: Mapping, modifier_token: Mapping,
                         modifier_token_2: Mapping, text_encoder: Mapping = None,
                         text_encoder_2: Mapping = None) -> None:
    """Write a delta checkpoint in the reference's ``save_checkpoint``
    schema. ``unet_deltas`` maps names to [out, in] tensors, or to a pair
    ``(u, v)`` written as the compressed form ``[u, v]``; everything is
    stored in fp32."""

    def f32(t):
        return torch.as_tensor(t, dtype=torch.float32).detach().cpu().clone()

    unet = {name: ([f32(t[0]), f32(t[1])] if isinstance(t, (list, tuple)) else f32(t))
            for name, t in unet_deltas.items()}
    st = {
        "unet": unet,
        "modifier_token": {k: f32(v) for k, v in modifier_token.items()},
        "modifier_token_2": {k: f32(v) for k, v in modifier_token_2.items()},
    }
    for key, sd in (("text_encoder", text_encoder), ("text_encoder_2", text_encoder_2)):
        if sd is not None:
            st[key] = {k: f32(v) for k, v in sd.items()}
    torch.save(st, path)


# ---------------------------------------------------------------------------
# Custom Diffusion: stacked cross-attention K/V


def is_cross_kv(name: str) -> bool:
    """A cross-attention's ``to_k``/``to_v`` weight."""
    return bool(_CROSS_KV.search(name))


def cd_delta_from_reference(ref_delta: Mapping) -> Dict[str, torch.Tensor]:
    """The cross-attention K/V weights of a loaded reference delta."""
    return {name: t for name, t in ref_delta["unet"].items() if is_cross_kv(name)}


def cd_stack(name: str, base: torch.Tensor, concept_kvs: Sequence[DeltaWeights]) -> torch.Tensor:
    """``name``'s stacked weight [N+1, in, out] in fp32 on ``base``'s
    device: slot 0 the base [out, in] weight, slot i concept i's, or the
    base where that checkpoint lacks the layer."""
    base = base.float()
    slots = [base] + [kv[name].to(base.device).float() if name in kv else base
                      for kv in concept_kvs]
    return torch.stack(slots).transpose(1, 2)


def stack_cd_params(state: Mapping[str, torch.Tensor],
                    concept_kvs: Sequence[DeltaWeights]) -> Dict[str, torch.Tensor]:
    """Every ``attn2.to_{k,v}.weight`` of a base state dict becomes
    ``attn2.to_{k,v}_stack`` [N+1, in, out]; other entries are unchanged."""
    out = {}
    for name, t in state.items():
        if is_cross_kv(name):
            out[name[: -len(".weight")] + "_stack"] = cd_stack(name, t, concept_kvs)
        else:
            out[name] = t
    return out


# ---------------------------------------------------------------------------
# LoRA: stacked rank-r factors


def lora_delta_from_reference(ref_delta: Mapping) -> Dict[str, torch.Tensor]:
    """Reference LoRA names (``…attn2.processor.to_q_lora.down.weight``, a
    torch [out, in] weight) → the port's factor names
    (``…attn2.to_q_lora_down``) in the [in, out] layout: down [din, r],
    up [r, dout]."""
    out = {}
    for name, t in ref_delta["unet"].items():
        m = _LORA_REF.match(name)
        if m:
            out[f"{m.group(1)}.{m.group(2)}_lora_{m.group(3)}"] = t.t()
    return out


def is_lora_factor(name: str) -> bool:
    """A stacked LoRA factor of the port's UNet."""
    return bool(_LORA_FACTOR.search(name))


def lora_stack(name: str, shape: Sequence[int], concept_loras: Sequence[DeltaWeights],
               device=None) -> torch.Tensor:
    """Factor ``name``'s stack [N+1, *shape] in fp32: slot 0 zeros (no
    delta), slot i concept i's factor, or zeros where it lacks one."""
    zeros = torch.zeros(tuple(shape), device=device)
    return torch.stack([zeros] + [lora[name].to(zeros.device).float() if name in lora else zeros
                                  for lora in concept_loras])


def stack_lora_params(state: Mapping[str, torch.Tensor], concept_loras: Sequence[DeltaWeights],
                      rank: int = 4) -> Dict[str, torch.Tensor]:
    """Add stacked LoRA factors for every attention of a base state dict
    (dims from its ``to_q``, ``to_k`` and ``to_out.0`` weights)."""
    out = dict(state)
    for name, t in state.items():
        m = re.match(r"^(.*\.attn[12])\.to_q\.weight$", name)
        if not m:
            continue
        prefix = m.group(1)
        inner, q_in = t.shape
        ctx_in = state[f"{prefix}.to_k.weight"].shape[1]
        out_dim = state[f"{prefix}.to_out.0.weight"].shape[0]
        dims = dict(to_q=(q_in, inner), to_k=(ctx_in, inner), to_v=(ctx_in, inner),
                    to_out=(inner, out_dim))
        for factor, (din, dout) in dims.items():
            for part, shape in (("down", (din, rank)), ("up", (rank, dout))):
                key = f"{prefix}.{factor}_lora_{part}"
                out[key] = lora_stack(key, shape, concept_loras)
    return out
