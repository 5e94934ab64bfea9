"""The JAX package's parameter trees → the port's ``state_dict``.

A parameter tree is the nested dict of arrays that ``tweediemix_tpu``'s Flax
UNet and VAE hold (``model.init(...)["params"]``, as numpy arrays). The rules:

* Dense ``kernel [in, out]`` → Linear ``weight [out, in]``;
* Conv ``kernel`` HWIO → ``weight`` OIHW (a temporal conv's [3, 1, 1, I, O]
  → Conv3d [O, I, 3, 1, 1]);
* norm ``scale`` → ``weight``; biases are unchanged;
* concept stacks (``to_k_stack``/``to_v_stack`` [slots, in, out]) and LoRA
  factors keep their layout and names;
* a self-attention's ``to_q``/``to_k``/``to_v`` kernels become one merged
  ``to_qkv`` weight [3·inner, C], built once here so no forward copies it;
* where the module is quantised (``ops.quant.QLinear``/``QConv2d``: the
  trees are the same with or without quant), each weight becomes
  ``weight_q`` int8 and ``weight_scale`` fp32, quantised from the fp32
  values before the module's dtype is applied, as the JAX package
  quantises its fp32 kernels;
* Flax scope names become the diffusers module paths the port uses
  (``down_blocks_1_attentions_0/transformer_blocks_0/ff/net_0_proj`` →
  ``down_blocks.1.attentions.0.transformer_blocks.0.ff.net.0.proj``; for the
  video UNet ``down_blocks_0_temp_convs_0/norm2`` →
  ``down_blocks.0.temp_convs.0.conv2.0``, ``image_latents_proj_in_conv2`` →
  ``image_latents_proj_in.2``, ``fps_embedding/linear_1`` →
  ``fps_embedding.0``).

A key the module lacks, a key the tree lacks, or a shape that differs
raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from tweediemix_tpu_torch.ops.quant import quantize_weight_int8, quantize_weight_int8_conv

_BLOCK_PARTS = r"(resnets|attentions|temp_convs|temp_attentions|downsamplers|upsamplers)"
_RENAMES = (
    (re.compile(rf"(down_blocks|up_blocks)_(\d+)_{_BLOCK_PARTS}_(\d+)"), r"\1.\2.\3.\4"),
    (re.compile(rf"mid_block_{_BLOCK_PARTS}_(\d+)"), r"mid_block.\1.\2"),
    (re.compile(r"transformer_blocks_(\d+)"), r"transformer_blocks.\1"),
    (re.compile(r"\bto_out_0\b"), "to_out.0"),
    (re.compile(r"\bff\.net_0_proj\b"), "ff.net.0.proj"),
    (re.compile(r"\bff\.net_2\b"), "ff.net.2"),
    # the video UNet's nn.Sequential stacks (diffusers' indices): a temporal
    # conv stage K holds its norm at 0 and its conv at 2 (K = 1) or 3
    (re.compile(r"(temp_convs\.\d+)\.conv1$"), r"\1.conv1.2"),
    (re.compile(r"(temp_convs\.\d+)\.conv([234])$"), r"\1.conv\2.3"),
    (re.compile(r"(temp_convs\.\d+)\.norm([1234])$"), r"\1.conv\2.0"),
    (re.compile(r"^image_latents_proj_in_conv([123])$"),
     lambda m: f"image_latents_proj_in.{2 * int(m.group(1)) - 2}"),
    (re.compile(r"^image_latents_context_embedding_conv([123])$"),
     lambda m: "image_latents_context_embedding." + "035"[int(m.group(1)) - 1]),
    (re.compile(r"^(context_embedding|fps_embedding)\.linear_([12])$"),
     lambda m: f"{m.group(1)}.{2 * int(m.group(2)) - 2}"),
)


def flatten_tree(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    """Nested dict → {path tuple: array}."""
    out = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            out.update(flatten_tree(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def torch_name(path: Tuple[str, ...]) -> str:
    """Flax parameter path → the port's state_dict key."""
    *scope, leaf = path
    name = ".".join(scope)
    for pattern, repl in _RENAMES:
        name = pattern.sub(repl, name)
    leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    return f"{name}.{leaf}" if name else leaf


def torch_layout(path: Tuple[str, ...], arr: np.ndarray) -> np.ndarray:
    """Transpose a Flax leaf into torch's layout."""
    if path[-1] == "kernel":
        if arr.ndim == 2:
            return arr.T
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)
        if arr.ndim == 5:  # temporal conv [3, 1, 1, I, O] → Conv3d [O, I, 3, 1, 1]
            return arr.transpose(4, 3, 0, 1, 2)
    return arr


def merge_self_attention_qkv(sd: Dict[str, torch.Tensor], want: Mapping) -> None:
    """In place: where the module holds a merged ``to_qkv`` (the UNet's
    self-attention), stack the tree's ``to_q``/``to_k``/``to_v`` weights
    into one ``to_qkv.weight``, q rows first, as the JAX module
    concatenates them (``quantize_weights`` then quantises it if the module
    is quantised)."""
    for key in want:
        if not key.endswith((".to_qkv.weight", ".to_qkv.weight_q")):
            continue
        prefix = key[: key.rindex("to_qkv.")]
        parts = [f"{prefix}{p}.weight" for p in ("to_q", "to_k", "to_v")]
        if all(p in sd for p in parts):
            sd[f"{prefix}to_qkv.weight"] = torch.cat([sd.pop(p) for p in parts], dim=0)


def quantize_weights(sd: Dict[str, torch.Tensor], want: Mapping) -> None:
    """In place: for each quantised module of ``want`` (a ``weight_q``
    key), replace the fp32 ``weight`` by its int8 form and scales; the float
    weight stays only where the module keeps one too."""
    for key in want:
        if not key.endswith(".weight_q"):
            continue
        prefix = key[: -len("weight_q")]
        w = sd.get(f"{prefix}weight")
        if w is None:
            continue
        quantize = quantize_weight_int8 if w.ndim == 2 else quantize_weight_int8_conv
        sd[key], sd[f"{prefix}weight_scale"] = quantize(w)
        if f"{prefix}weight" not in want:
            del sd[f"{prefix}weight"]


def convert_params(params: Mapping, module: nn.Module) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (the JAX UNet's, video UNet's, VAE's or one block's) →
    ``module``'s state_dict as CPU tensors (fp32, and int8 where quantised);
    raises listing every missing, unexpected or mis-shaped key."""
    sd = {}
    for path, arr in flatten_tree(params).items():
        name = torch_name(path)
        if name in sd:
            raise ValueError(f"two parameters map to {name!r}")
        sd[name] = torch.tensor(np.asarray(torch_layout(path, arr), dtype=np.float32))
    want = module.state_dict()
    merge_self_attention_qkv(sd, want)
    quantize_weights(sd, want)
    problems = [f"missing: {k} {tuple(want[k].shape)}" for k in sorted(set(want) - set(sd))]
    problems += [f"unexpected: {k} {tuple(sd[k].shape)}" for k in sorted(set(sd) - set(want))]
    problems += [
        f"shape mismatch: {k} got {tuple(sd[k].shape)} want {tuple(want[k].shape)}"
        for k in sorted(set(sd) & set(want)) if tuple(sd[k].shape) != tuple(want[k].shape)
    ]
    if problems:
        raise ValueError(f"converted parameters do not fit {type(module).__name__} "
                         f"({len(problems)} problems):\n  " + "\n  ".join(problems[:20]))
    return sd


def load_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a JAX parameter tree into ``module`` (cast to its dtype)."""
    module.load_state_dict(convert_params(params, module))
    return module
