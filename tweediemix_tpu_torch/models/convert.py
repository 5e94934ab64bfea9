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
raises. A CLIP text tree goes through ``clip_torch_name`` to the HF names
(``layers_0/q_proj`` → ``text_model.encoder.layers.0.self_attn.q_proj``);
the segmentation stage's trees go through ``sam_entries``,
``detector_entries`` and ``clip_vision_entries`` to segment-anything's and
HF's names. A Flax ``ConvTranspose`` kernel (SAM's ``up1``/``up2``) is
flipped in both spatial axes on its way into ``nn.ConvTranspose2d``: Flax
(``transpose_kernel=False``) correlates the dilated input with the kernel,
torch's transposed convolution scatters with it, and the two agree only
with the kernel mirrored.

The second half of the module loads checkpoint *directories* in the
diffusers/HF layout (``unet/``, ``vae/``, ``text_encoder/``, …), the
counterparts of the JAX package's ``load_*_params``: their names are the
port's already, but for each self-attention's merged ``to_qkv`` (stacked
from ``to_q``/``to_k``/``to_v`` once, at load), the concept stacks, the int8
forms and, in the I2VGen-XL UNet, the spatial transformers' 1x1-conv
projections (read as linear weights). A module is built on the ``meta`` device, the file's names and
shapes are checked against it (a missing key, an unexpected key or a wrong
shape raises, before any weight is read), and only then is it given memory
on its device and filled one tensor at a time, so no host copy of the whole
model is made. ``.safetensors`` files are read by the port's own reader
(an 8-byte little-endian header length, a JSON header, raw bytes);
``.bin`` and ``.pth`` files go through ``torch.load(weights_only=True)``.
The segmentation loaders (``load_sam``, ``load_detector``,
``load_clip_vision_model``) read segment-anything's and HF's names as
they are: a checkpoint's transposed-convolution kernels go into
``nn.ConvTranspose2d`` unflipped, which is what upstream computes.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import struct
from typing import Callable, Dict, Iterable, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tweediemix_tpu_torch.concepts.delta import cd_stack, is_lora_factor, lora_stack
from tweediemix_tpu_torch.device import resolve_device
from tweediemix_tpu_torch.ops.quant import quantize_weight_int8, quantize_weight_int8_conv

# (tree path, leaf) → the (state-dict name, torch-layout array) pairs of the leaf
EntriesFn = Callable[[Tuple[str, ...], np.ndarray], Iterable[Tuple[str, np.ndarray]]]

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


_CLIP_RENAMES = (
    (re.compile(r"^layers_(\d+)\.(q_proj|k_proj|v_proj|out_proj)\."),
     r"text_model.encoder.layers.\1.self_attn.\2."),
    (re.compile(r"^layers_(\d+)\.(fc[12])\."), r"text_model.encoder.layers.\1.mlp.\2."),
    (re.compile(r"^layers_(\d+)\.(layer_norm[12])\."), r"text_model.encoder.layers.\1.\2."),
    (re.compile(r"^token_embedding\.embedding$"), "text_model.embeddings.token_embedding.weight"),
    (re.compile(r"^position_embedding$"), "text_model.embeddings.position_embedding.weight"),
    (re.compile(r"^final_layer_norm\."), "text_model.final_layer_norm."),
)


def _renamed(path: Tuple[str, ...], renames) -> str:
    """A tree path as a dotted name (``kernel``/``scale`` → ``weight``)
    through ``renames``' (pattern, replacement) pairs in order."""
    *scope, leaf = path
    name = ".".join([*scope, {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)])
    for pattern, repl in renames:
        name = pattern.sub(repl, name)
    return name


def clip_torch_name(path: Tuple[str, ...]) -> str:
    """A CLIP text tree's path → the HF name the port's ``CLIPTextModel``
    uses (``("layers_0", "q_proj", "kernel")`` →
    ``text_model.encoder.layers.0.self_attn.q_proj.weight``)."""
    return _renamed(path, _CLIP_RENAMES)


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


def convert_params(params: Mapping, module: nn.Module,
                   name_fn: Callable[[Tuple[str, ...]], str] = torch_name,
                   entries_fn: Optional[EntriesFn] = None) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (the JAX UNet's, video UNet's, VAE's or one
    block's; a CLIP tower's with ``name_fn=clip_torch_name``) →
    ``module``'s state_dict as CPU tensors (fp32, and int8 where quantised);
    raises listing every missing, unexpected or mis-shaped key.
    ``entries_fn(path, arr)`` (``sam_entries``, ``detector_entries``,
    ``clip_vision_entries``), where given, yields the (name, torch-layout
    array) pairs of each leaf instead of ``name_fn`` and ``torch_layout``."""
    if entries_fn is None:
        def entries_fn(path, arr):
            return [(name_fn(path), torch_layout(path, arr))]
    sd = {}
    for path, arr in flatten_tree(params).items():
        for name, value in entries_fn(path, arr):
            if name in sd:
                raise ValueError(f"two parameters map to {name!r}")
            sd[name] = torch.tensor(np.ascontiguousarray(value, dtype=np.float32))
    want = module.state_dict()
    merge_self_attention_qkv(sd, want)
    quantize_weights(sd, want)
    check_shapes({k: tuple(v.shape) for k, v in sd.items()},
                 {k: tuple(v.shape) for k, v in want.items()},
                 f"converted parameters do not fit {type(module).__name__}")
    return sd


def check_shapes(got: Mapping[str, tuple], want: Mapping[str, tuple], what: str) -> None:
    """Raise listing every missing, unexpected or mis-shaped key."""
    problems = [f"missing: {k} {want[k]}" for k in sorted(set(want) - set(got))]
    problems += [f"unexpected: {k} {got[k]}" for k in sorted(set(got) - set(want))]
    problems += [f"shape mismatch: {k} got {got[k]} want {want[k]}"
                 for k in sorted(set(got) & set(want)) if got[k] != want[k]]
    if problems:
        raise ValueError(f"{what} ({len(problems)} problems):\n  " + "\n  ".join(problems[:20]))


def load_params(module: nn.Module, params: Mapping,
                name_fn: Callable[[Tuple[str, ...]], str] = torch_name,
                entries_fn: Optional[EntriesFn] = None) -> nn.Module:
    """Load a JAX parameter tree into ``module`` (cast to its dtype)."""
    module.load_state_dict(convert_params(params, module, name_fn, entries_fn))
    return module


# ---------------------------------------------------------------------------
# the segmentation stage's trees: SAM, the OWL-ViT detector, the CLIP vision
# tower

_SAM_RENAMES = (
    (re.compile(r"^image_encoder\.patch_embed\."), "image_encoder.patch_embed.proj."),
    (re.compile(r"^image_encoder\.blocks_(\d+)\.(qkv|proj)\."), r"image_encoder.blocks.\1.attn.\2."),
    (re.compile(r"^image_encoder\.blocks_(\d+)\.(rel_pos_[hw])$"), r"image_encoder.blocks.\1.attn.\2"),
    (re.compile(r"^image_encoder\.blocks_(\d+)\.mlp_lin([12])\."), r"image_encoder.blocks.\1.mlp.lin\2."),
    (re.compile(r"^image_encoder\.blocks_(\d+)\."), r"image_encoder.blocks.\1."),
    (re.compile(r"^image_encoder\.neck_(conv|norm)([12])\."),
     lambda m: f"image_encoder.neck.{2 * int(m.group(2)) - (2 if m.group(1) == 'conv' else 1)}."),
    (re.compile(r"^prompt_encoder\.pe_gaussian$"),
     "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
    (re.compile(r"^prompt_encoder\.no_mask_embed$"), "prompt_encoder.no_mask_embed.weight"),
    (re.compile(r"^mask_decoder\.layers_(\d+)\.mlp_lin([12])\."),
     r"mask_decoder.transformer.layers.\1.mlp.lin\2."),
    (re.compile(r"^mask_decoder\.layers_(\d+)\."), r"mask_decoder.transformer.layers.\1."),
    (re.compile(r"^mask_decoder\.(final_attn_token_to_image|norm_final_attn)\."),
     r"mask_decoder.transformer.\1."),
    (re.compile(r"^mask_decoder\.(iou_token|mask_tokens)$"), r"mask_decoder.\1.weight"),
    (re.compile(r"^mask_decoder\.up1\."), "mask_decoder.output_upscaling.0."),
    (re.compile(r"^mask_decoder\.up_norm\."), "mask_decoder.output_upscaling.1."),
    (re.compile(r"^mask_decoder\.up2\."), "mask_decoder.output_upscaling.3."),
    (re.compile(r"^mask_decoder\.hyper_(\d+)_lin(\d)\."),
     r"mask_decoder.output_hypernetworks_mlps.\1.layers.\2."),
    (re.compile(r"^mask_decoder\.iou_lin(\d)\."), r"mask_decoder.iou_prediction_head.layers.\1."),
)
_VISION_RENAMES = (
    (re.compile(r"^layers_(\d+)\.(q_proj|k_proj|v_proj|out_proj)\."), r"encoder.layers.\1.self_attn.\2."),
    (re.compile(r"^layers_(\d+)\.(fc[12])\."), r"encoder.layers.\1.mlp.\2."),
    (re.compile(r"^layers_(\d+)\.(layer_norm[12])\."), r"encoder.layers.\1.\2."),
    (re.compile(r"^(patch_embedding\.weight|class_embedding)$"), r"embeddings.\1"),
    (re.compile(r"^position_embedding$"), "embeddings.position_embedding.weight"),
)
_DETECTOR_HEADS = (
    (re.compile(r"^merged_layer_norm\."), "layer_norm."),
    (re.compile(r"^class_head_dense0\."), "class_head.dense0."),
    (re.compile(r"^logit_(shift|scale)\."), r"class_head.logit_\1."),
    (re.compile(r"^box_head_dense(\d)\."), r"box_head.dense\1."),
)


def sam_entries(path: Tuple[str, ...], arr: np.ndarray):
    """A JAX SAM tree leaf → its segment-anything-named entries: the box
    corner table [2, D] becomes ``point_embeddings.2``/``.3`` [1, D],
    ``no_mask_embed`` [D] becomes [1, D], and the ``up1``/``up2``
    transposed-convolution kernels [kh, kw, in, out] become [in, out, kh,
    kw] flipped in both spatial axes (module docstring)."""
    if path == ("prompt_encoder", "corner_embed"):
        return [(f"prompt_encoder.point_embeddings.{i}.weight", arr[i - 2][None]) for i in (2, 3)]
    name = _renamed(path, _SAM_RENAMES)
    if path == ("prompt_encoder", "no_mask_embed"):
        return [(name, arr[None])]
    if path[:1] == ("mask_decoder",) and path[1] in ("up1", "up2") and path[-1] == "kernel":
        return [(name, arr[::-1, ::-1].transpose(2, 3, 0, 1))]
    return [(name, torch_layout(path, arr))]


def clip_vision_entries(path: Tuple[str, ...], arr: np.ndarray):
    """A JAX ``CLIPVisionModel`` tree leaf → its HF-named entry."""
    if path[0] == "visual_projection":
        return [("visual_projection.weight", arr.T)]
    return [("vision_model." + _renamed(path, _VISION_RENAMES), torch_layout(path, arr))]


def detector_entries(path: Tuple[str, ...], arr: np.ndarray):
    """A JAX ``TextBoxDetector`` tree leaf → its HF-named entry."""
    if path[0] == "vision_model":
        name = "owlvit.vision_model." + _renamed(path[1:], _VISION_RENAMES)
    elif path[0] == "text_model":
        name = "owlvit." + clip_torch_name(path[1:])
    else:
        name = _renamed(path, _DETECTOR_HEADS)
    return [(name, torch_layout(path, arr))]


# ---------------------------------------------------------------------------
# checkpoint files and directories in the diffusers / HF layout

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors_header(path: str) -> Tuple[Dict[str, dict], int]:
    """({name: {"dtype", "shape", "data_offsets"}}, offset of the data) of a
    ``.safetensors`` file; the ``__metadata__`` entry is dropped."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    for name, entry in header.items():
        dtype = _ST_DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has unsupported dtype {entry['dtype']}")
        start, end = entry["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != int(np.prod(entry["shape"], dtype=np.int64)) * itemsize:
            raise ValueError(f"{path}: {name} holds {end - start} bytes for shape {entry['shape']}")
    return header, 8 + n


def _read_tensor(f, entry: dict, data_start: int) -> torch.Tensor:
    start, end = entry["data_offsets"]
    dtype = _ST_DTYPES[entry["dtype"]]
    if end == start:
        return torch.empty(entry["shape"], dtype=dtype)
    buf = bytearray(end - start)
    f.seek(data_start + start)
    if f.readinto(buf) != len(buf):
        raise ValueError(f"{f.name}: file ends inside its tensor data")
    return torch.frombuffer(buf, dtype=dtype).reshape(entry["shape"])


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> int:
    """Write ``tensors`` as one ``.safetensors`` file, one tensor at a time
    (each is copied to the host on its own). Returns the bytes written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return 8 + len(blob) + offset


class CheckpointDir(Mapping):
    """The tensors of a checkpoint directory: its ``*.safetensors`` files
    (preferred), read one tensor at a time on access, or else its ``*.bin``
    files, loaded whole; or of one checkpoint file (``.safetensors``, or
    ``.bin``/``.pth`` through ``torch.load``). ``shapes`` holds every
    tensor's shape."""

    def __init__(self, path: str):
        if os.path.isfile(path):
            st_files, bin_files = ([path], []) if path.endswith(".safetensors") else ([], [path])
        else:
            files = sorted(os.listdir(path))
            st_files = [os.path.join(path, f) for f in files if f.endswith(".safetensors")]
            bin_files = [os.path.join(path, f) for f in files if f.endswith(".bin")]
        self.path = path
        self._where: Dict[str, Tuple[str, dict, int]] = {}
        self._loaded: Dict[str, torch.Tensor] = {}
        if st_files:
            for file in st_files:
                header, data_start = read_safetensors_header(file)
                for name, entry in header.items():
                    self._where[name] = (file, entry, data_start)
            self.shapes = {k: tuple(e["shape"]) for k, (_, e, _) in self._where.items()}
        elif bin_files:
            for file in bin_files:
                self._loaded.update(torch.load(file, map_location="cpu", weights_only=True))
            self.shapes = {k: tuple(v.shape) for k, v in self._loaded.items()}
        else:
            raise FileNotFoundError(f"no .safetensors or .bin files in {path}")

    def __getitem__(self, name: str) -> torch.Tensor:
        if name in self._loaded:
            return self._loaded[name]
        file, entry, data_start = self._where[name]
        with open(file, "rb") as f:
            return _read_tensor(f, entry, data_start)

    def __iter__(self) -> Iterator[str]:
        return iter(self.shapes)

    def __len__(self) -> int:
        return len(self.shapes)


# a self-attention's q/k/v in a checkpoint; they fill the module's merged
# to_qkv where it has one (every attn1, and the video UNet's temporal attn2)
_QKV_PART = re.compile(r"^(.*\.)to_([qkv])\.weight$")


def checkpoint_shapes(module: nn.Module) -> Dict[str, tuple]:
    """{checkpoint name: shape} of the tensors that fill ``module``: its
    state dict with a merged ``to_qkv`` [3·inner, C] split into
    ``to_q``/``to_k``/``to_v`` [inner, C], a concept stack ``to_k_stack``
    [S, in, out] read as the base ``to_k.weight`` [out, in], an int8
    ``weight_q`` as its float ``weight``, and neither the int8 scales nor
    the LoRA factors (they come from elsewhere)."""
    want = {}
    for key, t in module.state_dict(keep_vars=True).items():
        shape = tuple(t.shape)
        if key.endswith(("to_qkv.weight", "to_qkv.weight_q")):
            prefix = key[: key.rindex("to_qkv.")]
            for p in "qkv":
                want[f"{prefix}to_{p}.weight"] = (shape[0] // 3, shape[1])
        elif key.endswith("_stack"):
            want[key[: -len("_stack")] + ".weight"] = (shape[2], shape[1])
        elif key.endswith("weight_q"):
            want[key[: -len("_q")]] = shape
        elif not key.endswith("weight_scale") and not is_lora_factor(key):
            want[key] = shape
    return want


def checkpoint_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """A float module's state dict under its checkpoint names: each merged
    ``to_qkv`` split back into ``to_q``/``to_k``/``to_v`` (the inverse of
    the load for a module without concept slots or int8 weights)."""
    out = {}
    for key, t in module.state_dict().items():
        if key.endswith("weight_q") or key.endswith("_stack") or is_lora_factor(key):
            raise ValueError(f"{key}: only a float module without concept slots has a checkpoint form")
        if key.endswith("to_qkv.weight"):
            prefix = key[: -len("to_qkv.weight")]
            for p, part in zip("qkv", t.chunk(3, dim=0)):
                out[f"{prefix}to_{p}.weight"] = part
        else:
            out[key] = t
    return out


@torch.no_grad()
def load_checkpoint(module: nn.Module, source: Mapping[str, torch.Tensor], device,
                    concept_kvs: Sequence[Mapping] = (), concept_loras: Sequence[Mapping] = (),
                    ignore: Sequence[str] = ()) -> nn.Module:
    """Fill ``module``, built on the ``meta`` device, from checkpoint-named
    tensors (``CheckpointDir`` or a dict) and give it memory on ``device``.

    The names and shapes are checked against ``checkpoint_shapes(module)``
    first; names in ``ignore`` (buffers such as CLIP's ``position_ids``) are
    skipped. Then each tensor is read, moved to ``device`` and written into
    place: ``to_q``/``to_k``/``to_v`` into the merged ``to_qkv``, a
    cross-attention K/V into its concept stack (with ``concept_kvs``), a
    quantised weight as int8 and scales from its fp32 values. LoRA stacks
    come from ``concept_loras``. Raises if any entry of the module is left
    unfilled."""
    shapes = getattr(source, "shapes", None) or {k: tuple(v.shape) for k, v in source.items()}
    shapes = {k: tuple(v) for k, v in shapes.items() if k not in ignore}
    check_shapes(shapes, checkpoint_shapes(module),
                 f"checkpoint does not fit {type(module).__name__}")
    device = resolve_device(device)
    module.to_empty(device=device)
    targets = module.state_dict(keep_vars=True)
    merged = {k[: k.rindex("to_qkv.")] for k in targets if ".to_qkv." in k}
    filled = set()

    def put(key, value):
        targets[key].copy_(value)
        filled.add(key)

    def put_weight(key, w):
        prefix = key[: -len("weight")]
        if prefix + "weight_q" in targets:
            quantize = quantize_weight_int8 if w.ndim == 2 else quantize_weight_int8_conv
            wq, scale = quantize(w.float())
            put(prefix + "weight_q", wq)
            put(prefix + "weight_scale", scale)
            if key not in targets:
                return
        put(key, w)

    qkv_parts: Dict[str, Dict[str, torch.Tensor]] = {}
    for name in shapes:
        t = source[name].to(device)
        stack_key = name[: -len(".weight")] + "_stack"
        m = _QKV_PART.match(name)
        if stack_key in targets:
            put(stack_key, cd_stack(name, t, concept_kvs))
        elif m and m.group(1) in merged:
            parts = qkv_parts.setdefault(m.group(1), {})
            parts[m.group(2)] = t
            if len(parts) == 3:
                put_weight(f"{m.group(1)}to_qkv.weight", torch.cat([parts[p] for p in "qkv"]))
                del qkv_parts[m.group(1)]
        else:
            put_weight(name, t)
    for key, t in targets.items():
        if is_lora_factor(key):
            put(key, lora_stack(key, t.shape[1:], concept_loras, device=t.device))
    unfilled = sorted(set(targets) - filled)
    if unfilled:
        raise ValueError(f"{type(module).__name__}: {len(unfilled)} entries not filled "
                         f"from the checkpoint: {unfilled[:10]}")
    return module.eval()


def load_unet(source, config, device="cuda", concept_kvs: Sequence[Mapping] = (),
              concept_loras: Sequence[Mapping] = ()):
    """A ``UNet2DConditionModel(config)`` on ``device`` from a diffusers
    ``unet/`` directory (or checkpoint-named tensors), with the concept
    K/V stacks or LoRA factor stacks that ``config``'s slots hold."""
    from tweediemix_tpu_torch.models.unet2d import UNet2DConditionModel

    if isinstance(source, (str, os.PathLike)):
        source = CheckpointDir(source)
    return load_checkpoint(UNet2DConditionModel(config, device="meta"), source, device,
                           concept_kvs=concept_kvs, concept_loras=concept_loras)


# the I2VGen-XL UNet's spatial transformers project with 1x1 convolutions
# (diffusers' use_linear_projection=False); the port's take linear weights
_CONV_PROJECTION = re.compile(r"^(down_blocks\.\d+|up_blocks\.\d+|mid_block)\.attentions\.\d+\."
                              r"proj_(in|out)\.weight$")


class _LinearProjections(Mapping):
    """A checkpoint's tensors with each 1x1-conv projection [O, I, 1, 1]
    named by ``_CONV_PROJECTION`` read as a linear weight [O, I]."""

    def __init__(self, source: Mapping):
        self.source = source
        shapes = getattr(source, "shapes", None) or {k: tuple(v.shape) for k, v in source.items()}
        self.shapes = {k: self._squeezed(k, tuple(s)) for k, s in shapes.items()}

    @staticmethod
    def _squeezed(name: str, shape: tuple) -> tuple:
        if _CONV_PROJECTION.match(name) and len(shape) == 4 and shape[2:] == (1, 1):
            return shape[:2]
        return shape

    def __getitem__(self, name: str) -> torch.Tensor:
        t = self.source[name]
        return t.reshape(self.shapes[name]) if tuple(t.shape) != self.shapes[name] else t

    def __iter__(self) -> Iterator[str]:
        return iter(self.shapes)

    def __len__(self) -> int:
        return len(self.shapes)


def load_unet3d(source, config, device="cuda"):
    """A ``UNet3DConditionModel(config)`` on ``device`` from a diffusers
    ``I2VGenXLUNet`` ``unet/`` directory (or its named tensors), the
    counterpart of the JAX package's ``load_unet3d_params``. The names are
    diffusers' already; the spatial transformers' 1x1-conv ``proj_in``/
    ``proj_out`` are read as linear weights, each self-attention's q/k/v
    (the temporal blocks' ``attn2`` too) fill its merged ``to_qkv``, and
    under ``config.quant`` the quantised sites take int8 weights and scales
    from the fp32 values. A missing, unexpected or mis-shaped name raises."""
    from tweediemix_tpu_torch.models.unet3d import UNet3DConditionModel

    return load_checkpoint(UNet3DConditionModel(config, device="meta"),
                           _LinearProjections(_source(source)), device)


def vae_config_overrides(vae_dir: str) -> Dict:
    """``scaling_factor`` and, where the checkpoint's ``config.json`` sets
    both, ``latents_mean``/``latents_std``: keyword arguments for
    ``VAEConfig``; empty without the file."""
    path = os.path.join(vae_dir, "config.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        cfg = json.load(f)
    out = {}
    if cfg.get("scaling_factor") is not None:
        out["scaling_factor"] = float(cfg["scaling_factor"])
    if cfg.get("latents_mean") is not None and cfg.get("latents_std") is not None:
        out["latents_mean"] = tuple(float(v) for v in cfg["latents_mean"])
        out["latents_std"] = tuple(float(v) for v in cfg["latents_std"])
    return out


def load_vae(source, config, device="cuda"):
    """An ``AutoencoderKL(config)`` on ``device`` from a diffusers ``vae/``
    directory (or checkpoint-named tensors)."""
    from tweediemix_tpu_torch.models.vae import AutoencoderKL

    if isinstance(source, (str, os.PathLike)):
        source = CheckpointDir(source)
    return load_checkpoint(AutoencoderKL(config, device="meta"), source, device)


def load_clip_text_model(source, config, device="cuda"):
    """A ``CLIPTextModel(config)`` on ``device`` from an HF
    ``text_encoder``/``text_encoder_2`` directory (or HF-named tensors);
    the ``position_ids`` buffer older checkpoints carry is skipped."""
    from tweediemix_tpu_torch.models.clip import CLIPTextModel

    if isinstance(source, (str, os.PathLike)):
        source = CheckpointDir(source)
    return load_checkpoint(CLIPTextModel(config, device="meta"), source, device,
                           ignore=("text_model.embeddings.position_ids",))


# segment-anything's point- and mask-prompt parameters: the port prompts with
# boxes only and holds none of them
SAM_UNUSED_PREFIXES = ("prompt_encoder.point_embeddings.0.", "prompt_encoder.point_embeddings.1.",
                       "prompt_encoder.not_a_point_embed.", "prompt_encoder.mask_downscaling.")
# OWL-ViT's contrastive head and position-id buffers
DETECTOR_UNUSED = ("owlvit.visual_projection.weight", "owlvit.logit_scale",
                   "owlvit.text_model.embeddings.position_ids",
                   "owlvit.vision_model.embeddings.position_ids")


def _source(source) -> Mapping:
    return CheckpointDir(source) if isinstance(source, (str, os.PathLike)) else source


def load_sam(source, config, device="cuda"):
    """A ``SAM(config)`` on ``device`` from a segment-anything checkpoint:
    a ``.pth`` file (``torch.load(weights_only=True)``), a ``.safetensors``
    file, a directory of either, or its named tensors. The point- and
    mask-prompt parameters (``SAM_UNUSED_PREFIXES``) are skipped; any other
    name the module lacks raises."""
    from tweediemix_tpu_torch.segmentation.sam import SAM

    source = _source(source)
    ignore = [k for k in source if k.startswith(SAM_UNUSED_PREFIXES)]
    return load_checkpoint(SAM(config, device="meta"), source, device, ignore=ignore)


def load_detector(source, config, device="cuda"):
    """A ``TextBoxDetector(config)`` on ``device`` from an HF
    ``OwlViTForObjectDetection`` directory (or its named tensors); the
    contrastive head and position-id buffers (``DETECTOR_UNUSED``) are
    skipped."""
    from tweediemix_tpu_torch.segmentation.detector import TextBoxDetector

    return load_checkpoint(TextBoxDetector(config, device="meta"), _source(source), device,
                           ignore=DETECTOR_UNUSED)


def load_clip_vision_model(source, config, device="cuda"):
    """A ``CLIPVisionModel(config)`` on ``device`` from an HF
    ``CLIPVisionModelWithProjection`` directory (or HF-named tensors); the
    ``position_ids`` buffer older checkpoints carry is skipped."""
    from tweediemix_tpu_torch.models.clip import CLIPVisionModel

    return load_checkpoint(CLIPVisionModel(config, device="meta"), _source(source), device,
                           ignore=("vision_model.embeddings.position_ids",))


# ---------------------------------------------------------------------------
# GroundingDINO: the JAX tree, HF-layout directories and the original
# groundingdino repo's single .pth (the reference's groundingdino_swinb_cogcoor)


def dino_entries(path: Tuple[str, ...], arr: np.ndarray):
    """A JAX ``GroundingDino`` tree leaf → its port entry: the names are
    the tree's (``kernel``/``scale``/``embedding`` → ``weight``), Dense
    kernels transposed, conv kernels HWIO → OIHW; the tables
    (relative-position bias, BERT's embeddings, ``level_embed``, the
    layer-scale vectors) keep their layout."""
    name = ".".join(path[:-1] + ({"kernel": "weight", "scale": "weight",
                                  "embedding": "weight"}.get(path[-1], path[-1]),))
    return [(name, torch_layout(path, arr))]


def _dino_original_to_hf(names: Sequence[str]) -> Dict[str, Tuple[str, Optional[int]]]:
    """The original groundingdino repo's names → HF
    ``GroundingDinoForObjectDetection``'s, as {HF name: (original name,
    part)}: a merged Swin ``attn.qkv`` or text/decoder ``in_proj_*`` gives
    three HF names, ``part`` 0/1/2 its q/k/v third along axis 0 (else
    None). The JAX package's ``_dino_original_to_hf`` rename, name for
    name; a later name for the same HF name replaces an earlier one, and a
    name it does not know passes through unchanged."""
    out: Dict[str, Tuple[str, Optional[int]]] = {}
    qkv = (("query", 0), ("key", 1), ("value", 2))
    for name in names:
        n = name[len("module."):] if name.startswith("module.") else name
        if n.startswith("backbone.0."):
            n = n[len("backbone.0."):]
            if n.startswith("patch_embed.proj"):
                n = n.replace("patch_embed.proj", "embeddings.patch_embeddings.projection")
            elif n.startswith("patch_embed.norm"):
                n = n.replace("patch_embed.norm", "embeddings.norm")
            elif re.match(r"norm(\d)\.", n):
                n = f"hidden_states_norms.stage{int(n[4]) + 1}." + n.split(".", 1)[1]
            else:
                n = "encoder." + n
                for old, new in ((".norm1.", ".layernorm_before."), (".norm2.", ".layernorm_after."),
                                 (".attn.proj.", ".attention.output.dense."),
                                 (".attn.relative_position_bias_table",
                                  ".attention.self.relative_position_bias_table"),
                                 (".attn.relative_position_index",
                                  ".attention.self.relative_position_index"),
                                 (".mlp.fc1.", ".intermediate.dense."), (".mlp.fc2.", ".output.dense.")):
                    n = n.replace(old, new)
                if ".attn.qkv." in n:
                    for p, i in qkv:
                        out["model.backbone.conv_encoder.model."
                            + n.replace(".attn.qkv.", f".attention.self.{p}.")] = (name, i)
                    continue
            out["model.backbone.conv_encoder.model." + n] = (name, None)
            continue
        if n.startswith("bert."):
            if "pooler" not in n and not n.endswith("position_ids"):
                out["model.text_backbone." + n[len("bert."):]] = (name, None)
            continue
        prefixes = (("feat_map.", "model.text_projection."), ("input_proj.", "model.input_proj_vision."),
                    ("bbox_embed.", "bbox_embed."))
        hit = next(((old, new) for old, new in prefixes if n.startswith(old)), None)
        if hit:
            out[hit[1] + n[len(hit[0]):]] = (name, None)
            continue
        if n.startswith("transformer."):
            n = n[len("transformer."):]
            if n == "level_embed":
                out["model.level_embed"] = (name, None)
                continue
            if n.startswith("tgt_embed."):
                out["model.query_position_embeddings.weight"] = (name, None)
                continue
            prefixes = (("enc_output.", "model.enc_output."), ("enc_output_norm.", "model.enc_output_norm."),
                        ("enc_out_bbox_embed.", "model.encoder_output_bbox_embed."),
                        ("decoder.bbox_embed.", "bbox_embed."),
                        ("decoder.norm.", "model.decoder.layer_norm."),
                        ("decoder.ref_point_head.", "model.decoder.reference_points_head."))
            hit = next(((old, new) for old, new in prefixes if n.startswith(old)), None)
            if hit:
                out[hit[1] + n[len(hit[0]):]] = (name, None)
                continue
            m = re.match(r"encoder\.layers\.(\d+)\.(.*)", n)
            if m:
                rest = (m.group(2).replace("linear1.", "fc1.").replace("linear2.", "fc2.")
                        .replace("norm1.", "self_attn_layer_norm.").replace("norm2.", "final_layer_norm."))
                out[f"model.encoder.layers.{m.group(1)}.deformable_layer.{rest}"] = (name, None)
                continue
            m = re.match(r"encoder\.text_layers\.(\d+)\.(.*)", n)
            if m:
                rest = (m.group(2).replace("linear1.", "fc1.").replace("linear2.", "fc2.")
                        .replace("norm1.", "layer_norm_before.").replace("norm2.", "layer_norm_after."))
                base = f"model.encoder.layers.{m.group(1)}.text_enhancer_layer."
                if "self_attn.in_proj_" in rest:
                    leaf = "weight" if rest.endswith("weight") else "bias"
                    for p, i in qkv:
                        out[base + f"self_attn.{p}.{leaf}"] = (name, i)
                    continue
                out[base + rest] = (name, None)
                continue
            m = re.match(r"encoder\.fusion_layers\.(\d+)\.(.*)", n)
            if m:
                rest = m.group(2)
                for old, new in (("gamma_v", "vision_param"), ("gamma_l", "text_param"),
                                 ("layer_norm_v.", "layer_norm_vision."),
                                 ("layer_norm_l.", "layer_norm_text."),
                                 ("attn.values_v_proj.", "attn.values_vision_proj."),
                                 ("attn.values_l_proj.", "attn.values_text_proj."),
                                 ("attn.out_v_proj.", "attn.out_vision_proj."),
                                 ("attn.out_l_proj.", "attn.out_text_proj."),
                                 ("attn.v_proj.", "attn.vision_proj."), ("attn.l_proj.", "attn.text_proj.")):
                    rest = rest.replace(old, new)
                out[f"model.encoder.layers.{m.group(1)}.fusion_layer.{rest}"] = (name, None)
                continue
            m = re.match(r"decoder\.layers\.(\d+)\.(.*)", n)
            if m:
                rest = m.group(2)
                for old, new in (("cross_attn_text.", "encoder_attn_text."),
                                 ("ca_text.", "encoder_attn_text."),
                                 ("catext_norm.", "encoder_attn_text_layer_norm."),
                                 ("cross_attn.", "encoder_attn."), ("norm1.", "encoder_attn_layer_norm."),
                                 ("norm2.", "self_attn_layer_norm."), ("norm3.", "final_layer_norm."),
                                 ("linear1.", "fc1."), ("linear2.", "fc2.")):
                    rest = rest.replace(old, new)
                base = f"model.decoder.layers.{m.group(1)}."
                if "in_proj_" in rest:
                    leaf = "weight" if rest.endswith("weight") else "bias"
                    mod = rest.split(".in_proj_")[0]
                    for p, i in qkv:
                        out[base + f"{mod}.{p}.{leaf}"] = (name, i)
                    continue
                out[base + rest] = (name, None)
                continue
        out[n] = (name, None)
    return out


_DINO_SWIN_RENAMES = (
    (re.compile(r"encoder\.layers\.(\d+)\.blocks\.(\d+)\."), r"layers_\1_blocks_\2."),
    (re.compile(r"encoder\.layers\.(\d+)\.downsample\."), r"layers_\1_downsample."),
    (re.compile(r"output\.dense\.(weight|bias)$"), r"output.\1"),
    (re.compile(r"hidden_states_norms\.stage(\d+)"), r"norm_stage\1"),
)


def _dino_hf_to_port(name: str) -> Optional[str]:
    """An HF ``GroundingDinoForObjectDetection`` name → the port's, or None
    for what the port does not hold: the ``position_ids`` and
    ``relative_position_index`` buffers and every copy of the shared box
    head but ``bbox_embed.0`` (top level or under ``model.decoder.``). The
    JAX package's ``convert_grounding_dino_state_dict`` renames, without
    its layout changes."""
    n = name
    if n.endswith("position_ids") or n.endswith("relative_position_index"):
        return None
    m = re.match(r"(?:model\.decoder\.)?bbox_embed\.(\d+)\.(.*)", n)
    if m:
        if m.group(1) != "0":
            return None
        n = "bbox_embed." + m.group(2)
    if n.startswith("model."):
        n = n[len("model."):]
    if n.startswith("backbone.conv_encoder.model."):
        n = n[len("backbone.conv_encoder.model."):]
        n = n.replace("embeddings.patch_embeddings.projection", "patch_embed")
        n = n.replace("embeddings.norm", "patch_norm")
        n = _DINO_SWIN_RENAMES[0][0].sub(_DINO_SWIN_RENAMES[0][1], n)
        n = _DINO_SWIN_RENAMES[1][0].sub(_DINO_SWIN_RENAMES[1][1], n)
        n = n.replace("attention.self.", "attention.").replace("attention.output.dense", "attention.out")
        n = n.replace("intermediate.dense", "intermediate")
        n = _DINO_SWIN_RENAMES[2][0].sub(_DINO_SWIN_RENAMES[2][1], n)
        n = "backbone." + _DINO_SWIN_RENAMES[3][0].sub(_DINO_SWIN_RENAMES[3][1], n)
    elif n.startswith("text_backbone."):
        n = n[len("text_backbone."):]
        for old, new in (("embeddings.word_embeddings.weight", "word_embeddings"),
                         ("embeddings.position_embeddings.weight", "position_embeddings"),
                         ("embeddings.token_type_embeddings.weight", "token_type_embeddings"),
                         ("embeddings.LayerNorm", "embeddings_norm")):
            n = n.replace(old, new)
        n = re.sub(r"encoder\.layer\.(\d+)\.", r"layer_\1.", n)
        for old, new in (("attention.self.", ""), ("attention.output.dense", "attn_out"),
                         ("attention.output.LayerNorm", "attn_norm"), ("intermediate.dense", "intermediate"),
                         ("output.dense", "output"), ("output.LayerNorm", "output_norm")):
            n = n.replace(old, new)
        n = "text_backbone." + n
    elif re.match(r"input_proj_vision\.(\d+)\.(0|1)\.", n):
        m = re.match(r"input_proj_vision\.(\d+)\.(0|1)\.(.*)", n)
        n = f"input_proj_{m.group(1)}_{'conv' if m.group(2) == '0' else 'norm'}.{m.group(3)}"
    elif n.startswith("encoder.layers."):
        n = re.sub(r"encoder\.layers\.(\d+)\.", r"encoder_layers_\1.", n)
    elif n.startswith("decoder.layers."):
        n = re.sub(r"decoder\.layers\.(\d+)\.", r"decoder_layers_\1.", n)
    elif n.startswith("decoder.layer_norm."):
        n = n.replace("decoder.layer_norm.", "decoder_layer_norm.")
    elif n.startswith("decoder.reference_points_head."):
        n = n.replace("decoder.reference_points_head.", "reference_points_head.")
    return re.sub(r"layers\.(\d+)\.", r"layers_\1.", n)


def dino_checkpoint_names(names: Sequence[str]) -> Dict[str, Tuple[str, Optional[int]]]:
    """A GroundingDINO checkpoint's names (HF layout, or the original
    repo's, told apart as the JAX package does: any ``transformer.``,
    ``bert.``, ``backbone.0.`` or ``module.`` name) → {port name:
    (checkpoint name, q/k/v part or None)}. Of the box head's copies the
    first ``bbox_embed.0`` in the checkpoint's order is read."""
    if any(k.startswith(("transformer.", "bert.", "backbone.0.", "module.")) for k in names):
        hf = _dino_original_to_hf(names)
    else:
        hf = {k: (k, None) for k in names}
    out: Dict[str, Tuple[str, Optional[int]]] = {}
    for hf_name, src in hf.items():
        port = _dino_hf_to_port(hf_name)
        if port is None or (port in out and port.startswith("bbox_embed.")):
            continue
        out[port] = src
    return out


class _Parts(Mapping):
    """The tensors of ``source`` under new names, ``names`` = {new: (old,
    part)}: part i reads the i-th third of the old tensor along axis 0."""

    def __init__(self, source: Mapping, names: Mapping[str, Tuple[str, Optional[int]]]):
        self.source, self.names = source, dict(names)
        shapes = getattr(source, "shapes", None) or {k: tuple(v.shape) for k, v in source.items()}
        self.shapes = {}
        for new, (old, part) in self.names.items():
            shape = tuple(shapes[old])
            self.shapes[new] = shape if part is None else (shape[0] // 3,) + shape[1:]

    def __getitem__(self, name: str) -> torch.Tensor:
        old, part = self.names[name]
        t = self.source[old]
        return t if part is None else t.chunk(3, dim=0)[part]

    def __iter__(self) -> Iterator[str]:
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)


def read_dino_checkpoint(source) -> Mapping:
    """A GroundingDINO checkpoint's named tensors: an HF-layout directory
    (``CheckpointDir``), or the original repo's single file
    (``torch.load(weights_only=True)``, its ``"model"`` entry where it has
    one). Raises naming the path where there is nothing, or nothing that
    loads."""
    if not isinstance(source, (str, os.PathLike)):
        return source
    path = os.fspath(source)
    if os.path.isdir(path):
        return CheckpointDir(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no GroundingDINO checkpoint at {path}")
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except (EOFError, pickle.UnpicklingError, RuntimeError) as e:
        raise ValueError(f"{path}: torch.load cannot read it as a GroundingDINO checkpoint "
                         f"({type(e).__name__}: {e})") from e
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, Mapping) else None
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: holds a {type(ckpt).__name__}, not a state dict")
    return sd


def load_dino(source, config, device="cuda"):
    """A ``GroundingDino(config)`` on ``device`` from a GroundingDINO
    checkpoint (``read_dino_checkpoint``: an HF directory or the original
    ``.pth``, or named tensors), the counterpart of the JAX package's
    ``load_dino_params``: the original layout renamed to HF's and its
    merged q/k/v split, HF's names mapped to the port's, buffers and the
    box head's extra copies skipped. A missing, unexpected or mis-shaped
    name raises."""
    from tweediemix_tpu_torch.models.dino import GroundingDino

    device = resolve_device(device)
    tensors = read_dino_checkpoint(source)
    return load_checkpoint(GroundingDino(config, device="meta"),
                           _Parts(tensors, dino_checkpoint_names(list(tensors))), device)
