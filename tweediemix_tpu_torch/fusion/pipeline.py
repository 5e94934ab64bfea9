"""Multi-concept fusion pipeline: prompts → embeddings → sampler → VAE
decode (counterpart of ``tweediemix_tpu/fusion/pipeline.py``).

The prompt contract of the reference's sample scripts:

* ``prompt``: ``+``-separated per-concept prompts, background LAST;
* ``prompt_orig``: the joint multi-concept prompt;
* ``concepts`` / ``modifier_token``: ``+``-separated, in the same order;
  each concept prompt gets its modifier token inserted just before the
  concept word;
* the resampling prologue's single-concept prompts are the RAW per-concept
  prompts of the foreground concepts (without modifier tokens);
* per-concept checkpoints supply modifier-token embeddings for both text
  encoders and Custom-Diffusion K/V (or LoRA) deltas.

``from_concept_checkpoints`` builds the UNet once with its concept slots and
fills it from the base checkpoint and the deltas (``models/convert.py``);
the pipeline also runs from a UNet and a VAE that already hold their
weights (``from_random_weights``, or converted JAX trees) and precomputed
text embeddings.

``sample(..., mesh_devices=n)`` shards every UNet forward's rows over a
one-axis mesh (``parallel/mesh.py``): ``n`` devices (``cuda:0`` ..
``cuda:n-1``; on the CPU, the CPU n times) or a ``Mesh``, as the JAX
package's ``sample`` does. The meshed sampler runs each shard on its
device's UNet replica and, as in the JAX package, without the cross-K/V
cache, so a meshed W8A8 sample quantises the K/V projections the cache
would have run in float.

On a card the unsharded sampler's UNet calls go through CUDA graphs
(``models/unet_graph.py``, ``unet_graphs``): one per call shape, captured
at its first call and replayed after, the cross-attention K/V built inside
the graph instead of a per-phase cache, so a call costs the host a few
copies and one graph launch and no synchronisation. On the CPU, under
autograd and over a mesh the calls stay eager.

Numerics: the reference decodes in fp32. cuDNN would run fp32 convolutions
in TF32 by default, so the pipeline turns TF32 off for matmuls
(``torch.backends.cuda.matmul.allow_tf32 = False``) and convolutions
(``torch.backends.cudnn.allow_tf32 = False``) in this process.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from tweediemix_tpu_torch.concepts.delta import cd_delta_from_reference, lora_delta_from_reference
from tweediemix_tpu_torch.device import resolve_device
from tweediemix_tpu_torch.fusion.sampler import FusionConfig, FusionSampler, TextEmbeds
from tweediemix_tpu_torch.models.clip import DualTextEncoder
from tweediemix_tpu_torch.models.convert import load_unet
from tweediemix_tpu_torch.models.unet2d import (
    UNet2DConditionModel,
    UNetConfig,
    precompute_cross_kv,
)
from tweediemix_tpu_torch.models.unet_graph import UNetGraphs
from tweediemix_tpu_torch.models.vae import (
    AutoencoderKL,
    VAEConfig,
    postprocess_image,
    unscale_latents,
)
from tweediemix_tpu_torch.parallel.mesh import as_mesh, replicate, seed_sharded_unet_fn
from tweediemix_tpu_torch.schedulers.ddim import DDIMTable
from tweediemix_tpu_torch.utils.image import write_png
from tweediemix_tpu_torch.utils.profiling import phase, span


def stack_text_embeds(embeds_list: Sequence[TextEmbeds]) -> TextEmbeds:
    """Stack S per-seed TextEmbeds into one (each leaf gains a per-seed axis
    at position 1), so seed row s of a batched trajectory samples prompt
    set s. Pass with ``num_seeds == S``."""
    return TextEmbeds(*(torch.stack(parts, dim=1) for parts in zip(*embeds_list)))


def insert_modifier(prompt: str, concept: str, modifier: str) -> str:
    """``"photo of a cat running"`` + cat/<cat1> → ``"photo of a <cat1> cat
    running"``; without the concept word the modifier goes first."""
    idx = prompt.find(concept)
    if idx < 0:
        return f"{modifier} {prompt}"
    return prompt[:idx] + modifier + " " + prompt[idx:]


class TweedieMixPipeline:
    def __init__(
        self,
        unet: UNet2DConditionModel,
        vae: AutoencoderKL,
        fusion_config: FusionConfig,
        table: Optional[DDIMTable] = None,
        segment_fn=None,
        device="cuda",
        text: Optional[DualTextEncoder] = None,
        tokenizer_1=None,
        tokenizer_2=None,
    ):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.unet = unet.to(self.device).eval()
        # the UNet call of the unsharded sampler: a CUDA graph per call shape on a card
        self.unet_graphs = UNetGraphs(self.unet)
        self._time_ids_by_key: dict = {}  # (device, rows) -> time_ids [rows, 6]
        self.vae = vae.to(self.device).eval()
        self.text = text
        if text is not None:
            text.model1.to(self.device)
            text.model2.to(self.device)
        self.tokenizer_1 = tokenizer_1
        self.tokenizer_2 = tokenizer_2
        self.fusion_config = fusion_config
        self.table = table or DDIMTable.create(n_steps=fusion_config.n_timesteps)
        self.sampler = FusionSampler(
            self.table, fusion_config, self._unet_fn,
            decode_preview_fn=self.decode_preview, segment_fn=segment_fn,
            kv_builder=self._kv_builder,
        )
        # samplers by mesh (1: unsharded, the one built here); ``sampler``
        # is the one the last sample() ran
        self._samplers = {1: self.sampler}
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

    @classmethod
    def from_concept_checkpoints(
        cls,
        base_unet,
        checkpoints: Sequence[dict],
        modifier_tokens: Sequence[str],
        unet_config: UNetConfig,
        vae: AutoencoderKL,
        text: DualTextEncoder,
        tokenizer_1,
        tokenizer_2,
        fusion_config: FusionConfig,
        mode: str = "cd",
        segment_fn=None,
        device="cuda",
    ) -> "TweedieMixPipeline":
        """Wire N loaded reference deltas (``concepts.delta.load_reference_delta``)
        into a UNet with N+1 concept slots and into both text towers.

        ``base_unet`` is the base UNet checkpoint: a diffusers ``unet/``
        directory, a ``CheckpointDir`` or checkpoint-named tensors. The UNet
        is built once, with ``concept_slots`` (``mode="cd"``: stacked
        cross-attention K/V) or ``lora_slots`` (``mode="lora"``) = N+1, and
        filled from ``base_unet`` and the deltas. Text-tower state dicts of
        ``--train_text_encoder`` checkpoints are loaded first (the last one
        wins, with a warning when there are several, as the reference's
        sequential loads do); then each modifier token is added to both
        tokenizers and its rows to both embedding tables."""
        device = resolve_device(device)
        n = len(checkpoints)
        te_states = [st for st in checkpoints if "text_encoder" in st]
        if te_states:
            if len(te_states) > 1:
                warnings.warn(
                    f"{len(te_states)} concept checkpoints carry full text-encoder weights; "
                    "applying the last (the reference's sequential load_state_dict behavior)")
            text.load_tower_state(te_states[-1].get("text_encoder"),
                                  te_states[-1].get("text_encoder_2"))
        ids1, ids2, rows1, rows2 = [], [], [], []
        for tok, st in zip(modifier_tokens, checkpoints):
            if not st.get("modifier_token"):
                continue
            tokenizer_1.add_tokens(tok)
            tokenizer_2.add_tokens(tok)
            ids1.append(tokenizer_1.convert_tokens_to_ids(tok))
            ids2.append(tokenizer_2.convert_tokens_to_ids(tok))
            # a checkpoint stores {its own token name: embedding}
            rows1.append(next(iter(st["modifier_token"].values())))
            rows2.append(next(iter(st["modifier_token_2"].values())))
        if ids1:
            text.add_modifier_tokens(ids1, rows1, ids2, rows2)

        if mode == "cd":
            unet = load_unet(base_unet, dataclasses.replace(unet_config, concept_slots=n + 1),
                             device, concept_kvs=[cd_delta_from_reference(st) for st in checkpoints])
        elif mode == "lora":
            unet = load_unet(base_unet, dataclasses.replace(unet_config, lora_slots=n + 1),
                             device, concept_loras=[lora_delta_from_reference(st) for st in checkpoints])
        else:
            raise ValueError(f"mode must be 'cd' or 'lora', got {mode!r}")
        return cls(unet, vae, fusion_config, segment_fn=segment_fn, device=device, text=text,
                   tokenizer_1=tokenizer_1, tokenizer_2=tokenizer_2)

    # -- text ------------------------------------------------------------------

    def encode_prompts(self, prompts: List[str]):
        """Prompts → (ctx [B, 77, 2048], pooled [B, 1280]) on the towers' device."""
        return self.text.encode_ids(self.tokenizer_1(prompts), self.tokenizer_2(prompts))

    def prepare_text_embeds(self, prompt: str, prompt_orig: str, concepts: str,
                            modifier_token: str, negative_prompt: str = "") -> TextEmbeds:
        """The sample scripts' ``+``-separated contract (module docstring)."""
        prompt_sep = prompt.split("+")
        concept_list = concepts.split("+")
        modifiers = modifier_token.split("+")
        n = len(concept_list)
        if len(prompt_sep) != n or len(modifiers) != n:
            raise ValueError(
                f"--prompt ({len(prompt_sep)} rows), --concepts ({n}) and "
                f"--modifier_token ({len(modifiers)}) must all have the same "
                "number of '+'-separated entries (background last)"
            )
        if n != self.fusion_config.num_concepts:
            raise ValueError(f"{n} concepts for a pipeline built for "
                             f"{self.fusion_config.num_concepts}")
        multi = prompt_orig.split("+")[0]
        per_concept = [insert_modifier(prompt_sep[i], concept_list[i], modifiers[i])
                       for i in range(n)]
        singles = prompt_sep[: n - 1]

        uncond_ctx, uncond_pooled = self.encode_prompts([negative_prompt])
        multi_ctx, multi_pooled = self.encode_prompts([multi])
        single_ctx, single_pooled = self.encode_prompts(singles)
        concept_ctx, concept_pooled = self.encode_prompts(per_concept)
        return TextEmbeds(
            joint_ctx=torch.cat([uncond_ctx, multi_ctx]),
            joint_pooled=torch.cat([uncond_pooled, multi_pooled]),
            single_ctx=single_ctx,
            single_pooled=single_pooled,
            concept_ctx=torch.cat([uncond_ctx, concept_ctx]),
            concept_pooled=torch.cat([uncond_pooled, concept_pooled]),
        )

    # -- sampling ----------------------------------------------------------------

    def _time_ids(self, rows: int, device) -> torch.Tensor:
        """SDXL's size conditioning [rows, 6], built once per (device, rows):
        a copy from host memory synchronises with the host."""
        key = (device, rows)
        if key not in self._time_ids_by_key:
            cfg = self.fusion_config
            self._time_ids_by_key[key] = torch.tensor(
                [[cfg.height, cfg.width, 0, 0, cfg.height, cfg.width]],
                dtype=torch.float32, device=device,
            ).expand(rows, 6)
        return self._time_ids_by_key[key]

    def _unet_fn(self, x, t, ctx, pooled, idx, cross_kv=None, unet=None):
        """One UNet call. The pipeline's own call (no ``unet`` replica, no
        ``cross_kv``) goes through ``unet_graphs``, which builds the K/V
        inside its graph on a card and runs eagerly elsewhere."""
        time_ids = self._time_ids(x.shape[0], x.device)
        if unet is None and cross_kv is None:
            return self.unet_graphs(x, t, ctx, pooled, time_ids, idx)
        return (unet or self.unet)(x, t, ctx, pooled, time_ids, idx, cross_kv=cross_kv)

    def _kv_builder(self, ctx_rows, idx):
        """A phase's cross-attention K/V cache; None where the UNet call's
        graph builds it (``UNetGraphs.engages``)."""
        if self.unet_graphs.engages(ctx_rows):
            return None
        return precompute_cross_kv(self.unet, ctx_rows, idx)

    @torch.inference_mode()
    def decode_preview(self, x0):
        z = unscale_latents(x0.float(), self.vae.config, preview=True)
        return postprocess_image(self.vae.decode(z))

    @torch.inference_mode()
    def decode_final(self, x):
        z = unscale_latents(x.float(), self.vae.config)
        return postprocess_image(self.vae.decode(z))

    def sampler_for(self, mesh_devices=1) -> FusionSampler:
        """The sampler for ``mesh_devices`` (an int or a ``Mesh``), built at
        its first use and kept: over a mesh, ``seed_sharded_unet_fn`` on one
        UNet replica per device and no cross-K/V cache (the sharded call
        owns its row layout, as in the JAX package)."""
        if mesh_devices == 1:
            return self._samplers[1]
        key = mesh_devices
        if key not in self._samplers:
            mesh = as_mesh(mesh_devices, self.device)
            fns = [functools.partial(self._unet_fn, unet=unet)
                   for unet in replicate(mesh, self.unet)]
            self._samplers[key] = FusionSampler(
                self.table, self.fusion_config, seed_sharded_unet_fn(mesh, fns),
                decode_preview_fn=self.decode_preview, segment_fn=self._samplers[1].segment_fn,
            )
        return self._samplers[key]

    @torch.inference_mode()
    def sample(self, embeds: TextEmbeds, seed: int = 0, fg_masks=None, num_seeds: int = 1,
               x_init: Optional[torch.Tensor] = None, mesh_devices=1):
        """Run the fusion trajectory and decode each seed; returns
        [S, H, W, 3] in [0, 1]. ``mesh_devices`` > 1 (or a ``Mesh``) shards
        every forward's rows over that many devices (``sampler_for``)."""
        self.sampler = self.sampler_for(mesh_devices)
        with span("request", seed=seed, rows=num_seeds):
            x = self.sampler.run(embeds, seed, fg_masks=fg_masks, num_seeds=num_seeds,
                                 x_init=x_init)
            secs = dict(self.sampler.phase_seconds)
            with phase(secs, "decode", self.device):
                imgs = torch.cat([self.decode_final(x[s : s + 1]) for s in range(x.shape[0])],
                                 dim=0)
        self.phase_seconds = secs
        self.last_latent = x
        return imgs


def save_image(img: torch.Tensor, path: str) -> None:
    """[1, H, W, 3] float [0, 1] → an 8-bit RGB PNG (``utils/image.py``, so
    no imaging package is needed); values are truncated to integers as
    ``uint8`` casts do."""
    write_png(path, (img[0].float().cpu().numpy() * 255.0).astype(np.uint8))
