"""Multi-concept fusion sampling CLI (counterpart of
``tweediemix_tpu/cli/fusion_sampling.py``, with the same flags and defaults).

    python -m tweediemix_tpu_torch.cli.fusion_sampling --model_dir SDXL_DIR \\
        --personal_checkpoint delta-cat.bin+delta-dog.bin+delta-mountain.bin \\
        --prompt "photo of a cat running+photo of a dog running+mountain background" \\
        --prompt_orig "photo of a cat and a dog running" \\
        --concepts cat+dog+mountain --modifier_token "<cat1>+<dog1>+<mountain1>" \\
        --seg_concepts "a cat+a dog"

``+``-separated prompt, concept, modifier and checkpoint lists, background
concept last; ``--mode`` picks Custom-Diffusion or LoRA checkpoints
(``--t_stop`` sets the LoRA fusion window). Weights come from
``--model_dir`` (a local SDXL checkpoint directory in the diffusers layout)
or ``--model_preset tiny`` (seeded random small models for smoke runs).
Masks come from ``--mask_dir`` (``<seg_concept>.png`` per concept, as the
port's ``cli/segment.py`` writes them; the JAX package's ``.jpg`` where PIL
is installed) or from the in-process segmentation stage at the sampler's
boundary step: SAM ViT-H and a detector from
``--sam_checkpoint``/``--detector_dir`` (the ``sam`` preset, chosen when
both are given: the OWL-ViT detector from an HF directory, or the
reference's GroundingDINO Swin-B from its ``.pth`` or an HF directory with
``vocab.txt`` beside it, ``--detector dino`` or found by ``auto``),
``sam-random`` or the weights-free ``heuristic``.

It runs on the card; ``main(argv, device="cpu")`` runs the plain versions
on the CPU. ``--device`` and ``--seg_gpu`` are accepted for the reference's
scripts and only warn. ``--profile DIR`` writes a ``torch.profiler``
Chrome trace of the sample and the PNG writes (``DIR/trace.json``), the
program's spans recorded meanwhile (``DIR/spans.json``, on the trace's
clock) and ``DIR/phase_timings.json`` (the ``request`` span's seconds under
``sample_<N>_seeds``). ``--mesh_devices n`` shards every UNet
forward's rows over ``cuda:0`` .. ``cuda:n-1`` (on the CPU, the CPU n times;
``parallel/mesh.py``). The kernels are built into the compile cache's
directory (``utils/compile_cache.py``, ``TWEEDIEMIX_COMPILE_CACHE``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=182)
    p.add_argument("--output_path", type=str, default="./out")
    p.add_argument("--output_path_all", type=str, default=None)
    p.add_argument("--negative_prompt", type=str,
                   default="blurry, ugly, black, low res, unrealistic, blurry face")
    p.add_argument("--sd_version", type=str, default="xl", choices=["xl"],
                   help="model family (SDXL only)")
    p.add_argument("--t_cond", type=float, default=0.4)
    p.add_argument("--t_stop", type=float, default=None,
                   help="LoRA fusion window end (default 0.9 in --mode lora; unused in cd)")
    p.add_argument("--guidance_scale", type=float, default=9.0)
    p.add_argument("--n_timesteps", type=int, default=50)
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--prompt_orig", type=str, default="")
    p.add_argument("--seg_concepts", type=str, default="")
    p.add_argument("--personal_checkpoint", type=str, default="")
    p.add_argument("--concepts", type=str, required=True)
    p.add_argument("--modifier_token", type=str, required=True)
    p.add_argument("--resampling_steps", type=int, default=10)
    p.add_argument("--jumping_steps", type=int, default=5)
    p.add_argument("--crops_coords_top_left_h", type=int, default=0)
    p.add_argument("--crops_coords_top_left_w", type=int, default=0)
    p.add_argument("--resolution_h", type=int, default=1024)
    p.add_argument("--resolution_w", type=int, default=1024)
    # the reference's placement flags, accepted for its scripts; they only warn
    p.add_argument("--device", type=str, default=None, help=argparse.SUPPRESS)
    p.add_argument("--seg_gpu", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--mode", type=str, default="cd", choices=["cd", "lora"])
    p.add_argument("--model_dir", type=str, default=None,
                   help="local SDXL checkpoint dir (diffusers layout)")
    p.add_argument("--model_preset", type=str, default=None, choices=[None, "tiny"],
                   help="seeded random small models for smoke runs (no weights needed)")
    p.add_argument("--mask_dir", type=str, default=None,
                   help="directory with precomputed '<seg_concept>.png' masks "
                        "(or '.jpg' where PIL is installed)")
    p.add_argument("--seg_preset", type=str, default=None,
                   choices=[None, "heuristic", "sam-random", "sam"],
                   help="in-process segmentation stage when no --mask_dir "
                        "(default: 'sam' when --sam_checkpoint and "
                        "--detector_dir are given, else 'heuristic')")
    p.add_argument("--sam_checkpoint", type=str, default=None,
                   help="segment-anything ViT-H checkpoint for --seg_preset sam")
    p.add_argument("--detector_dir", type=str, default=None,
                   help="detector checkpoint for --seg_preset sam: an HF OWL-ViT dir, or a "
                        "GroundingDINO .pth or HF dir with vocab.txt beside it")
    p.add_argument("--box_threshold", type=float, default=0.20,
                   help="detector score threshold")
    p.add_argument("--detector", type=str, default="auto",
                   choices=["auto", "owlvit", "dino"],
                   help="box-detector backend for the sam preset: OWL-ViT (owlvit), "
                        "GroundingDINO Swin-B (dino), or sniff the checkpoint (auto: a "
                        "single file or a grounding config.json is GroundingDINO)")
    p.add_argument("--profile", type=str, default=None,
                   help="directory for a torch.profiler Chrome trace (trace.json) of the "
                        "sample and the PNG writes, the program's spans (spans.json) and "
                        "phase_timings.json")
    p.add_argument("--num_seeds", type=int, default=1,
                   help="sample this many seeds (seed..seed+n-1) in one batch")
    p.add_argument("--mesh_devices", type=int, default=1,
                   help="shard every forward's batch rows over this many devices")
    p.add_argument("--quant", type=str, default=None, choices=[None, "int8", "int8_conv"],
                   help="run the UNet's transformer matmuls as W8A8 int8 "
                        "(ops/quant.py); int8_conv also quantises the resnet and "
                        "resampler convs. Static activation scales come from "
                        "TWEEDIEMIX_QUANT_SCALES (a JSON table) and "
                        "TWEEDIEMIX_QUANT_STATIC_SCALE; without them the scales "
                        "are dynamic. Checkpoints are unchanged.")
    return p


def _load_tiny_stack(opt, device):
    """Seeded random tiny models (torch's default initialisation on the CPU
    after ``torch.manual_seed(0)``, then moved to ``device``) and hash
    tokenizers. Returns (UNet config, base UNet tensors under their
    checkpoint names, VAE, text encoder, tokenizer 1, tokenizer 2)."""
    import dataclasses

    import torch

    from tweediemix_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel, DualTextEncoder
    from tweediemix_tpu_torch.models.convert import checkpoint_state_dict
    from tweediemix_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
    from tweediemix_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from tweediemix_tpu_torch.utils.tokenizer import HashTokenizer

    torch.manual_seed(0)
    c1 = CLIPTextConfig.tiny()
    c2 = CLIPTextConfig.tiny(projection_dim=32)
    text = DualTextEncoder(CLIPTextModel(c1, device="cpu").to(device),
                           CLIPTextModel(c2, device="cpu").to(device))
    ucfg = UNetConfig.micro(cross_attention_dim=c1.hidden_size + c2.hidden_size,
                            pooled_projection_dim=32, quant=opt.quant)
    base = checkpoint_state_dict(
        UNet2DConditionModel(dataclasses.replace(ucfg, quant=None), device="cpu"))
    vae = AutoencoderKL(VAEConfig.tiny(), device="cpu").to(device)
    return ucfg, base, vae, text, HashTokenizer(1000), HashTokenizer(1000)


def _load_model_dir(opt, device):
    """SDXL from a local diffusers-layout directory: the UNet config (bf16)
    and its ``unet/`` tensors (read when the pipeline builds the UNet with
    its concept slots), the fp32 VAE and both bf16 text towers on
    ``device``, and both tokenizers."""
    import torch

    from tweediemix_tpu_torch.models.clip import CLIPTextConfig, DualTextEncoder
    from tweediemix_tpu_torch.models.convert import (
        CheckpointDir,
        load_clip_text_model,
        load_vae,
        vae_config_overrides,
    )
    from tweediemix_tpu_torch.models.unet2d import UNetConfig
    from tweediemix_tpu_torch.models.vae import VAEConfig
    from tweediemix_tpu_torch.utils.tokenizer import CLIPBPETokenizer

    d = opt.model_dir
    ucfg = UNetConfig.sdxl(dtype=torch.bfloat16, quant=opt.quant)
    base = CheckpointDir(os.path.join(d, "unet"))
    # a checkpoint's scaling_factor / latents_mean / latents_std set the decode
    vcfg = VAEConfig.sdxl(**vae_config_overrides(os.path.join(d, "vae")))
    vae = load_vae(os.path.join(d, "vae"), vcfg, device)
    text = DualTextEncoder(
        load_clip_text_model(os.path.join(d, "text_encoder"),
                             CLIPTextConfig.sdxl_text_encoder(dtype=torch.bfloat16), device),
        load_clip_text_model(os.path.join(d, "text_encoder_2"),
                             CLIPTextConfig.sdxl_text_encoder_2(dtype=torch.bfloat16), device),
    )
    tok1 = CLIPBPETokenizer.from_dir(os.path.join(d, "tokenizer"))
    tok2 = CLIPBPETokenizer.from_dir(os.path.join(d, "tokenizer_2"))
    return ucfg, base, vae, text, tok1, tok2


def load_fg_masks_from_dir(mask_dir, seg_concepts, h, w):
    """One mask per ``+``-separated seg concept → [N-1, h, w] in [0, 1]:
    ``<seg_concept>.png`` through the port's reader, else the JAX CLI's
    ``<seg_concept>.jpg``, which needs PIL. Each is taken to gray and
    resized to (h, w) as the JAX package's loader does it
    (``convert("L").resize((w, h))``: PIL's default bicubic, reproduced
    bit for bit by ``utils/image.py::resize_gray``)."""
    import numpy as np

    from tweediemix_tpu_torch.utils.image import read_image, resize_gray, to_gray

    masks = []
    for name in seg_concepts.split("+"):
        path = os.path.join(mask_dir, name + ".png")
        if not os.path.exists(path):
            path = os.path.join(mask_dir, name + ".jpg")
        if not os.path.exists(path):
            raise FileNotFoundError(f"--mask_dir {mask_dir} holds neither {name}.png nor {name}.jpg")
        gray = resize_gray(to_gray(read_image(path)), h, w)
        masks.append(gray.astype(np.float32) / 255.0)
    return np.stack(masks)


def resolve_segment_fn(opt, device="cuda"):
    """Resolve the seg preset and build the boundary-step segment fn (its
    models on ``device``): real weights supplied → "sam" (as the
    reference); one of --sam_checkpoint / --detector_dir without the other
    and no explicit --seg_preset is an error. Sets ``opt.seg_preset``.
    Returns None when --mask_dir supplies the masks or no seg concepts are
    given."""
    from tweediemix_tpu_torch.segmentation import make_segment_fn

    if opt.seg_preset is None:
        opt.seg_preset = "sam" if (opt.sam_checkpoint and opt.detector_dir) else "heuristic"
        if bool(opt.sam_checkpoint) != bool(opt.detector_dir):
            given, missing = (("--sam_checkpoint", "--detector_dir") if opt.sam_checkpoint
                              else ("--detector_dir", "--sam_checkpoint"))
            raise SystemExit(
                f"{given} was supplied without {missing}: the sam preset needs both. "
                "Pass both, or set --seg_preset heuristic explicitly to run "
                "without model weights."
            )
    if opt.mask_dir is None and opt.seg_concepts:
        return make_segment_fn(
            opt.seg_concepts, opt.output_path, opt.seg_preset,
            sam_checkpoint=opt.sam_checkpoint, detector_dir=opt.detector_dir,
            box_threshold=opt.box_threshold, detector=opt.detector, device=device,
        )
    return None


def build_pipeline(opt, device="cuda", timings=None):
    """Flags → a ready ``TweedieMixPipeline`` on ``device``: checkpoint and
    delta loading, the LoRA ``t_stop`` default (sets ``opt.t_stop``), the
    FusionConfig, the segmentation stage and, under ``--quant``, the static
    activation scales. With a ``timings`` dict it records ``load_s``
    (towers, VAE, tokenizers, deltas and the segmentation models),
    ``seg_load_s`` (the segmentation models alone) and ``build_s`` (the
    UNet with its concept slots, and the token surgery)."""
    import torch

    from tweediemix_tpu_torch.concepts.delta import load_reference_delta
    from tweediemix_tpu_torch.device import resolve_device
    from tweediemix_tpu_torch.fusion.pipeline import TweedieMixPipeline
    from tweediemix_tpu_torch.fusion.sampler import FusionConfig
    from tweediemix_tpu_torch.ops.quant import load_static_scales

    device = resolve_device(device)
    timings = {} if timings is None else timings

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = time.perf_counter()
    n = len(opt.concepts.split("+"))
    if opt.model_preset == "tiny" or opt.model_dir is None:
        stack = _load_tiny_stack(opt, device)
    else:
        stack = _load_model_dir(opt, device)
    ucfg, base_unet, vae, text, tok1, tok2 = stack
    if opt.personal_checkpoint:
        checkpoints = [load_reference_delta(path) for path in opt.personal_checkpoint.split("+")]
    else:
        checkpoints = [{"unet": {}, "modifier_token": {}, "modifier_token_2": {}} for _ in range(n)]
    ts = sync()
    segment_fn = resolve_segment_fn(opt, device)
    t1 = sync()

    if opt.t_stop is None:
        opt.t_stop = 0.9 if opt.mode == "lora" else 1.0
    fcfg = FusionConfig(
        n_timesteps=opt.n_timesteps,
        guidance_scale=opt.guidance_scale,
        t_cond=opt.t_cond,
        t_stop=opt.t_stop if opt.mode == "lora" else 1.0,
        resampling_steps=opt.resampling_steps,
        jumping_steps=opt.jumping_steps,
        height=opt.resolution_h,
        width=opt.resolution_w,
        num_concepts=n,
    )
    pipe = TweedieMixPipeline.from_concept_checkpoints(
        base_unet, checkpoints, opt.modifier_token.split("+"), ucfg, vae, text, tok1, tok2,
        fcfg, mode=opt.mode, segment_fn=segment_fn, device=device,
    )
    if opt.quant:
        load_static_scales(pipe.unet, os.environ.get("TWEEDIEMIX_QUANT_SCALES") or None,
                           default_amax=float(os.environ.get("TWEEDIEMIX_QUANT_STATIC_SCALE", "0")))
    timings.update(load_s=t1 - t0, seg_load_s=t1 - ts, build_s=sync() - t1)
    return pipe


def main(argv=None, device="cuda") -> int:
    import contextlib

    import torch

    from tweediemix_tpu_torch.device import resolve_device
    from tweediemix_tpu_torch.fusion.pipeline import save_image, stack_text_embeds
    from tweediemix_tpu_torch.utils.compile_cache import enable_compile_cache
    from tweediemix_tpu_torch.utils.profiling import spans, trace

    opt = build_parser().parse_args(argv)
    device = resolve_device(device)  # before anything is written
    if opt.mesh_devices < 1:
        raise ValueError(f"--mesh_devices must be at least 1, got {opt.mesh_devices}")
    enable_compile_cache()
    for name in ("device", "seg_gpu"):
        if getattr(opt, name) is not None:
            print(f"warning: --{name} is accepted for reference-script compatibility "
                  "but has no effect (the port runs on one card; segmentation runs "
                  "in-process)", file=sys.stderr)
    out_all = opt.output_path_all or opt.output_path
    os.makedirs(opt.output_path, exist_ok=True)
    os.makedirs(out_all, exist_ok=True)
    if opt.profile:
        os.makedirs(opt.profile, exist_ok=True)

    timings = {}
    pipe = build_pipeline(opt, device, timings)

    def sync():
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)
        return time.perf_counter()

    t0 = time.perf_counter()
    # multi-prompt seed batching: "||" separates per-seed prompt sets in
    # --prompt / --prompt_orig (as many as --num_seeds)
    if "||" in opt.prompt:
        prompts = opt.prompt.split("||")
        origs = opt.prompt_orig.split("||")
        if len(prompts) != opt.num_seeds or len(origs) != opt.num_seeds:
            raise ValueError(
                f"--prompt has {len(prompts)} '||'-separated sets and "
                f"--prompt_orig {len(origs)}; both must equal --num_seeds ({opt.num_seeds})"
            )
        embeds = stack_text_embeds([
            pipe.prepare_text_embeds(p.strip(), o.strip(), opt.concepts, opt.modifier_token,
                                     negative_prompt=opt.negative_prompt)
            for p, o in zip(prompts, origs)
        ])
    else:
        embeds = pipe.prepare_text_embeds(opt.prompt, opt.prompt_orig, opt.concepts,
                                          opt.modifier_token, negative_prompt=opt.negative_prompt)
    t1 = sync()
    fg_masks = None
    if opt.mask_dir is not None:
        fg_masks = load_fg_masks_from_dir(opt.mask_dir, opt.seg_concepts,
                                          opt.resolution_h, opt.resolution_w)
    t_masks = time.perf_counter()
    with trace(opt.profile) if opt.profile else contextlib.nullcontext():
        profiler_start_s = time.perf_counter() - t_masks  # not the sample's
        imgs = pipe.sample(embeds, seed=opt.seed, fg_masks=fg_masks, num_seeds=opt.num_seeds,
                           mesh_devices=opt.mesh_devices)
        t2 = sync()
        orig_names = [o.strip() for o in opt.prompt_orig.split("||")]
        for i in range(imgs.shape[0]):
            name = orig_names[i] if len(orig_names) > 1 else orig_names[0]
            path = os.path.join(out_all, f"{name}_{opt.seed + i}.png")
            save_image(imgs[i : i + 1], path)
            print(f"saved {path}")
    if opt.profile:
        request = next(s for s in spans() if s["name"] == "request")
        with open(os.path.join(opt.profile, "phase_timings.json"), "w") as f:
            json.dump({f"sample_{opt.num_seeds}_seeds":
                       (request["end_ns"] - request["start_ns"]) * 1e-9}, f, indent=2)
    timings.update(encode_s=t1 - t0, sample_s=t2 - t1 - profiler_start_s, phases=pipe.phase_seconds)
    seg = pipe.sampler.segment_fn
    if fg_masks is None and hasattr(seg, "no_detections"):
        timings["segment_s"] = seg.seconds
        print("segmentation: " + json.dumps(dict(
            top_scores=seg.top_scores, no_detections=seg.no_detections, mask_areas=seg.areas)))
    print("timings: " + json.dumps(timings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
