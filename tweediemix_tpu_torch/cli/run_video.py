"""Image-to-video CLI (counterpart of ``tweediemix_tpu/cli/run_video.py``,
with the same flags and defaults).

    python -m tweediemix_tpu_torch.cli.run_video --model_dir I2VGEN_XL_DIR \\
        --image fused.png --prompt "a cat and a dog running" --output clip.gif

Takes a picture (e.g. the fusion CLI's PNG) as the first frame, runs the
I2VGen-XL pipeline with first-frame feature injection and writes a GIF.
Defaults: 50 steps, 512², 16 frames, fps 8, guidance 9, injection_timestep
0.02, interp_ratio 0.7. Weights come from ``--model_dir`` (a local
``ali-vilab/i2vgen-xl`` directory in the diffusers layout: ``unet/``,
``vae/``, ``text_encoder/``, ``image_encoder/``, ``tokenizer/``) or
``--model_preset tiny`` (seeded random small models for smoke runs).
``--quant`` runs the video UNet's transformer matmuls (and with
``int8_conv`` its resnet and resampler convs) as W8A8; static activation
scales come from ``TWEEDIEMIX_QUANT_SCALES``/``TWEEDIEMIX_QUANT_STATIC_SCALE``
as in the fusion CLI, else they are dynamic per row.

The picture is read as RGB (PNG by the port's own reader; other formats
where PIL imports) and resized to (width, height) as PIL's default resize
does, bit for bit (``utils/image.py::resize_rgb``); the CLIP input is that
picture resized to the vision tower's size with an antialiased bilinear, as
``jax.image.resize`` does. The GIF is written by the port's own writer.

It runs on the card; ``main(argv, device="cpu")`` runs the plain versions
on the CPU. ``--mesh_devices n`` shards the ``--num_seeds`` clips over n
devices (``cuda:0`` .. ``cuda:n-1``, or the CPU n times), each running the
whole loop for its clips; the clips must divide over them.
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
    p.add_argument("--image", type=str, required=True, help="conditioning image (first frame)")
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--negative_prompt", type=str,
                   default="Distorted, discontinuous, Ugly, blurry, low resolution, motionless, "
                           "static, disfigured, disconnected limbs, Ugly faces, incomplete arms")
    p.add_argument("--output", type=str, default="./video.gif")
    p.add_argument("--seed", type=int, default=8888)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--n_timesteps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=9.0)
    p.add_argument("--injection_timestep", type=float, default=0.02)
    p.add_argument("--interp_ratio", type=float, default=0.7)
    p.add_argument("--decode_chunk_size", type=int, default=1,
                   help="frames decoded per VAE call (larger values trade decode "
                        "memory for fewer, larger convolutions)")
    p.add_argument("--model_dir", type=str, default=None,
                   help="local I2VGen-XL checkpoint dir (diffusers layout)")
    p.add_argument("--model_preset", type=str, default=None, choices=[None, "tiny"],
                   help="seeded random small models for smoke runs (no weights needed)")
    p.add_argument("--num_seeds", type=int, default=1,
                   help="clips sampled in one batch from the same conditioning image "
                        "(clip b from its own generators). Writes <output>_b.gif per "
                        "extra clip.")
    p.add_argument("--mesh_devices", type=int, default=1,
                   help="shard the clip rows over this many devices (--num_seeds must "
                        "divide over them)")
    p.add_argument("--quant", type=str, default=None, choices=[None, "int8", "int8_conv"],
                   help="run the video UNet's transformer matmuls (spatial and "
                        "temporal) as W8A8 int8 (ops/quant.py); int8_conv also "
                        "quantises the resnet and resampler convs. Checkpoints are "
                        "unchanged.")
    return p


def _load_tiny(opt, device):
    """Seeded random tiny models (torch's default initialisation on the CPU
    after ``torch.manual_seed(0)``, then moved to ``device``) and a hash
    tokenizer: (text tower, vision tower, UNet3D, VAE, tokenizer)."""
    import torch

    from tweediemix_tpu_torch.models.clip import (
        CLIPTextConfig,
        CLIPTextModel,
        CLIPVisionConfig,
        CLIPVisionModel,
    )
    from tweediemix_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from tweediemix_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from tweediemix_tpu_torch.utils.tokenizer import HashTokenizer

    torch.manual_seed(0)
    tcfg = CLIPTextConfig.tiny()
    text = CLIPTextModel(tcfg, device="cpu")
    vision = CLIPVisionModel(CLIPVisionConfig.tiny(projection_dim=tcfg.hidden_size), device="cpu")
    unet = UNet3DConditionModel(UNet3DConfig.tiny(cross_attention_dim=tcfg.hidden_size,
                                                  quant=opt.quant), device="cpu")
    vae = AutoencoderKL(VAEConfig.tiny(), device="cpu")
    models = tuple(m.to(device).eval() for m in (text, vision, unet, vae))
    return (*models, HashTokenizer(tcfg.vocab_size))


def _load_model_dir(opt, device):
    """I2VGen-XL from a local diffusers-layout directory: the bf16 UNet3D
    (int8 at the quantised sites under ``--quant``), the fp32 VAE, the bf16
    OpenCLIP-H text and image towers, and the tokenizer."""
    import torch

    from tweediemix_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
    from tweediemix_tpu_torch.models.convert import (
        load_clip_text_model,
        load_clip_vision_model,
        load_unet3d,
        load_vae,
        vae_config_overrides,
    )
    from tweediemix_tpu_torch.models.unet3d import UNet3DConfig
    from tweediemix_tpu_torch.models.vae import VAEConfig
    from tweediemix_tpu_torch.utils.tokenizer import CLIPBPETokenizer

    d = opt.model_dir
    unet = load_unet3d(os.path.join(d, "unet"),
                       UNet3DConfig.i2vgen(dtype=torch.bfloat16, quant=opt.quant), device)
    vae_dir = os.path.join(d, "vae")
    vae = load_vae(vae_dir, VAEConfig(**{"scaling_factor": 0.18215, **vae_config_overrides(vae_dir)}),
                   device)
    text = load_clip_text_model(os.path.join(d, "text_encoder"),
                                CLIPTextConfig.i2vgen_text_encoder(dtype=torch.bfloat16), device)
    vision = load_clip_vision_model(os.path.join(d, "image_encoder"),
                                    CLIPVisionConfig.vit_h(dtype=torch.bfloat16), device)
    tok = CLIPBPETokenizer.from_dir(os.path.join(d, "tokenizer"))
    return text, vision, unet, vae, tok


def encode_prompts(text, tokenizer, prompts):
    """The I2VGen-XL prompt embedding: ``final_layer_norm`` of the
    penultimate layer's hidden states (the pipeline's default
    ``clip_skip``), for the prompt and the negative prompt alike:
    [len(prompts), 77, D]."""
    import torch

    ids = torch.tensor(tokenizer(prompts), dtype=torch.long, device=next(text.parameters()).device)
    with torch.inference_mode():
        return text(ids)[3]


def read_conditioning_image(path: str, height: int, width: int):
    """The picture as RGB, resized to (width, height) with PIL's default
    resize, as [1, H, W, 3] float32 in [0, 1]."""
    import torch

    from tweediemix_tpu_torch.utils.image import read_image, resize_rgb

    pixels = resize_rgb(read_image(path), height, width)
    return torch.from_numpy(pixels.astype("float32") / 255.0)[None]


def encode_image(vision, img01):
    """The CLIP image embedding [B, 1, D] of [B, H, W, 3] pixels in [0, 1]:
    resized to the tower's input size with ``jax.image.resize``'s
    antialiased bilinear and normalised with the CLIP statistics."""
    import torch

    from tweediemix_tpu_torch.models.clip import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
    from tweediemix_tpu_torch.segmentation.lang_sam import resize_bilinear

    size = vision.config.image_size
    dev = next(vision.parameters()).device
    x = resize_bilinear(img01.to(dev).permute(0, 3, 1, 2), size, size).permute(0, 2, 3, 1)
    x = (x - torch.tensor(CLIP_IMAGE_MEAN, device=dev)) / torch.tensor(CLIP_IMAGE_STD, device=dev)
    with torch.inference_mode():
        return vision(x)[:, None, :]


def main(argv=None, device="cuda") -> int:
    import torch

    from tweediemix_tpu_torch.device import resolve_device
    from tweediemix_tpu_torch.ops.quant import load_static_scales
    from tweediemix_tpu_torch.utils.compile_cache import enable_compile_cache
    from tweediemix_tpu_torch.video.pipeline import I2VPipeline, VideoConfig, export_gif

    opt = build_parser().parse_args(argv)
    device = resolve_device(device)  # before anything is read or written
    enable_compile_cache()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = time.perf_counter()
    if opt.model_preset == "tiny" or opt.model_dir is None:
        text, vision, unet, vae, tok = _load_tiny(opt, device)
    else:
        text, vision, unet, vae, tok = _load_model_dir(opt, device)
    t1 = sync()
    latent_factor = 2 ** (len(vae.config.block_out_channels) - 1)
    vcfg = VideoConfig(
        n_timesteps=opt.n_timesteps, guidance_scale=opt.guidance_scale,
        num_frames=opt.num_frames, height=opt.height, width=opt.width, fps=opt.fps,
        injection_timestep=opt.injection_timestep, interp_ratio=opt.interp_ratio,
        latent_factor=latent_factor, decode_chunk_size=opt.decode_chunk_size,
    )
    pipe = I2VPipeline(vcfg, unet, vae, device=device)
    if opt.quant:
        load_static_scales(pipe.unet, os.environ.get("TWEEDIEMIX_QUANT_SCALES") or None,
                           default_amax=float(os.environ.get("TWEEDIEMIX_QUANT_STATIC_SCALE", "0")))
    t2 = sync()

    ctx = encode_prompts(text, tok, [opt.prompt, opt.negative_prompt])
    img01 = read_conditioning_image(opt.image, opt.height, opt.width)
    img_emb = encode_image(vision, img01)
    image = (img01 * 2.0 - 1.0).repeat(opt.num_seeds, 1, 1, 1)
    t3 = sync()

    video = pipe.generate(ctx[:1], ctx[1:], image, img_emb, seed=opt.seed,
                          mesh_devices=opt.mesh_devices)
    t4 = sync()
    os.makedirs(os.path.dirname(os.path.abspath(opt.output)), exist_ok=True)
    clips = video[None] if opt.num_seeds == 1 else video
    stem, ext = os.path.splitext(opt.output)
    for b, clip in enumerate(clips):
        path = opt.output if b == 0 else f"{stem}_{b}{ext}"
        export_gif(clip, path, fps=opt.fps)
        print(f"saved {path} ({clip.shape[0]} frames)")
    timings = dict(load_s=t1 - t0, build_s=t2 - t1, encode_s=t3 - t2, generate_s=t4 - t3,
                   write_s=time.perf_counter() - t4, phases=pipe.phase_seconds)
    print("timings: " + json.dumps(timings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
