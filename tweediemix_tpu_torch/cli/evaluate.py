"""Evaluation CLI: CLIP-T / CLIP-I scores over generated samples
(counterpart of ``tweediemix_tpu/cli/evaluate.py``, with the same flags).

    python -m tweediemix_tpu_torch.cli.evaluate \\
        --images ./outputs/catdog \\
        --prompt "photo of a cat and a dog running, mountain background" \\
        --modifier_token "<new1>+<new2>" \\
        --concept_images ./data/cat+./data/dog \\
        --clip_dir /path/to/clip-vit-large-patch14

Prints one JSON line: ``{"num_images": N, "clip_t": ..., "clip_i":
{"concept_0": ...}}``. ``--concept_images`` is optional (CLIP-T only);
``--model_preset tiny`` runs random towers for smoke runs. ``--prompt`` may
be one prompt for all images or ``||``-separated per-image prompts (the
sampler's multi-prompt contract). Images are PNGs (any format PIL reads
where it is installed).

It runs on the card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--images", type=str, required=True,
                   help="directory or glob of generated images")
    p.add_argument("--prompt", type=str, required=True,
                   help="eval prompt; '||'-separated for per-image prompts")
    p.add_argument("--modifier_token", type=str, default="",
                   help="'+'-separated learned tokens to strip from the "
                        "prompt before text encoding")
    p.add_argument("--concept_images", type=str, default=None,
                   help="'+'-separated per-concept instance-image dirs (enables CLIP-I)")
    p.add_argument("--concepts", type=str, default=None,
                   help="'+'-separated concept names labeling the CLIP-I "
                        "entries (defaults to concept_<i>)")
    p.add_argument("--clip_dir", type=str, default=None,
                   help="HF CLIPModel checkpoint dir (both towers + tokenizer files)")
    p.add_argument("--model_preset", type=str, default=None, choices=[None, "tiny"],
                   help="'tiny' = random towers (smoke only)")
    p.add_argument("--output", type=str, default=None,
                   help="also write the JSON result to this path")
    return p


def scores(scorer, images, prompts, modifiers, concept_dirs, names) -> dict:
    """The unrounded result: num_images, clip_t and, per concept directory,
    clip_i."""
    from tweediemix_tpu_torch.evaluation import load_images

    result = {"num_images": len(images), "clip_t": scorer.clip_t(images, prompts, modifiers)}
    if concept_dirs:
        result["clip_i"] = {name: scorer.clip_i(images, load_images(d))
                            for name, d in zip(names, concept_dirs)}
    return result


def main(argv=None, device="cuda") -> int:
    from tweediemix_tpu_torch.device import resolve_device
    from tweediemix_tpu_torch.evaluation import CLIPScorer, load_images
    from tweediemix_tpu_torch.utils.compile_cache import enable_compile_cache

    opt = build_parser().parse_args(argv)
    device = resolve_device(device)
    enable_compile_cache()
    if opt.clip_dir is not None:
        scorer = CLIPScorer.from_pretrained(opt.clip_dir, device=device)
    elif opt.model_preset == "tiny":
        scorer = CLIPScorer.tiny(device=device)
    else:
        raise SystemExit("supply --clip_dir (real CLIP weights) or --model_preset tiny")

    images = load_images(opt.images)
    prompts = [p.strip() for p in opt.prompt.split("||")]
    modifiers = [t for t in opt.modifier_token.split("+") if t]
    dirs, names = [], []
    if opt.concept_images:
        dirs = opt.concept_images.split("+")
        names = (opt.concepts.split("+") if opt.concepts
                 else [f"concept_{i}" for i in range(len(dirs))])
        if len(names) != len(dirs):
            raise SystemExit(f"--concepts has {len(names)} names for {len(dirs)} dirs")
    result = scores(scorer, images, prompts, modifiers, dirs, names)
    result["clip_t"] = round(result["clip_t"], 4)
    if "clip_i" in result:
        result["clip_i"] = {k: round(v, 4) for k, v in result["clip_i"].items()}
    line = json.dumps(result)
    print(line)
    if opt.output:
        with open(opt.output, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
