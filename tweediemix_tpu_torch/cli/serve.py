"""Warm-pipeline serving CLI: load once, sample per request (counterpart of
``tweediemix_tpu/cli/serve.py``, with the same protocol and flags).

The one-shot fusion CLI pays the checkpoint load and the pipeline build for
every image. Here the pipeline is built once, through the fusion CLI's own
``build_pipeline``, and every request samples from it.

Protocol: JSON Lines on stdin → JSON Lines on stdout. Each request:

    {"prompt": "a cat+a dog+bg", "prompt_orig": "a cat and a dog",
     "seed": 3821, "num_seeds": 4, "output_path": "./out",
     "negative_prompt": "...", "id": "req-1"}

``prompt`` may use the ``||`` multi-prompt contract (per-seed prompt sets).
Model geometry (concepts, checkpoints, resolution, steps) is fixed at
startup by the flags of ``cli/fusion_sampling``; a request that omits a
field takes the startup flag's value. Response per line:

    {"id": "req-1", "status": "ok", "files": ["./out/....png"],
     "latency_s": 14.2, "warm": true}

``latency_s`` ends in a CUDA synchronise. ``warm`` is true once the
request's geometry (``num_seeds``, masks given or segmented) has been
served before: its cuBLAS heuristics and allocator growth are paid. A
request that fails answers with an error line and the server keeps
serving. An empty line or EOF shuts the server down. The load and build
seconds go to stderr as ``timings: {...}``.

    python -m tweediemix_tpu_torch.cli.serve --model_dir SDXL_DIR \\
        --personal_checkpoint a.bin+b.bin+c.bin --concepts cat+dog+mountain \\
        --modifier_token "<cat1>+<dog1>+<mountain1>" --seg_concepts "a cat+a dog" < requests.jsonl

It runs on the card; ``main(argv, stdin, stdout, device="cpu")`` runs the
plain versions on the CPU. ``--mesh_devices n`` shards every request's UNet
forwards over n devices, as in the one-shot CLI.
"""

from __future__ import annotations

import json
import os
import sys
import time


def build_parser():
    from tweediemix_tpu_torch.cli.fusion_sampling import build_parser as base_parser

    p = base_parser()
    p.description = __doc__
    return p


def make_pipeline(opt, device="cuda", timings=None):
    """The one-shot CLI's own build_pipeline (so a flag or
    default added there cannot drift from the server)."""
    from tweediemix_tpu_torch.cli.fusion_sampling import build_pipeline

    return build_pipeline(opt, device, timings)


def handle_request(pipe, opt, req: dict, served: set) -> dict:
    import torch

    from tweediemix_tpu_torch.fusion.pipeline import save_image, stack_text_embeds

    prompt = req.get("prompt", opt.prompt)
    prompt_orig = req.get("prompt_orig", opt.prompt_orig)
    negative = req.get("negative_prompt", opt.negative_prompt)
    seed = int(req.get("seed", opt.seed))
    num_seeds = int(req.get("num_seeds", opt.num_seeds))
    out_dir = req.get("output_path", opt.output_path)
    os.makedirs(out_dir, exist_ok=True)

    if "||" in prompt:
        prompts = [p.strip() for p in prompt.split("||")]
        origs = [o.strip() for o in prompt_orig.split("||")]
        if len(prompts) != num_seeds or len(origs) != num_seeds:
            raise ValueError(
                f"'||' prompt sets ({len(prompts)}) must equal num_seeds ({num_seeds})")
        embeds = stack_text_embeds([
            pipe.prepare_text_embeds(p, o, opt.concepts, opt.modifier_token,
                                     negative_prompt=negative)
            for p, o in zip(prompts, origs)
        ])
        origs_per_seed = origs
    else:
        embeds = pipe.prepare_text_embeds(
            prompt, prompt_orig, opt.concepts, opt.modifier_token, negative_prompt=negative)
        origs_per_seed = [prompt_orig] * num_seeds

    fg_masks = None
    if opt.mask_dir is not None:
        from tweediemix_tpu_torch.cli.fusion_sampling import load_fg_masks_from_dir

        fg_masks = load_fg_masks_from_dir(
            opt.mask_dir, opt.seg_concepts, opt.resolution_h, opt.resolution_w)

    # "warm" = this geometry has been served before in this process: the
    # batch rows (num_seeds) and precomputed-vs-segmented masks each change
    # the shapes every kernel and cuBLAS call sees
    geometry = (num_seeds, fg_masks is None)
    warm = geometry in served

    t0 = time.perf_counter()
    imgs = pipe.sample(embeds, seed=seed, fg_masks=fg_masks, num_seeds=num_seeds,
                       mesh_devices=opt.mesh_devices)
    files = []
    for s in range(imgs.shape[0]):
        stem = origs_per_seed[s].split("+")[0].strip() or "sample"
        path = os.path.join(out_dir, f"{stem}_{seed + s}.png")
        save_image(imgs[s : s + 1], path)
        files.append(path)
    device = getattr(pipe, "device", None)
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    served.add(geometry)
    return {
        "status": "ok", "files": files,
        "latency_s": round(time.perf_counter() - t0, 3), "warm": warm,
    }


def main(argv=None, stdin=None, stdout=None, device="cuda") -> int:
    from tweediemix_tpu_torch.device import resolve_device
    from tweediemix_tpu_torch.utils.compile_cache import enable_compile_cache

    opt = build_parser().parse_args(argv)
    device = resolve_device(device)  # before anything is built
    if opt.mesh_devices < 1:
        raise ValueError(f"--mesh_devices must be at least 1, got {opt.mesh_devices}")
    enable_compile_cache()
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout

    timings = {}
    pipe = make_pipeline(opt, device, timings)
    print(f"timings: {json.dumps(timings)}", file=sys.stderr)
    print("pipeline ready; reading JSONL requests from stdin", file=sys.stderr)

    served = set()  # geometries already served
    for line in stdin:
        line = line.strip()
        if not line:
            break
        req = None
        try:
            req = json.loads(line)
            resp = handle_request(pipe, opt, req, served)
        except Exception as e:  # report, keep serving
            resp = {"status": "error", "error": f"{type(e).__name__}: {e}"}
        if isinstance(req, dict) and "id" in req:
            resp["id"] = req["id"]
        stdout.write(json.dumps(resp) + "\n")
        stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
