"""Standalone text-guided mask extraction CLI (counterpart of
``tweediemix_tpu/cli/segment.py``, with the same flags).

    python -m tweediemix_tpu_torch.cli.segment --input_path image.png \\
        --text_condition "a cat+a dog" --output_path masks/ \\
        --seg_preset sam --sam_checkpoint sam_vit_h.pth --detector_dir owlvit-base-patch32/

``--detector_dir groundingdino_swinb_cogcoor.pth`` (``vocab.txt`` beside
it) takes the reference's GroundingDINO detector instead (``--detector
auto`` finds it; ``--detector dino`` asks for it).

For each ``+``-separated concept: predict its mask, expand it to its
bounding rectangle, black it out before the next concept, resolve the
pairwise overlap, and write ``<concept>.png`` (8-bit gray, 0 or 255) into
``--output_path``. The JAX package writes ``<concept>.jpg`` through PIL;
the port writes PNG with its own writer, so the CLI runs where PIL is not
installed, and the fusion CLI's ``--mask_dir`` reads either. The input is a
PNG, or any image PIL reads where it is installed.

It runs on the card; ``main(argv, device="cpu")`` runs on the CPU. SAM and
the detector run in fp32 with TF32 off (``LangSAM`` sets it).
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_path", type=str, required=True)
    p.add_argument("--text_condition", type=str, required=True, help="'+'-separated concepts")
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--seg_preset", type=str, default="sam-random",
                   choices=["heuristic", "sam-random", "sam"])
    p.add_argument("--sam_checkpoint", type=str, default=None,
                   help="segment-anything ViT-H checkpoint for --seg_preset sam")
    p.add_argument("--detector_dir", type=str, default=None,
                   help="detector checkpoint for --seg_preset sam: an HF OWL-ViT detection "
                        "dir, or a GroundingDINO .pth or HF dir with vocab.txt beside it")
    p.add_argument("--box_threshold", type=float, default=0.20)
    p.add_argument("--detector", type=str, default="auto",
                   choices=["auto", "owlvit", "dino"],
                   help="box-detector backend for --seg_preset sam: OWL-ViT (owlvit), "
                        "GroundingDINO Swin-B (dino), or sniff the checkpoint (auto: a "
                        "single file or a grounding config.json is GroundingDINO)")
    return p


def main(argv=None, device="cuda") -> int:
    import numpy as np
    import torch

    from tweediemix_tpu_torch.device import resolve_device
    from tweediemix_tpu_torch.segmentation import make_segment_fn
    from tweediemix_tpu_torch.utils.image import read_image, write_png

    opt = build_parser().parse_args(argv)
    device = resolve_device(device)  # before anything is written
    os.makedirs(opt.output_path, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    pixels = read_image(opt.input_path)
    image = torch.from_numpy(pixels.astype(np.float32) / 255.0).to(device)
    seg = make_segment_fn(opt.text_condition, opt.output_path, opt.seg_preset,
                          sam_checkpoint=opt.sam_checkpoint, detector_dir=opt.detector_dir,
                          box_threshold=opt.box_threshold, detector=opt.detector, device=device)
    with torch.inference_mode():
        masks = seg(image[None]) if opt.seg_preset == "heuristic" else seg(image)

    for name, m in zip(opt.text_condition.split("+"), masks):
        path = os.path.join(opt.output_path, f"{name}.png")
        write_png(path, (m.float().cpu().numpy() * 255.0).astype(np.uint8))
        print(f"saved {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
