"""Interactive text-segmentation demo (counterpart of
``tweediemix_tpu/cli/app.py``).

``make_predict_fn`` builds a plain function (image, text, box threshold →
overlay) on the port's ``LangSAM``, headless and testable; ``main`` wraps
it in a gradio UI (SAM preset, box threshold, image, text prompt →
detection overlay) where gradio is installed, and otherwise returns 1
pointing at ``cli/segment.py`` for the headless path.

    python -m tweediemix_tpu_torch.cli.app --preset sam \\
        --sam_checkpoint sam_vit_h.pth --detector_dir owlvit-base-patch32/

It runs on the card; ``make_predict_fn(..., device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def make_predict_fn(preset: str = "sam-random", sam_checkpoint=None, detector_dir=None,
                    device="cuda"):
    """predict(image [H, W, 3] float in [0, 1], text, box_threshold) →
    overlay [H, W, 3] float in [0, 1]: ``draw_image`` of the kept masks and
    boxes of ``LangSAM.predict``. ``predict.lang_sam`` is the model pair:
    ``sam`` loads SAM ViT-H and a detector from the checkpoints (OWL-ViT or
    GroundingDINO, as ``LangSAM.from_pretrained`` finds it), ``sam-random``
    the seeded random tiny models."""
    import torch

    from tweediemix_tpu_torch.device import resolve_device
    from tweediemix_tpu_torch.segmentation.lang_sam import LangSAM
    from tweediemix_tpu_torch.segmentation.viz import draw_image

    device = resolve_device(device)
    if preset == "sam":
        lang_sam = LangSAM.from_pretrained(sam_checkpoint, detector_dir, device=device)
    elif preset == "sam-random":
        lang_sam = LangSAM.random_init(device=device)
    else:
        raise ValueError(f"unknown preset {preset!r}; use 'sam' or 'sam-random'")

    def predict(image: np.ndarray, text_prompt: str, box_threshold: float = 0.3):
        image = np.asarray(image, np.float32)
        masks, boxes, _, valid = lang_sam.predict(torch.from_numpy(image), text_prompt,
                                                  box_threshold=box_threshold)
        keep = valid.cpu().numpy()
        return draw_image(image, masks.float().cpu().numpy()[keep], boxes.cpu().numpy()[keep])

    predict.lang_sam = lang_sam
    return predict


def main(argv=None, device="cuda") -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="sam", choices=["sam", "sam-random"])
    p.add_argument("--sam_checkpoint", type=str, default=None)
    p.add_argument("--detector_dir", type=str, default=None)
    p.add_argument("--port", type=int, default=7860)
    opt = p.parse_args(argv)

    try:
        import gradio as gr
    except ImportError:
        print("gradio is not installed in this environment; use "
              "`python -m tweediemix_tpu_torch.cli.segment` for the headless path",
              file=sys.stderr)
        return 1

    predict = make_predict_fn(opt.preset, opt.sam_checkpoint, opt.detector_dir, device=device)

    def gr_predict(box_threshold, image, text_prompt):
        return predict(np.asarray(image, np.float32) / 255.0, text_prompt, box_threshold)

    demo = gr.Interface(
        fn=gr_predict,
        inputs=[
            gr.Slider(0, 1, value=0.3, label="Box threshold"),
            gr.Image(type="numpy", label="Image"),
            gr.Textbox(lines=1, label="Text Prompt"),
        ],
        outputs=gr.Image(type="numpy", label="Output Image"),
        title="TweedieMix text segmentation",
    )
    demo.launch(server_port=opt.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
