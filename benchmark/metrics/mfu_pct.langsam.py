"""The whole request's share of the H100's peak in the in-loop
segmentation cell: ``rooflines.least_seconds`` of the work the plain
reference counts on ``meta`` (``System.work``), with the preview decode
(``preview_``) and the segmentation's products (``seg_``: OWL-ViT, SAM's
encoder and decoder, fp32 with TF32 off) counted at the fp32 peak as the
final decode (``vae_``) is; over the window's seconds per request."""

from benchmark.rooflines import least_seconds

FP32_TAGS = ("preview_", "seg_")


def read(ctx):
    work = {("vae_" + tag if tag.startswith(FP32_TAGS) else tag): n
            for tag, n in ctx["system"].work().items()}
    return 100.0 * least_seconds(work, unet_int8=False) / (ctx["window_s"] / ctx["requests"])
