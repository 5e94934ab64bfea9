"""The whole request's share of the H100's peak in the segmentation-only
cell: ``rooflines.least_seconds`` of one ``segment_fn`` call's work as the
plain reference counts it on ``meta`` (``System.seg_work``: per phrase
OWL-ViT, SAM's encoder and the mask decoder, fp32 with TF32 off), counted at
the fp32 peak as ``mfu_pct.langsam`` counts it; over the window's seconds
per call."""

from benchmark.rooflines import least_seconds


def read(ctx):
    work = {"vae_" + tag: n for tag, n in ctx["system"].seg_work().items()}
    return 100.0 * least_seconds(work, unet_int8=False) / (ctx["window_s"] / ctx["requests"])
