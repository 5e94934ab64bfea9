"""The whole request's share of the H100's peak: the least time its model
work needs (``rooflines.least_seconds`` of the work the plain reference
counts on ``meta``: UNet products at the bf16 peak, or the int8 peak at the
W8A8 sites and in the int8 core, the decode at the fp32 peak), over the
window's seconds per request: per image, or per clip (whose first
frame's encode counts with the decode)."""

from benchmark.rooflines import least_seconds


def read(ctx):
    wl = ctx["workload"]
    least = least_seconds(ctx["system"].work(), unet_int8=bool(wl.get("quant")))
    return 100.0 * least / (ctx["window_s"] / ctx["requests"])
