"""Synchronising CUDA operations per UNet call: the ``syncs`` of the traced
slice's first-pass sampler steps (``fusion.step`` / ``video.step``: the
call and the update around it), summed, over the number of calls."""

from benchmark.program_spans import first_pass

STEPS = ("fusion.step", "video.step")


def read(ctx):
    spans = first_pass(ctx)
    if not spans:
        return None
    steps = [s for s in spans if s["name"] in STEPS]
    calls = sum(s["name"] == "unet" for s in spans)
    if not steps or not calls:
        return None
    return sum(s["syncs"] for s in steps) / calls
