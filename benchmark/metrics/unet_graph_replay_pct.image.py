"""The share, in %, of the traced slice's first-pass ``unet`` spans that
replayed a CUDA graph (``graph`` attribute ``"replay"``,
``models/unet_graph.py``). A program whose spans carry no such attribute
reads 0."""

from benchmark.program_spans import first_pass


def read(ctx):
    unets = [s for s in first_pass(ctx) or [] if s["name"] == "unet"]
    if not unets:
        return None
    return 100.0 * sum(s["attrs"].get("graph") == "replay" for s in unets) / len(unets)
