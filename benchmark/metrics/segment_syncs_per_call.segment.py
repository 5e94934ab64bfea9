"""Synchronising CUDA operations per ``segment_fn`` call in the
segmentation-only cell, counted as ``segment_syncs_per_call.langsam``
counts them: the first-pass ``langsam`` spans' ``syncs`` over their count."""

from benchmark.harness import read_metric


def read(ctx):
    return read_metric("segment_syncs_per_call.langsam", ctx)
