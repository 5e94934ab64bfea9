"""Seconds of the fp32 decode per image (``decode_final``), the mean of the
window's requests: the pipeline's own ``phase_seconds["decode"]``, host
clock with a CUDA synchronise at its end."""


def read(ctx):
    res = ctx["results"]
    return sum(r["phases"]["decode"] for r in res) / len(res)
