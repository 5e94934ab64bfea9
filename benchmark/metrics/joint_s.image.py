"""Seconds per image of the sampler's prologue (with its resampling) and
joint phases, the calls of 2 rows that the host holds back most: the mean
of the window's requests' ``phase_seconds``."""


def read(ctx):
    res = ctx["results"]
    return sum(r["phases"]["prologue"] + r["phases"]["joint"] for r in res) / len(res)
