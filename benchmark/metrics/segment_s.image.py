"""Seconds per image of the in-loop segmentation: the mean over the
window's requests of the program's own ``segment_fn.own_seconds`` (on the
card, the device's time from where the stream reached the call, after the
queued preview decode, to its last operation), which the system copies
into each request's phases. Nothing is read where the program does not
keep it."""


def read(ctx):
    res = ctx["results"]
    if not all("segment" in r.get("phases", {}) for r in res):
        return None
    return sum(r["phases"]["segment"] for r in res) / len(res)
