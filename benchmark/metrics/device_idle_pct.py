"""The device's idle share over the traced slice: 1 - (union of kernel
intervals) / (the slice's host span), in percent."""


def read(ctx):
    sl = ctx.get("slice") or {}
    if not sl.get("window_s") or not sl.get("busy_s"):
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
