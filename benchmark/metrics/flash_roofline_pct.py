"""The bf16 flash kernel's share of its roofline in the traced slice: the
sum of each launch's bound (``rooflines.flash_bound_s`` over the slice's
shape mix from the configuration's site arithmetic) over the device time of
the kernel's launches."""

from benchmark.rooflines import bound_s, flash_bound_s


def read(ctx):
    sl = ctx.get("slice") or {}
    t = (sl.get("by_class") or {}).get("flash_attention")
    if not t or not sl.get("flash_shapes"):
        return None
    return 100.0 * bound_s(sl["flash_shapes"], flash_bound_s) / t
