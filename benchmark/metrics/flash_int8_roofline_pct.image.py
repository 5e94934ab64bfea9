"""The int8 attention core's share of its roofline in the traced slice: the
bound (``rooflines.flash_int8_bound_s``) and the device time both cover the
int8 kernel with its two quantise passes (``absmax_kernel``,
``quantize_kernel``), so a later fusion of the passes reads the same work."""

from benchmark.rooflines import bound_s, flash_int8_bound_s


def read(ctx):
    sl = ctx.get("slice") or {}
    t = (sl.get("by_class") or {}).get("flash_attention_int8")
    if not t or not sl.get("flash_shapes"):
        return None
    return 100.0 * bound_s(sl["flash_shapes"], flash_int8_bound_s) / t
