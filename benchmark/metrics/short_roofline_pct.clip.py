"""The frame-axis short-attention kernel's share of its bytes roofline in
the traced slice (``rooflines.short_bound_s`` over the slice's 34 launches
per call)."""

from benchmark.rooflines import bound_s, short_bound_s


def read(ctx):
    sl = ctx.get("slice") or {}
    t = (sl.get("by_class") or {}).get("short_attention")
    if not t or not sl.get("short_shapes"):
        return None
    return 100.0 * bound_s(sl["short_shapes"], short_bound_s) / t
