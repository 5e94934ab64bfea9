"""Synchronising CUDA operations per ``segment_fn`` call: the ``syncs`` of
the traced slice's first-pass ``langsam`` spans (the program's outermost
span of the call, children included), summed, over their count. The
slice is profiled twice (``harness.trace_slice``), so the tracer holds
two passes of its ``segment_calls`` calls; nothing is read otherwise, or
where the program keeps no such span."""


def read(ctx):
    calls = (ctx.get("slice") or {}).get("segment_calls")
    try:
        from tweediemix_tpu_torch.utils import profiling
    except ImportError:
        return None
    read_spans = getattr(profiling, "spans", None)
    if not calls or read_spans is None:
        return None
    spans = [s for s in read_spans() if s["name"] == "langsam"]
    if len(spans) != 2 * calls:
        return None
    first = spans[:calls]  # spans are kept in the order they opened
    return sum(s["syncs"] for s in first) / calls
