"""The port's own spans of the traced slice's first pass, read from its
tracer in memory (``tweediemix_tpu_torch.utils.profiling``).

The slice runs under ``torch.profiler`` twice (``harness.trace_slice``):
first with the device's activity alone, then with the host's too. The
tracer records while a profiler records, and nothing else in a run
profiles the port, so it holds the slice's two passes and nothing more.
The first pass is the one without the host's profiler cost: its first
``unet_calls`` ``unet`` spans, their descendants and their ancestors.
"""

from __future__ import annotations

from typing import List, Optional


def first_pass(ctx: dict) -> Optional[List[dict]]:
    """The first pass's spans, or None where the program keeps no spans or
    the tracer does not hold exactly two passes of the slice's calls."""
    calls = (ctx.get("slice") or {}).get("unet_calls")
    try:
        from tweediemix_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if not calls or read is None:
        return None
    spans = read()
    unets = [s for s in spans if s["name"] == "unet"]
    if len(unets) != 2 * calls:
        return None
    by_id = {s["id"]: s for s in spans}
    chosen = {s["id"] for s in unets[:calls]}  # spans are kept in the order they opened
    for u in unets[:calls]:
        p = u["parent"]
        while p is not None and p in by_id:
            chosen.add(p)
            p = by_id[p]["parent"]

    def below(s):
        p = s["parent"]
        while p is not None:
            if p in chosen and by_id[p]["name"] == "unet":
                return True
            p = by_id[p]["parent"] if p in by_id else None
        return False

    return [s for s in spans if s["id"] in chosen or below(s)]


def host_seconds(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) * 1e-9
