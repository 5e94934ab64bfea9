"""Tracing and profiling hooks (counterpart of
``tweediemix_tpu/utils/profiling.py``).

* ``trace(dir)``: a ``torch.profiler`` context (CPU activity, and CUDA
  where the card is present) that writes a Chrome trace (``trace.json``,
  viewable in Perfetto or ``chrome://tracing``) into ``dir`` when it
  closes; it yields the profiler;
* ``annotate(name)``: a ``record_function`` range for phase-level markers;
* ``PhaseTimer``: wall-clock phase timing with a JSON-able report, used by
  the fusion CLI under ``--profile``; each phase ends in a CUDA synchronise
  where CUDA is in use, so it times the card's work;
* ``device_breakdown``: device time by kernel class of a finished profile
  (``profiler_kernels``) or of a Chrome trace file
  (``chrome_trace_kernels``), its top kernels and the device's idle share;
* ``graph_ms``, ``flushed_ms``: device ms per call of a function, warm or
  with the L2 flushed, from CUDA graphs timed with CUDA events (the host's
  enqueue rate cannot show); ``host_us_per_call``: the host's µs to
  enqueue one call.

This module imports nothing of the package, so that a script can load it by
its path beside another tree's package (``tools/short_timing.py``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterable, List, Tuple

import torch

TRACE_FILE = "trace.json"


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    to ``log_dir/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    return torch.profiler.record_function(name)


class PhaseTimer:
    def __init__(self):
        self.phases: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        with annotate(name):
            yield
            _sync()
        self.phases.append((name, time.perf_counter() - t0))

    def report(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.phases:
            out[name] = out.get(name, 0.0) + dt
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


# -- device and host time per call -------------------------------------------

FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2


def _replay_ms(graph, reps: int = 5) -> float:
    """Median device ms of one replay of ``graph``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def _capture(body, launches: int):
    """``launches`` calls of ``body`` captured in one CUDA graph (after a
    warm-up call on a side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            body()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def graph_ms(fn, launches: int = 50) -> float:
    """Device ms per call of ``fn``: ``launches`` calls in one CUDA graph,
    the replay timed with CUDA events (median of 5)."""
    fn()
    return _replay_ms(_capture(fn, launches)) / launches


def flushed_ms(fn, launches: int = 20) -> float:
    """Device ms per call of ``fn`` with the L2 cold: a graph of (a read of
    FLUSH_BYTES, ``fn``) ``launches`` times, less a graph of the reads
    alone."""
    buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
    sink = torch.empty((), device="cuda")

    def flush():
        torch.sum(buf, dim=0, out=sink)

    def both():
        flush()
        fn()

    fn()
    t_both = _replay_ms(_capture(both, launches))
    t_flush = _replay_ms(_capture(flush, launches))
    return (t_both - t_flush) / launches


def host_us_per_call(fn, calls: int = 200, repeats: int = 5) -> float:
    """Host microseconds to enqueue one call, timed while the device is kept
    busy (so the launch queue neither drains nor fills); the median of
    ``repeats`` runs of ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        torch.cuda._sleep(500_000_000)  # ~0.3 s of device time
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(runs)[repeats // 2]


# -- device time by kernel class -------------------------------------------------

KERNEL_CLASSES = (  # (class, substrings of the CUDA kernel name), first match wins
    ("short_attention", ("short_attn_kernel",)),
    ("flash_attention_int8", ("flash_int8_wgmma_kernel", "absmax_kernel", "quantize_kernel<")),
    ("flash_attention", ("flash_fwd_kernel",)),
    ("layout", ("nchwToNhwc", "nhwcToNchw")),
    ("convolution", ("fprop", "conv", "dgrad", "winograd")),
    ("gemm_int8", ("s8s8", "i8i8", "imma", "_s8_", "_i8_", "int8")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "Kernel2")),
    ("norm", ("norm", "moments")),  # GroupNorm's statistics: RowwiseMomentsCUDAKernel
    ("softmax", ("softmax",)),
    ("elementwise/copy", ("elementwise", "vectorized", "copy", "cat", "fill", "reduce", "index")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k.lower() in low for k in keys):
            return cls
    return "other"


def profiler_kernels(prof) -> List[Tuple[str, float]]:
    """(name, device µs) of every CUDA kernel of a finished torch.profiler run."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def chrome_trace_kernels(path: str) -> List[Tuple[str, float]]:
    """(name, device µs) of every kernel event of a Chrome trace that
    ``trace`` wrote."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e.get("dur", 0.0))) for e in events
            if e.get("cat") == "kernel" and e.get("ph") == "X"]


def device_breakdown(kernels: Iterable[Tuple[str, float]], wall_ms: float) -> dict:
    """Device time (ms) and kernel count by class of ``kernels`` ((name, µs)
    pairs), the top kernels, and the device's idle share against
    ``wall_ms``."""
    by_name, by_class, counts = {}, {}, {}
    for name, us in kernels:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + us / 1e3)
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
        counts[cls] = counts.get(cls, 0) + 1
    busy_ms = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1][1])[:12]
    return dict(
        device_busy_ms=busy_ms,
        device_idle_share=(1.0 - busy_ms / wall_ms) if busy_ms else None,
        by_class_ms={k: round(v, 3) for k, v in sorted(by_class.items(), key=lambda i: -i[1])},
        by_class_count=counts,
        top_kernels=[dict(name=n[:110], count=c, ms=round(t, 3)) for n, (c, t) in top],
    )
