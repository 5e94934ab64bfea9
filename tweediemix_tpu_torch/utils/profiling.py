"""Tracing and profiling hooks (counterpart of
``tweediemix_tpu/utils/profiling.py``).

* ``span(name, **attrs)``: the program's own spans (request, phase, sampler
  step, UNet call, block, W8A8 site). They record only while
  ``torch.profiler`` records (``torch.autograd.profiler._is_profiler_enabled``);
  otherwise a span is one flag read and a shared no-op object. A recorded
  span keeps its name, start and end on the profiler's clock
  (``time.time_ns()``), its own id, its parent's (the innermost open span)
  and its request's (the root's), its attributes, ``syncs`` (the
  synchronising CUDA operations while it was open, children included); it
  is also a ``record_function`` range of its name, so it lies in the profiler's timeline nested as the calls
  are. Spans are kept in memory (``TRACER``, at most ``SPAN_CAP``, the
  oldest dropped and counted; ``spans()`` reads them);
* ``phase(seconds, name, device)``: a run's phase timed into
  ``seconds[name]`` on the host clock, ending in a CUDA synchronise, and a
  span while the tracer records;
* ``trace(dir)``: a ``torch.profiler`` context (CPU activity, and CUDA
  where the card is present) that writes a Chrome trace (``trace.json``,
  viewable in Perfetto or ``chrome://tracing``) and the spans recorded
  meanwhile (``spans.json``, with the trace's ``baseTimeNanoseconds``) into
  ``dir`` when it closes; it yields the profiler;
* ``device_breakdown``: device time by kernel class of a finished profile
  (``profiler_kernels``) or of a Chrome trace file
  (``chrome_trace_kernels``), its top kernels and the device's idle share
  from the union of kernel intervals;
* ``graph_ms``, ``flushed_ms``: device ms per call of a function, warm or
  with the L2 flushed, from CUDA graphs timed with CUDA events (the host's
  enqueue rate cannot show); ``host_us_per_call``: the host's µs to
  enqueue one call.

Span names hold no ``::`` and do not start with ``cuda``: a profile's
readers take those for operators and runtime calls.

This module imports nothing of the package, so that a script can load it by
its path beside another tree's package (``tools/short_timing.py``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import re
import threading
import time
import warnings
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"
SPAN_CAP = 1 << 18
# what PyTorch warns at a synchronising CUDA operation under
# torch.cuda.set_sync_debug_mode("warn") (c10/cuda/CUDAFunctions.cpp)
SYNC_WARNING = "called a synchronizing CUDA operation"


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# -- spans -------------------------------------------------------------------------


class Span:
    """One span of the program; a context manager that opens it in
    ``TRACER``."""

    __slots__ = ("name", "attrs", "id", "parent", "request", "start_ns", "end_ns", "syncs",
                 "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = self.parent = self.request = self.start_ns = self.end_ns = None
        self.syncs = 0

    def __enter__(self):
        TRACER.open(self)
        return self

    def __exit__(self, *exc):
        TRACER.close(self)
        return False

    def as_dict(self) -> dict:
        return dict(name=self.name, id=self.id, parent=self.parent, request=self.request,
                    start_ns=self.start_ns, end_ns=self.end_ns, syncs=self.syncs,
                    attrs=self.attrs)


class _NoSpan:
    """What ``span`` returns while the profiler does not record."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class Tracer:
    """The recorded spans (oldest dropped past ``cap``, ``dropped`` counts
    them) and, per thread, the stack of open ones. While a thread's
    outermost span is open, PyTorch's sync debug mode warns at every
    synchronising CUDA operation and ``on_warning`` counts each into the
    thread's open spans; the mode and the warnings filters are restored
    when that span closes."""

    def __init__(self, cap: int = SPAN_CAP):
        self.spans: collections.deque = collections.deque(maxlen=cap)
        self.dropped = 0
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._roots = 0  # outermost spans open, over all threads
        # (catch_warnings, sync debug mode, showwarning before) while any is open
        self._saved = None

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, s: Span) -> None:
        stack = self._stack()
        if not stack:
            self._begin_sync_count()
        s.id = next(self._ids)
        s.parent = stack[-1].id if stack else None
        s.request = stack[0].id if stack else s.id
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        self.spans.append(s)
        stack.append(s)
        s.start_ns = time.time_ns()
        s._range = torch.profiler.record_function(s.name)
        s._range.__enter__()

    def close(self, s: Span) -> None:
        s._range.__exit__(None, None, None)
        s._range = None
        s.end_ns = time.time_ns()
        stack = self._stack()
        stack.pop()  # ``with`` closes the innermost first
        if not stack:
            self._end_sync_count()

    def on_warning(self, message, category, filename, lineno, file=None, line=None):
        """``warnings.showwarning`` while a span is open: a synchronising
        CUDA operation counts into every open span of this thread; any
        other warning goes on to the handler that was in place."""
        if str(message).startswith(SYNC_WARNING):
            for s in self._stack():
                s.syncs += 1
            return
        self._saved[2](message, category, filename, lineno, file, line)

    def _begin_sync_count(self) -> None:
        self._roots += 1
        if self._roots > 1:
            return
        caught = warnings.catch_warnings()
        caught.__enter__()
        warnings.filterwarnings("always", message=re.escape(SYNC_WARNING))
        mode = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        self._saved = (caught, mode, warnings.showwarning)
        warnings.showwarning = self.on_warning

    def _end_sync_count(self) -> None:
        self._roots -= 1
        if self._roots:
            return
        caught, mode, _ = self._saved
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        caught.__exit__(None, None, None)  # the filters and showwarning as they were
        self._saved = None

    def clear(self) -> None:
        self.spans.clear()
        self.dropped = 0


TRACER = Tracer()


def span(name: str, **attrs):
    """A span of the program (a context manager) while ``torch.profiler``
    records; otherwise a shared object that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return Span(name, attrs)


def recording() -> bool:
    """Whether spans record now (``torch.profiler`` records): a hot site
    asks before it computes a span's attributes."""
    return _autograd_profiler._is_profiler_enabled


def spans() -> List[dict]:
    """The recorded spans, oldest first (in the order they opened)."""
    return [s.as_dict() for s in TRACER.spans]


@contextlib.contextmanager
def phase(seconds: Dict[str, float], name: str, device):
    """Time the block into ``seconds[name]``: the host clock, up to a CUDA
    synchronise of ``device`` where it is a card, so the card's work counts;
    while the profiler records, the block is a span ``name`` too."""
    t0 = time.perf_counter()
    with span(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    seconds[name] = time.perf_counter() - t0


def chrome_trace_base_ns(path: str) -> Optional[int]:
    """The ``baseTimeNanoseconds`` of a Chrome trace that ``torch.profiler``
    wrote (its events' ``ts`` are µs after it), read from the file's head."""
    with open(path, "rb") as f:
        head = f.read(1 << 16).decode("utf-8", "replace")
    m = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    return int(m.group(1)) if m else None


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    to ``log_dir/trace.json`` and the spans recorded meanwhile to
    ``log_dir/spans.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    TRACER.clear()
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    trace_path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(trace_path)
    with open(os.path.join(log_dir, SPANS_FILE), "w") as f:
        json.dump(dict(baseTimeNanoseconds=chrome_trace_base_ns(trace_path),
                       dropped=TRACER.dropped, spans=spans()), f)


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


def profiler_kernels(prof) -> List[Tuple[str, float, float]]:
    """(name, start µs, device µs) of every CUDA kernel of a finished
    torch.profiler run."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def chrome_trace_kernels(path: str) -> List[Tuple[str, float, float]]:
    """(name, start µs, device µs) of every kernel event of a Chrome trace
    that ``trace`` wrote."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
            if e.get("cat") == "kernel" and e.get("ph") == "X"]


def device_breakdown(kernels: Iterable[Tuple[str, float, float]], wall_ms: float) -> dict:
    """Device time (ms) and kernel count by class of ``kernels`` ((name,
    start µs, µs) triples), the top kernels, and the device's idle share
    against ``wall_ms``: the device is busy over the union of the kernels'
    intervals, so kernels that overlap count once."""
    by_name, by_class, counts = {}, {}, {}
    intervals = []
    for name, start, us in kernels:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + us / 1e3)
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
        counts[cls] = counts.get(cls, 0) + 1
        intervals.append((start, start + us))
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_ms = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1][1])[:12]
    return dict(
        device_busy_ms=busy_ms,
        device_idle_share=(1.0 - busy_ms / wall_ms) if busy_ms else None,
        by_class_ms={k: round(v, 3) for k, v in sorted(by_class.items(), key=lambda i: -i[1])},
        by_class_count=counts,
        top_kernels=[dict(name=n[:110], count=c, ms=round(t, 3)) for n, (c, t) in top],
    )
