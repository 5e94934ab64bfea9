"""The benchmark's general part: cells found by name, the closed-loop window,
the kernel check of every request, the reservoir of requests kept for the
output check, the traced slice and its reduction, and the result line.

A cell is ``workloads/<cell>.json``; it names its configuration
``configs/<config>.json``, whose ``system`` names the driver module
``systems/<system>.py``. A per-layer metric is read by
``metrics/<metric>.py``'s ``read(ctx)``, which returns a number or None; a
metric named ``<quantity>.<cells>`` with no file of its own is read by
``metrics/<quantity>.py``.
``BENCHMARK.json`` (at the checkout's root) says which metrics a cell
reports. Nothing here imports the measured program; the drivers do.
"""

from __future__ import annotations

import bisect
import importlib
import importlib.util
import json
import math
import os
import resource
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tweediemix_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str):
    """(workload, configuration) of cell ``name``."""
    path = BENCH / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no cell {name!r}: {path} is missing")
    wl = read_json(path)
    return wl, read_json(BENCH / "configs" / f"{wl['config']}.json")


def cell_metrics(spec: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those whose ``workloads`` name it, or that have none."""
    return [m for m in spec[section] if cell in m.get("workloads", [cell])]


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES,
    compared whole (``tweediemix_tpu_torch`` is not ``tweediemix_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN_MODULES))


def request_seed(seed: int, i: int) -> int:
    """The latent seed of the window's request ``i``: a 31-bit number drawn
    from (``seed``, i)."""
    return int(np.random.SeedSequence([abs(seed), 0x5EED, i]).generate_state(1)[0] >> 1)


class Reservoir:
    """Keeps a uniform sample of ``k`` of the requests offered, drawn from
    the seed, in ``k + 1`` record slots that are reused: the driver records
    each request into ``current`` and offers it at its end."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([abs(seed), 0xCE11])
        self.kept: List[dict] = []  # {"slot", "index", ...}
        self.current = 0
        self.free = list(range(1, k + 1))
        self.offered = 0

    def offer(self, info: dict) -> None:
        i = self.offered
        self.offered += 1
        info = dict(info, slot=self.current, index=i)
        if len(self.kept) < self.k:
            self.kept.append(info)
            self.current = self.free.pop(0)
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.current, self.kept[j] = self.kept[j]["slot"], info


def steal_seconds() -> float:
    """Seconds the machine's CPUs waited for their host (``/proc/stat``'s
    steal), or 0 where it is not kept."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def host_reading() -> tuple:
    """(wall, this thread's CPU seconds, its involuntary context switches,
    the machine's steal seconds) now."""
    use = resource.getrusage(getattr(resource, "RUSAGE_THREAD", resource.RUSAGE_SELF))
    return time.perf_counter(), time.thread_time(), use.ru_nivcsw, steal_seconds()


def run_window(request: Callable[[int, int], dict], seconds: float, seed: int) -> dict:
    """Requests back to back, one at a time (a closed loop of one client);
    none starts after ``seconds``. Returns the requests' results and the
    window's length, from its opening to the end of its last request. Each
    result gets its ``seconds`` and, in ``host``, what the launching
    thread spent of them on the CPU, how often it was preempted, and how
    long the machine's CPUs waited for their host meanwhile."""
    results = []
    t0 = time.perf_counter()
    while not results or time.perf_counter() - t0 < seconds:
        i = len(results)
        before = host_reading()
        out = request(i, request_seed(seed, i))
        after = host_reading()
        out["seconds"] = after[0] - before[0]
        out["host"] = dict(cpu_s=after[1] - before[1], preempted=after[2] - before[2],
                           steal_s=after[3] - before[3])
        results.append(out)
    return dict(results=results, window_s=time.perf_counter() - t0)


def judge(numbers: Dict[str, float], limits: Dict[str, float], failed: int):
    """(correct, {name: [value, limit]}): every compared number within its
    limit, and no request off its kernel path."""
    compared = {k: [v, limits.get(k)] for k, v in numbers.items()}
    correct = (not failed and bool(compared)
               and all(lim is not None and math.isfinite(v) and v <= lim
                       for v, lim in compared.values()))
    compared["missed_kernel_path"] = [failed, 0]
    return correct, compared


# -- the traced slice ----------------------------------------------------------------


def kineto_events(prof):
    """(name, is_device, start_ns, end_ns, is_user_range) of every event of
    a finished torch.profiler run, read from its kineto results (building
    ``prof.events()`` for a slice's some hundred thousand events takes
    minutes)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start,
                    start + e.duration_ns(), bool(getattr(e, "is_user_annotation", bool)())))
    return out


def union_intervals(spans):
    """Sorted, merged (start, end) intervals."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


KERNEL_CLASSES = (  # (class, substrings of the kernel's name), first match wins
    ("short_attention", ("short_attn_kernel",)),
    ("flash_attention_int8", ("flash_int8_wgmma_kernel", "absmax_kernel", "quantize_kernel<")),
    ("flash_attention", ("flash_fwd_kernel",)),
    ("layout", ("nchwToNhwc", "nhwcToNchw")),
    ("convolution", ("fprop", "conv", "dgrad", "winograd")),
    ("gemm_int8", ("s8s8", "i8i8", "imma", "_s8_", "_i8_", "int8")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "Kernel2")),
    ("norm", ("norm", "moments")),
    ("softmax", ("softmax",)),
    ("elementwise/copy", ("elementwise", "vectorized", "copy", "cat", "fill", "reduce", "index")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k.lower() in low for k in keys):
            return cls
    return "other"


def reduce_trace(events, span_name: str) -> dict:
    """The slice's numbers from its events: its host span (the user range
    ``span_name``), the device's busy seconds as the union of kernel
    intervals inside it, device seconds by kernel class and by kernel, and
    the idle gaps, each put to the innermost host range open at its
    start."""
    spans = [(s, e) for n, dev, s, e, _ in events if not dev and n == span_name]
    if not spans:
        return {}
    lo, hi = spans[0]
    # a host range (record_function) shows on the device's timeline too; it is no kernel
    ranges = {n for n, dev, *_ in events if not dev and "::" not in n and not n.startswith("cuda")}
    kernels = [(n[:160], max(s, lo), min(e, hi)) for n, dev, s, e, _ in events
               if dev and e > lo and s < hi and n not in ranges]
    busy = union_intervals([(s, e) for _, s, e in kernels])
    by_class: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for n, s, e in kernels:
        by_class[kernel_class(n)] = by_class.get(kernel_class(n), 0.0) + (e - s) * 1e-9
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
    host = sorted((s, e, n) for n, dev, s, e, _ in events
                  if not dev and lo <= s and e <= hi and n != span_name and not n.startswith("cuda"))
    ranges = [h for h in host if "::" not in h[2]]  # the user's ranges (record_function)
    ops = [h for h in host if "::" in h[2]]
    starts = [h[0] for h in ops]

    def innermost(seq, g0, back):
        i = bisect.bisect_right([h[0] for h in seq] if seq is not ops else starts, g0) - 1
        for k in range(i, max(-1, i - back), -1):
            if seq[k][1] >= g0:
                return seq[k][2]
        return None

    gaps: Dict[str, float] = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        parts = (innermost(ranges, g0, len(ranges)), innermost(ops, g0, 64))
        label = " > ".join(p for p in parts if p) or "host"
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-9
    return dict(window_s=(hi - lo) * 1e-9, busy_s=sum(e - s for s, e in busy) * 1e-9,
                by_class=by_class, by_name=by_name, gaps=gaps)


def trace_slice(work: Callable[[], None], device: str) -> dict:
    """Profile ``work`` (a steady slice of the cell's requests, ending in a
    CUDA synchronise) twice. First with the device's activity alone, the
    host clock around it: the slice's length, the device's busy seconds as
    the union of its kernel intervals, device seconds by kernel class and
    by kernel. Then with the host's activity too, whose cost per operation
    stretches the host's share, for the idle gaps by what the host was
    doing. Events are kept in memory; no trace file is written."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    out: Dict = dict(window_s=0.0, busy_s=0.0, by_class={}, by_name={})
    if device == "cuda":
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            work()
            out["window_s"] = time.perf_counter() - t0
        events = kineto_events(prof)
        lo = min((s for _, dev, s, _, _ in events if dev), default=0)
        hi = max((e for _, dev, _, e, _ in events if dev), default=0)
        span = events + [("bench.device", False, lo, hi, True)]
        dev_only = reduce_trace(span, "bench.device")
        out.update(busy_s=dev_only.get("busy_s", 0.0), by_class=dev_only.get("by_class", {}),
                   by_name=dev_only.get("by_name", {}))
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=activities) as prof:
        with record_function("bench.slice"):
            work()
    out["gaps"] = reduce_trace(kineto_events(prof), "bench.slice").get("gaps", {})
    return out


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def read_metric(name: str, ctx: dict) -> Optional[float]:
    """The reading of this run by ``metrics/<name>.py``, or else by
    ``metrics/<name up to its first dot>.py``; None where it finds nothing."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(ctx)
    if value is None or not math.isfinite(value):
        return None
    return float(value)


# -- the run -----------------------------------------------------------------------


def run(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", chips_check: bool = True, spec=None, cell_data=None) -> int:
    """One run of ``cell``; prints the result line last on standard output.
    Returns the exit code. ``spec`` and ``cell_data`` ((workload,
    configuration)) stand in for the files, and ``device``/``chips_check``
    for the card, in the tests."""
    import torch

    spec = read_json(ROOT / "BENCHMARK.json") if spec is None else spec
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    chips = entry["chips"] if entry else 1
    if chips_check and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"benchmark: cell {cell} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 3
    if device == "cuda":
        torch.set_num_threads(1)  # the host only launches work: one thread, no contention
    wl, cfg = load_cell(cell) if cell_data is None else cell_data
    for key, value in wl.get("env", {}).items():
        os.environ[key] = value
    driver = importlib.import_module(f"benchmark.systems.{cfg['system']}")
    system = driver.System(cfg, wl, seed, device)
    system.warm()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    reservoir = Reservoir(wl["check"]["requests"], seed)

    def request(i, req_seed):
        before = system.launch_counts()
        out = system.request(req_seed, reservoir.current)
        after = system.launch_counts()
        out["launches"] = {k: after[k] - before[k] for k in after}
        reservoir.offer(dict(seed=req_seed, **{k: v for k, v in out.items() if k != "launches"}))
        return out

    window = run_window(request, seconds, seed)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    # the check's record slots are on the device all through the window
    program_peak = peak - system.recorder.bytes if device == "cuda" else 0
    results = window["results"]
    expected = system.expected_launches()
    failed = [i for i, r in enumerate(results) if r["launches"] != expected]

    ctx = dict(results=results, window_s=window["window_s"], config=cfg, workload=wl,
               system=system, requests=len(results))
    if trace:
        work, shape = system.traced_slice()
        ctx["slice"] = dict(trace_slice(work, device), **shape)
    numbers, _ = system.check(reservoir)
    correct, compared = judge(numbers, wl["limits"], len(failed))

    if trace:
        metrics = {}
        for m in cell_metrics(spec, cell, "per_layer"):
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        per_request = window["window_s"] / len(results)
        e2e = {"setup_s": setup_s, "peak_mem_gib": program_peak / 2**30,
               f"s_per_{system.unit}": per_request}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(spec, cell, "end_to_end") if m["name"] in e2e}

    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of {found} are loaded; the run may not use them",
              file=sys.stderr)
        return 4
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": chips, "memory_peak_bytes": int(peak)}
    line = dict(correct=bool(correct), attempted=len(results), failed=len(failed),
                metrics=metrics, device=dev)
    if trace and ctx.get("slice"):
        sl = ctx["slice"]
        dev.update(busy_s=sl["busy_s"], window_s=sl["window_s"])
        line["breakdown"] = {"device_ops": top(sl["by_name"]), "idle_gaps": top(sl["gaps"])}
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines())
        print(f"bytes written by this process: {int(io['write_bytes'])}", file=sys.stderr)
    except (OSError, KeyError, ValueError):
        pass
    print(f"device peak {peak} bytes, of which the check's record slots "
          f"{system.recorder.bytes}", file=sys.stderr)
    for i, r in enumerate(results):
        print(f"request {i}: {r['seconds']!r} s, host {json.dumps(r['host'])}, "
              f"phases {json.dumps(r.get('phases', {}))}", file=sys.stderr)
    if failed:
        print(f"requests off their kernel path: {[(i, results[i]['launches']) for i in failed][:5]}"
              f"; expected {expected}", file=sys.stderr)
    line["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        print(f"compared {k} = {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0
