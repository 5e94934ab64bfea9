"""CUDA graphs of the SDXL UNet call, one per call shape (the counterpart of
the JAX package's jitted scan bodies, ``tweediemix_tpu/fusion/sampler.py``).

``UNetGraphs(unet)(x, t, ctx, pooled, time_ids, idx)`` is the fusion
pipeline's UNet call. Its body is ``precompute_cross_kv`` then the
forward's body (``UNet2DConditionModel.denoise``): the cross-attention K/V
is built on every call, from the call's own context, so the runner
computes one function on every device and nothing of the K/V outlives a
call. Where a call's inputs are not on a card with autograd off
(``engages``: the CPU, under autograd) the runner runs that body on the
caller's inputs through ``UNet2DConditionModel.forward``, whose ``unet``
span says ``graph="eager"`` (the K/V is built just before it), so that
whatever wraps the forward (the benchmark's planted faults) wraps this
call too.

On a card an eager forward makes some thousand launches and their Python
a call, about as long as the card takes to run them, so the host sets the
pace. There a call costs a few input copies and one graph launch:

* the first call of a key (the card, the shapes and dtypes of the inputs,
  and ``ops/attention.py::dispatch_key``, the knobs that choose the
  kernels) runs the body eagerly on a side stream (cuDNN and cuBLAS
  plans, the kernels' first load), returns that result, and captures the
  same work into a graph, in the one memory pool that every graph of the
  runner shares (the runner's UNet lives on one card);
* a later call copies ``x``, ``ctx``, ``pooled``, ``time_ids`` and ``idx``
  into the key's static buffers, writes the timestep (a number) with
  ``fill_`` (a kernel with the scalar as its argument, no host-to-device
  copy; fp32, which holds a step number exactly), replays
  the graph on the current stream and returns a clone of the static output,
  so that no later call overwrites a prediction a caller still holds. No
  call synchronises with the host.

The pool holds the call's intermediates, the K/V among them, between
calls, where the eager body hands them back to the allocator.

A replay runs no Python of the forward, so it opens no span below ``unet``
and no kernel wrapper counts its launches. The runner opens the ``unet``
span of a capture or a replay itself, with ``rows`` and ``graph``
(``"capture"`` or ``"replay"``; the forward's own span says ``"eager"``).
After a capture it reads the
graph's kernel nodes through libcuda (``graph_kernel_names``) and
checks that each counted kernel (``ops/cuda_build.py::LAUNCH_COUNTERS``)
is there as often as its wrapper counted launches during the capture, or
raises. Each replay adds that node count to the wrapper's ``launches``:
what the replay launches, read off the graph, so a counter holds every
launch of its kernel on the card, eager or replayed.

A graph holds the UNet's weights by address and each W8A8 site's static
scale as it was at the capture: after such a weight tensor or scale is
replaced, a new ``UNetGraphs`` captures afresh.
"""

from __future__ import annotations

import ctypes
import functools
import re
import threading
from typing import Dict, List, NamedTuple

import torch

from tweediemix_tpu_torch.models.unet2d import UNet2DConditionModel, precompute_cross_kv
from tweediemix_tpu_torch.ops.attention import dispatch_key
from tweediemix_tpu_torch.ops.cuda_build import LAUNCH_COUNTERS
from tweediemix_tpu_torch.utils.profiling import span


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of ``cuda.h``."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


@functools.cache
def _libcuda() -> ctypes.CDLL:
    cu = ctypes.CDLL("libcuda.so.1")
    vp, pp = ctypes.c_void_p, ctypes.POINTER
    for name, args in (("cuGraphGetNodes", [vp, vp, pp(ctypes.c_size_t)]),
                       ("cuGraphNodeGetType", [vp, pp(ctypes.c_int)]),
                       ("cuGraphKernelNodeGetParams_v2", [vp, pp(_KernelNodeParams)]),
                       ("cuFuncGetName", [pp(ctypes.c_char_p), vp]),
                       ("cuKernelGetName", [pp(ctypes.c_char_p), vp])):
        getattr(cu, name).argtypes = args
        getattr(cu, name).restype = ctypes.c_int
    return cu


def graph_kernel_names(raw_graph: int) -> List[str]:
    """The kernel of each kernel node of a CUDA graph (a ``cudaGraph_t``,
    ``CUDAGraph.raw_cuda_graph()``), by the name libcuda gives it (mangled;
    "" where it gives none)."""
    cu = _libcuda()
    n = ctypes.c_size_t()
    err = cu.cuGraphGetNodes(raw_graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    if not err:
        err = cu.cuGraphGetNodes(raw_graph, nodes, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    names = []
    for node in nodes:
        kind, params, name = ctypes.c_int(), _KernelNodeParams(), ctypes.c_char_p()
        if cu.cuGraphNodeGetType(node, ctypes.byref(kind)) or kind.value != 0:  # KERNEL
            continue
        if cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)):
            names.append("")
            continue
        err = (cu.cuFuncGetName(ctypes.byref(name), params.func) if params.func
               else cu.cuKernelGetName(ctypes.byref(name), params.kern))
        names.append("" if err or name.value is None else name.value.decode())
    return names


def kernel_launches(names: List[str], kernel: str) -> int:
    """How many of ``names`` (kernel names, mangled or not) are ``kernel``, a
    ``__global__`` function's name in its source: a mangled name holds it
    with its length before it."""
    plain = re.compile(rf"(?<!\w){re.escape(kernel)}(?!\w)")
    return sum(f"{len(kernel)}{kernel}" in n or bool(plain.search(n)) for n in names)


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple  # static x, ctx, pooled, time_ids, idx
    t: torch.Tensor  # static timestep
    out: torch.Tensor  # static noise prediction
    launches: tuple  # (wrapper, its kernel's nodes in the graph), for each counted kernel in it


class UNetGraphs:
    """The UNet call of one UNet, through a CUDA graph per call shape where
    it engages (module docstring). ``captures`` and ``replays`` count the
    calls that took each way."""

    def __init__(self, unet: UNet2DConditionModel):
        self.unet = unet
        self.graphs: Dict[tuple, _Graph] = {}
        self.pool = None  # the memory pool every graph shares, from the first capture
        self.side = None  # the stream of the captures and their eager warm-ups
        self.captures = self.replays = 0
        self._lock = threading.Lock()  # one capture or replay at a time

    @staticmethod
    def engages(x: torch.Tensor) -> bool:
        """Whether a call with this input goes through a graph: on a card,
        with autograd off."""
        return x.is_cuda and not torch.is_grad_enabled()

    def __call__(self, x, t, ctx, pooled, time_ids, idx) -> torch.Tensor:
        if not self.engages(x):
            return self._body(self.unet, (x, ctx, pooled, time_ids, idx), t)
        key = (x.device, *((tuple(a.shape), a.dtype) for a in (x, ctx, pooled, time_ids, idx)),
               *dispatch_key())
        with self._lock, torch.cuda.device(x.device):
            with torch.inference_mode():
                g = self.graphs.get(key)
                if g is None:
                    with span("unet", rows=x.shape[0], graph="capture"):
                        out = self._capture(key, x, t, ctx, pooled, time_ids, idx)
                else:
                    with span("unet", rows=x.shape[0], graph="replay"):
                        for buf, a in zip(g.inputs, (x, ctx, pooled, time_ids, idx)):
                            buf.copy_(a)
                        g.t.fill_(t)
                        g.graph.replay()
                        for fn, n in g.launches:
                            fn.launches += n
                        self.replays += 1
                        out = g.out
            # before the next call can replay over it; outside this inference mode,
            # so the caller gets the kind of tensor the eager forward gives it
            return out.clone()

    def _body(self, run, inputs, t):
        """``run``: the forward (eager) or its body without the span (a
        capture, inside the runner's own span)."""
        x, ctx, pooled, time_ids, idx = inputs
        kv = precompute_cross_kv(self.unet, ctx, idx)
        return run(x, t, ctx, pooled, time_ids, idx, cross_kv=kv)

    def _capture(self, key, x, t, ctx, pooled, time_ids, idx) -> torch.Tensor:
        dev = x.device
        inputs = tuple(a.clone(memory_format=torch.contiguous_format)
                       for a in (x, ctx, pooled, time_ids, idx))
        ts = torch.empty((), dtype=torch.float32, device=dev).fill_(t)
        current = torch.cuda.current_stream(dev)
        if self.side is None:
            self.side = torch.cuda.Stream(dev)
        side = self.side
        side.wait_stream(current)
        with torch.cuda.stream(side):
            eager = self._body(self.unet.denoise, inputs, ts)
        current.wait_stream(side)
        eager.record_stream(current)

        counted = list(LAUNCH_COUNTERS.values())
        before = [fn.launches for fn in counted]
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # its nodes are read below
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                out = self._body(self.unet.denoise, inputs, ts)
            recorded = [fn.launches - b for fn, b in zip(counted, before)]
        finally:  # the capture ran nothing on the card: take back what it counted
            for fn, b in zip(counted, before):
                fn.launches = b
        graph.instantiate()
        names = graph_kernel_names(graph.raw_cuda_graph())
        nodes = [kernel_launches(names, fn.kernel) for fn in counted]
        if nodes != recorded:
            raise RuntimeError(
                f"the captured UNet call holds {dict(zip((f.kernel for f in counted), nodes))} "
                f"nodes of the counted kernels, their wrappers launched "
                f"{dict(zip((f.kernel for f in counted), recorded))}")
        self.pool = graph.pool()
        self.graphs[key] = _Graph(graph, inputs, ts, out,
                                  tuple((fn, n) for fn, n in zip(counted, nodes) if n))
        self.captures += 1
        return eager
