"""What the drivers share for the output check: the recorder that keeps each
UNet call of a request (its latent input and noise prediction) with the
request's output and final latent in reservoir slots on the device, and
the plain sampler run step by step from those recorded predictions.

The slots are allocated once and reused, so they hold the same bytes all
through the window; ``Recorder.bytes`` is what they hold on the device,
which the harness takes off the window's peak so that ``peak_mem_gib`` is
the program's own.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


class Recorder:
    """Each UNet call's latent input (``x_shape``) and noise prediction
    (``eps_shape``, the call's rows first), with ``key(x, t, args, eps)`` of
    the call, the request's output (``out_shape``) and its final latent
    (``latent_shape``), in ``slots`` slots of ``calls`` calls each. ``on`` records; ``label`` runs each call under a
    ``unet_call.b<rows>`` profiler range instead. ``watch`` adds one layer
    of the program's UNet whose input and output rows are kept too."""

    def __init__(self, slots: int, calls: int, x_shape, eps_shape, out_shape, latent_shape,
                 device, take_x: Callable, key: Callable):
        self.device, self.bytes = device, 0
        self.x = self.alloc((slots, calls, *x_shape), torch.float32)
        self.eps = self.alloc((slots, calls, *eps_shape), torch.float32)
        self.outputs = self.alloc((slots, *out_shape), torch.float32)
        self.latents = self.alloc((slots, *latent_shape), torch.float32)
        self.meta = [[] for _ in range(slots)]  # key of each call, per slot
        self.calls, self.slot, self.on, self.label = calls, 0, False, False
        self.take_x, self.key = take_x, key
        self.in_call = False
        self.site_x: Optional[torch.Tensor] = None
        self.site_y: Optional[torch.Tensor] = None

    def alloc(self, shape, dtype) -> torch.Tensor:
        """A slot tensor; its device bytes, as the allocator counts them,
        go into ``bytes``."""
        cuda = self.device.type == "cuda"
        before = torch.cuda.memory_allocated(self.device) if cuda else 0
        out = torch.empty(shape, dtype=dtype, device=self.device)
        self.bytes += (torch.cuda.memory_allocated(self.device) - before if cuda
                       else out.numel() * out.element_size())
        return out

    def watch(self, module: torch.nn.Module, rows: int) -> None:
        """Keep ``rows`` rows, evenly strided, of ``module``'s input and
        output at each recorded call; the slots are allocated at its first
        call (in the warm-up)."""
        def hook(mod, inputs, out):
            if not self.in_call:
                return
            x = inputs[0].reshape(-1, inputs[0].shape[-1])
            y = out.reshape(-1, out.shape[-1])
            step = max(1, x.shape[0] // rows)
            x, y = x[::step][:rows], y[::step][:rows]
            if self.site_x is None:
                slots = len(self.meta)
                self.site_x = self.alloc((slots, self.calls, *x.shape), torch.float32)
                self.site_y = self.alloc((slots, self.calls, *y.shape), torch.float32)
            j = len(self.meta[self.slot])
            if self.on and j < self.calls:
                self.site_x[self.slot, j].copy_(x)
                self.site_y[self.slot, j].copy_(y)

        module.register_forward_hook(hook)

    def begin(self, slot: int) -> None:
        self.slot, self.on = slot, True
        self.meta[slot] = []

    def end(self, output: torch.Tensor, latent: torch.Tensor) -> None:
        """Keep the request's output and final latent in its slot."""
        self.on = False
        self.outputs[self.slot].copy_(output)
        self.latents[self.slot].copy_(latent)

    def wrap(self, fn):
        def unet_fn(x, t, *args, **kw):
            if kw.get("return_cache"):  # the video UNet's step-invariant pass: no call
                return fn(x, t, *args, **kw)
            if self.label:
                with torch.profiler.record_function(f"unet_call.b{x.shape[0]}"):
                    return fn(x, t, *args, **kw)
            self.in_call = True
            try:
                eps = fn(x, t, *args, **kw)
            finally:
                self.in_call = False
            if self.on:
                meta = self.meta[self.slot]
                j = len(meta)
                if j < self.calls:
                    self.x[self.slot, j].copy_(self.take_x(x))
                    self.eps[self.slot, j, :eps.shape[0]].copy_(eps)
                meta.append(self.key(x, t, args, eps))
            return eps
        return unet_fn


def plain_run(rec: Recorder, slot: int, run: Callable, dtype):
    """(the latent input of each call, the final latent) of ``run(dtype,
    predict)``, the plain sampler in ``dtype``, fed the recorded
    predictions: it calls ``predict(x, key, rows)``. (None, None) where the
    program's calls do not match the configuration's."""
    meta = rec.meta[slot]
    xs, bad = [], [False]

    def predict(xr, key, rows):
        i = len(xs)
        xs.append(xr)
        if i >= len(meta) or i >= rec.calls or meta[i] != key:
            bad[0] = True
            return torch.zeros((rows, *xr.shape[1:]), device=xr.device)
        return rec.eps[slot, i, :rows]

    final = run(dtype, predict)
    if bad[0] or len(xs) != len(meta):
        return None, None
    return xs, final


def follow(rec: Recorder, slot: int, run: Callable, control: bool = False):
    """(the program's gap, the control's gap or None). The program's: the
    plain sampler fed the recorded predictions, the largest gap of a call's
    recorded latent input or of the final latent from it, relative to the
    plain value's largest. The control's: the same plain run in bfloat16
    against the fp32 one."""
    xs, fin = plain_run(rec, slot, run, torch.float32)
    if xs is None:
        return float("inf"), float("inf") if control else None
    gaps = [rel_max(rec.x[slot, i], x) for i, x in enumerate(xs)]
    program = max(gaps + [rel_max(rec.latents[slot], fin)])
    if not control:
        return program, None
    xs16, fin16 = plain_run(rec, slot, run, torch.bfloat16)
    if xs16 is None:
        return program, float("inf")
    return program, max([rel_max(a, b) for a, b in zip(xs16, xs)] + [rel_max(fin16, fin)])
