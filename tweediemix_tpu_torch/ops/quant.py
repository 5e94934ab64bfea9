"""Int8 (W8A8) serving path: int8 weights and int8 activations (counterpart
of ``tweediemix_tpu/ops/quant.py``).

* **Weights**: symmetric per-output-channel int8 with fp32 scales,
  quantised once from the fp32 values (``quantize_weight_int8``, and
  ``quantize_weight_int8_conv`` for OIHW conv kernels).
* **Activations**: a dynamic per-row scale (abs-max over the last axis) or,
  where a static abs-max is set for the site, one per-tensor scale
  ``amax/127``. Convolutions take a per-sample scale over C, H and W.
* **Product**: exact int8 x int8 -> int32 (``torch._int_mm``, a library
  GEMM: the JAX package left this product to XLA, outside any Pallas
  kernel), then ``acc * xscale * wscale`` in fp32, cast to x's dtype. The
  product is never taken in fp32: |acc| reaches 127²·5120 ≈ 8.3e7, past
  2^24.

``QLinear`` and ``QConv2d`` hold the int8 weight (``weight_q``, a buffer)
and its fp32 per-channel scales (``weight_scale``, kept fp32 when the module
is cast to bf16); their bias is cast with the module. No float copy of the
weight stays, except where ``keep_weight`` asks for one (the non-stacked
cross-attention K/V, whose precomputed cache uses the float weight, as the
JAX package's ``precompute_cross_kv`` does).

Each ``QLinear`` carries its site key: the JAX package's
``"/".join(scope.path)``, under which ``quant_scales_sdxl.json`` and
``tools/calibrate_quant.py`` store abs-max values. ``load_static_scales``
sets them from a table passed in explicitly (no environment snapshot);
``calibrate`` measures them.
"""

from __future__ import annotations

import json
from typing import Iterable, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tweediemix_tpu_torch.utils import profiling

QUANT_MODES = ("int8", "int8_conv")


def quantize_weight_int8(w: torch.Tensor):
    """Symmetric per-output-channel int8 quantisation of a Linear weight
    [out, in]. Returns ``(wq int8 [out, in], scale fp32 [out])`` with
    ``w ≈ wq * scale[:, None]``."""
    w = w.float()
    scale = torch.clamp_min(w.abs().amax(dim=1) / 127.0, 1e-12)
    wq = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return wq, scale


def quantize_weight_int8_conv(w: torch.Tensor):
    """The same for an OIHW conv kernel: one scale per output channel, over
    (in, kh, kw)."""
    w = w.float()
    scale = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-12)
    wq = torch.clamp(torch.round(w / scale[:, None, None, None]), -127, 127).to(torch.int8)
    return wq, scale


def _quantize(xf: torch.Tensor, xscale: torch.Tensor) -> torch.Tensor:
    """round (half to even) and clip to ±127."""
    return torch.clamp(torch.round(xf / xscale), -127, 127).to(torch.int8)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] x int8 [K, N] -> int32 [M, N]. cuBLAS takes M > 16
    only, so shorter inputs are zero-padded on the card."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a, b)[:m]


def w8a8_matmul(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                static_amax: float = 0.0) -> torch.Tensor:
    """``x @ dequant(wq).T`` with int8 activations. x [..., K]; wq int8
    [N, K]; wscale fp32 [N]. ``static_amax > 0`` gives the per-tensor scale
    ``static_amax/127``, else each row takes its own abs-max scale. Returns
    [..., N] in x's dtype."""
    xf = x.float()
    if static_amax > 0:
        xscale = torch.tensor(static_amax / 127.0, dtype=torch.float32, device=x.device)
    else:
        xscale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
    xq = _quantize(xf, xscale)
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq.t())
    acc = acc.reshape(*x.shape[:-1], wq.shape[0])
    return (acc.float() * xscale * wscale).to(x.dtype)


def w8a8_conv(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
              stride: int = 1, padding: int = 1) -> torch.Tensor:
    """NCHW ``conv(x, dequant(wq))`` with a per-sample int8 activation scale
    (max |x| over C, H, W of each batch row: the scale must be uniform over
    the receptive field to factor out of the int32 sum). wq int8 OIHW.

    The int32 sum is exact: one int8 GEMM per kernel tap over the strided,
    shifted input, summed in int32."""
    b, _, h, w = x.shape
    cout, _, kh, kw = wq.shape
    xf = x.float()
    xscale = torch.clamp_min(xf.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0, 1e-12)
    xq = _quantize(xf, xscale).permute(0, 2, 3, 1)  # NHWC
    xq = F.pad(xq, (0, 0, padding, padding, padding, padding))
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    taps = wq.permute(2, 3, 0, 1).contiguous()  # [kh, kw, out, in]
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            tap = xq[:, dy : dy + stride * (ho - 1) + 1 : stride,
                     dx : dx + stride * (wo - 1) + 1 : stride, :]
            part = int_mm(tap.reshape(b * ho * wo, -1), taps[dy, dx].t())
            acc = part if acc is None else acc + part
    acc = acc.reshape(b, ho, wo, cout).permute(0, 3, 1, 2)
    return (acc.float() * xscale * wscale[None, :, None, None]).to(x.dtype)


class _Int8Weight(nn.Module):
    """Shared part of QLinear and QConv2d: int8 weight, fp32 scales."""

    def _apply(self, fn, recurse=True):
        # Module.to(dtype) casts floating buffers; the per-channel scales stay
        # fp32 (only their device follows the module). A module built on the
        # meta device has no values to keep: to_empty gives it fp32 memory
        # that the checkpoint loader fills.
        scale = self.weight_scale
        super()._apply(fn, recurse)
        if scale.is_meta:
            self.weight_scale = self.weight_scale.float()
        else:
            self.weight_scale = scale.to(self.weight_scale.device)
        return self


class QLinear(_Int8Weight):
    """W8A8 counterpart of ``nn.Linear`` (the JAX package's ``QDense``).

    It draws its initial weight as ``nn.Linear`` does and quantises it in
    fp32 at once; ``models/convert.py`` loads converted weights the same
    way. ``static_amax`` (0 = dynamic per-row scales) and ``site`` are set
    by the UNet and ``load_static_scales``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 keep_weight: bool = False):
        super().__init__()
        ref = nn.Linear(in_features, out_features, bias=bias)
        wq, scale = quantize_weight_int8(ref.weight.detach())
        self.register_buffer("weight_q", wq)
        self.register_buffer("weight_scale", scale)
        self.weight = ref.weight if keep_weight else None
        self.bias = ref.bias
        self.static_amax = 0.0
        self.site = ""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a site runs 442 times a call: gate before the span's attributes are computed
        if not profiling.recording():
            return self._product(x)
        n, k = self.weight_q.shape
        with profiling.span("w8a8.site", scale="static" if self.static_amax > 0 else "dynamic",
                            m=x.numel() // k, k=k, n=n):
            return self._product(x)

    def _product(self, x: torch.Tensor) -> torch.Tensor:
        y = w8a8_matmul(x, self.weight_q, self.weight_scale, self.static_amax)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class QConv2d(_Int8Weight):
    """W8A8 counterpart of a 3x3 ``nn.Conv2d`` with padding 1 (the JAX
    package's ``QConv``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        ref = nn.Conv2d(in_channels, out_channels, 3, stride=stride, padding=1)
        wq, scale = quantize_weight_int8_conv(ref.weight.detach())
        self.register_buffer("weight_q", wq)
        self.register_buffer("weight_scale", scale)
        self.bias = ref.bias
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not profiling.recording():
            return self._product(x)
        cout, cin, kh, kw = self.weight_q.shape
        b, _, h, w = x.shape
        rows = b * ((h + 2 - kh) // self.stride + 1) * ((w + 2 - kw) // self.stride + 1)
        with profiling.span("w8a8.site", scale="dynamic", m=rows, k=cin * kh * kw, n=cout):
            return self._product(x)

    def _product(self, x: torch.Tensor) -> torch.Tensor:
        y = w8a8_conv(x, self.weight_q, self.weight_scale, stride=self.stride)
        return y + self.bias.to(y.dtype)[None, :, None, None]


def quant_sites(module: nn.Module) -> dict:
    """{site key: QLinear} of every quantised matmul under ``module``."""
    return {m.site: m for m in module.modules() if isinstance(m, QLinear)}


def load_static_scales(module: nn.Module, table: Union[Mapping, str, None],
                       default_amax: float = 0.0) -> int:
    """Set each quantised matmul's static activation abs-max from ``table``
    ({site: abs-max}, or the path of such a JSON file, e.g.
    ``quant_scales_sdxl.json``). A site missing from the table takes
    ``default_amax`` (0 keeps it dynamic; a positive value is the JAX
    package's global ``TWEEDIEMIX_QUANT_STATIC_SCALE``). Returns the number
    of sites found in the table."""
    if isinstance(table, str):
        with open(table) as f:
            table = json.load(f)
    table = {k: float(v) for k, v in (table or {}).items()}
    found = 0
    for site, m in quant_sites(module).items():
        found += site in table
        m.static_amax = table.get(site, default_amax)
    return found


@torch.inference_mode()
def calibrate(module: nn.Module, probe_args: Iterable[tuple], margin: float = 1.25) -> dict:
    """Run ``module(*args)`` for each probe and return {site: margin · the
    largest |x| seen at that site}: the table ``load_static_scales`` takes
    (``tools/calibrate_quant.py::calibrate`` with ``sow_amax``)."""
    amax = {}

    def record(m, inputs):
        seen = inputs[0].detach().float().abs().amax()
        amax[m.site] = seen if m.site not in amax else torch.maximum(amax[m.site], seen)

    hooks = [m.register_forward_pre_hook(record) for m in quant_sites(module).values()]
    try:
        for args in probe_args:
            module(*args)
    finally:
        for h in hooks:
            h.remove()
    return {site: margin * float(v) for site, v in amax.items()}
