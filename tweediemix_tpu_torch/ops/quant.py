"""Int8 (W8A8) serving path: int8 weights and int8 activations (counterpart
of ``tweediemix_tpu/ops/quant.py``).

* **Weights**: symmetric per-output-channel int8 with fp32 scales,
  quantised once from the fp32 values (``quantize_weight_int8``, and
  ``quantize_weight_int8_conv`` for OIHW conv kernels).
* **Activations**: a dynamic per-row scale (abs-max over the last axis) or,
  where a static abs-max is set for the site, one per-tensor scale
  ``amax/127``. Convolutions take a per-sample scale over C, H and W.
* **Product**: exact int8 x int8 -> int32, then ``acc * xscale * wscale``
  in fp32, cast to x's dtype, then the bias added in that dtype. The
  product is never taken in fp32: |acc| reaches 127²·5120 ≈ 8.3e7, past
  2^24. The JAX package left it to XLA, outside any Pallas kernel. On the
  card ``w8a8_matmul`` runs it as two hand-written Hopper launches
  (``csrc/w8a8_linear.cu``: a one-pass quantise, then an int8 ``wgmma``
  GEMM with the dequantise, cast and bias in its epilogue), bit for bit
  the plain version ``w8a8_matmul_reference``, which CPU tensors take.
  Convolutions keep ``torch._int_mm`` (``int_mm``), one per kernel tap.

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

import ctypes
import functools
import json
from typing import Iterable, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tweediemix_tpu_torch.ops.cuda_build import check_launch, counts_launches, load_library
from tweediemix_tpu_torch.utils import profiling

QUANT_MODES = ("int8", "int8_conv")
# the activation dtypes the W8A8 kernels take (their C entry's codes), and
# the GEMM's tile of rows x columns; K and N must be multiples of 16
W8A8_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
W8A8_BLOCK_M, W8A8_BLOCK_N = 128, 160


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


def quantize_activation_int8(x: torch.Tensor, static_amax: float = 0.0):
    """The plain version's int8 activations: (xq int8 [..., K], xscale
    fp32), the scale a 0-d tensor ``static_amax/127`` where static_amax > 0,
    else each row's ``max(abs-max / 127, 1e-12)`` [..., 1]."""
    xf = x.float()
    if static_amax > 0:
        xscale = torch.tensor(static_amax / 127.0, dtype=torch.float32, device=x.device)
    else:
        xscale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
    return _quantize(xf, xscale), xscale


def w8a8_matmul_reference(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                          static_amax: float = 0.0, bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version of ``w8a8_matmul``, on any device: the quantise, the
    int8 product and the dequantise as PyTorch operations."""
    xq, xscale = quantize_activation_int8(x, static_amax)
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq.t())
    acc = acc.reshape(*x.shape[:-1], wq.shape[0])
    y = (acc.float() * xscale * wscale).to(x.dtype)
    return y if bias is None else y + bias.to(y.dtype)


def w8a8_matmul(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                static_amax: float = 0.0, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ dequant(wq).T (+ bias)`` with int8 activations. x [..., K]; wq
    int8 [N, K]; wscale fp32 [N]; bias [N] or None. ``static_amax > 0``
    gives the per-tensor scale ``static_amax/127``, else each row takes its
    own abs-max scale. Returns [..., N] in x's dtype, the bias added after
    the cast.

    On a CUDA tensor this launches the two Hopper kernels
    (``w8a8_matmul_cuda``) or raises; on a CPU tensor it returns the plain
    version."""
    if not x.is_cuda:
        return w8a8_matmul_reference(x, wq, wscale, static_amax, bias)
    return w8a8_matmul_cuda(x, wq, wscale, static_amax, bias)


def check_w8a8_args(k: int, n: int, dtype: torch.dtype) -> None:
    """Raise on what the W8A8 kernels do not take: K or N not a multiple of
    16, an activation dtype without a kernel."""
    if dtype not in W8A8_DTYPE_CODES:
        raise TypeError(f"W8A8 kernels take {sorted(map(str, W8A8_DTYPE_CODES))} activations, "
                        f"got {dtype}")
    if k % 16 or n % 16 or k < 16 or n < 16:
        raise ValueError(f"W8A8 kernels take K and N multiples of 16, got K={k}, N={n}")


def gemm_grid(m: int, n: int, sms: int) -> int:
    """Blocks of the persistent GEMM at [m, K] x [n, K]: one per SM, at most
    one per tile of ``W8A8_BLOCK_M`` x ``W8A8_BLOCK_N``."""
    return min(-(-m // W8A8_BLOCK_M) * -(-n // W8A8_BLOCK_N), sms)


def w8a8_work_bytes(m: int, k: int, dynamic: bool) -> int:
    """Bytes of the work buffer between the two launches: x_q int8 [m, k],
    then, for a dynamic scale, the rows' fp32 scales [m] at byte
    ``16·ceil(m·k/16)``."""
    return -(-m * k // 16) * 16 + 4 * m * dynamic


def bind(lib):
    """The typed C entry point of a built W8A8 library."""
    fn = lib.tm_w8a8_linear
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_float, ctypes.c_void_p]
    return fn


@functools.cache
def _launcher():
    lib = load_library("w8a8_linear")
    return lib, bind(lib)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (x.shape, wq.shape, dtype, device index) -> (m, out_shape, the work
# buffer's bytes for a static and a dynamic scale, the C plan {m, n, k, dtype
# code, grid} and its address): a site's checks and plan, made once
_SITE_PLANS: dict = {}


def _site_plan(x: torch.Tensor, wq: torch.Tensor, index: int) -> tuple:
    key = (x.shape, wq.shape, x.dtype, index)
    plan = _SITE_PLANS.get(key)
    if plan is None:
        n, k = wq.shape
        check_w8a8_args(k, n, x.dtype)
        if x.shape[-1] != k:
            raise ValueError(f"x has {x.shape[-1]} features, the weight {k}")
        m = x.numel() // k
        c_plan = (ctypes.c_int32 * 5)(m, n, k, W8A8_DTYPE_CODES[x.dtype],
                                      gemm_grid(m, n, _sms(index)) if m else 0)
        plan = (m, (*x.shape[:-1], n), (w8a8_work_bytes(m, k, False), w8a8_work_bytes(m, k, True)),
                c_plan, ctypes.addressof(c_plan))
        _SITE_PLANS[key] = plan
    return plan


def w8a8_matmul_cuda(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                     static_amax: float = 0.0, bias: Optional[torch.Tensor] = None,
                     work: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``w8a8_matmul`` on the card: the quantise and the GEMM, two launches
    on the current stream; raises on what the kernels do not take. The
    quantise writes x_q and the rows' scales to a block of the caching
    allocator, or to ``work`` where it is given (a contiguous, 16-byte
    aligned uint8 tensor of at least ``w8a8_work_bytes`` on x's card, laid
    out as that function says), where a caller can read them. ``w8a8_matmul_cuda.launches`` counts the calls
    that launch the kernels."""
    index = x.get_device()
    m, out_shape, work_bytes, _, plan = _site_plan(x, wq, index)
    n = wq.shape[0]
    if wq.dtype != torch.int8 or wscale.dtype != torch.float32 or not wq.is_contiguous() \
            or not wscale.is_contiguous() or wscale.shape[0] != n:
        raise ValueError("W8A8 kernels take a contiguous int8 weight and its fp32 scales")
    if wq.get_device() != index or wscale.get_device() != index or \
            (bias is not None and (bias.get_device() != index or bias.shape[0] != n)):
        raise ValueError("W8A8 kernels take x, the weight, its scales and the bias on one card")
    dynamic = not static_amax > 0
    work_bytes = work_bytes[dynamic]
    if work is not None and (work.dtype != torch.uint8 or work.get_device() != index
                             or not work.is_contiguous() or work.numel() < work_bytes
                             or work.data_ptr() % 16):
        raise ValueError(f"the W8A8 work buffer takes {work_bytes} contiguous bytes on x's card, "
                         f"16-byte aligned")
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    if bias is not None and (bias.dtype != x.dtype or not bias.is_contiguous()):
        bias = bias.to(x.dtype).contiguous()
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return w8a8_matmul_cuda(x, wq, wscale, static_amax, bias, work)
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if m:
        lib, fn = _launcher()
        stream = torch._C._cuda_getCurrentRawStream(index)
        # a block of the caching allocator and no tensor (nor an op for the profiler to
        # record), freed stream-ordered as a tensor is: the next user of the block on this
        # stream runs after these launches
        ptr = torch._C._cuda_cudaCachingAllocator_raw_alloc(work_bytes, stream) \
            if work is None else work.data_ptr()
        try:
            err = fn(plan, x.data_ptr(), wq.data_ptr(), wscale.data_ptr(),
                     None if bias is None else bias.data_ptr(), ptr, y.data_ptr(),
                     0.0 if dynamic else static_amax / 127.0, stream)
        finally:
            if work is None:
                torch._C._cuda_cudaCachingAllocator_raw_delete(ptr)
        check_launch(lib, err, "w8a8_matmul")
        w8a8_matmul_cuda.launches += 1
    return y


counts_launches(w8a8_matmul_cuda, "w8a8_int8_gemm_kernel")


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
        return w8a8_matmul(x, self.weight_q, self.weight_scale, self.static_amax, bias=self.bias)


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
