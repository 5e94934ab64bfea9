"""GroupNorm with an optional SiLU: a hand-written Hopper kernel and its plain
PyTorch version.

Every GroupNorm of the SDXL and I2VGen-XL UNets goes through ``group_norm``
(``models/unet2d.py::norm_act``); the modules stay ``nn.GroupNorm``, so their
parameter names are unchanged. The kernel (``csrc/group_norm.cu``) replaces
no TPU kernel: the JAX package leaves GroupNorm to XLA. It takes the place of
PyTorch's statistics, fused-parameter and apply launches and the separate
SiLU pass: one launch that reads x once where a block's share of a row fits
its shared memory and writes y once, normalised, scaled, shifted and, where
asked, through SiLU, in fp32 with one rounding. ``launch_plan`` is its launch
plan, computed here from the shape alone so that the CPU can check it.

``group_norm`` launches the kernel for CUDA tensors (bf16, fp16 or fp32) and
raises when it cannot; the plain version (``F.group_norm`` then ``F.silu`` in
x's dtype, what the models ran before) is taken for CPU tensors and for
``meta`` ones, which compute no values. ``group_norm.launches`` counts the
launches, ``group_norm.paths`` the launches outside a graph capture that
read x once (``one_read``) or twice (``reread``). Where an input requires a
gradient the call goes through ``GroupNormFunction``, whose backward is the
plain version's vjp.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from tweediemix_tpu_torch.ops.cuda_build import check_launch, counts_launches, load_library

MAX_CLUSTER = 16  # blocks a row (csrc kMaxCluster); past PORTABLE_CLUSTER a non-portable size
PORTABLE_CLUSTER = 8
THREADS = (128, 256)  # a block's threads, each given at least VECTORS_PER_THREAD vectors
VECTORS_PER_THREAD = 8
MAX_PIECES = 16  # bulk copies (and mbarriers) of a chunk (csrc kMaxPieces)
PIECE_BYTES = 16384  # bytes of a bulk copy, so that the statistics start on the first
SMEM_LIMIT = 231424  # dynamic shared memory of a block (csrc kMaxDynamicSmem)
SMEM_PER_SM = 233472  # sm_90's shared memory per SM; each resident block also reserves 1 KB
STATIC_SMEM = 1024  # a block's static arrays, rounded up
BLOCKS_PER_SM = (4, 2, 1)  # the shares of an SM a chunk may take, most blocks first
FILL_BLOCKS_PER_SM = 4  # a grid shorter than this many blocks an SM takes more blocks a row
MIN_CHUNK_BYTES = 8192  # ... while each block keeps at least this much of its row
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
PARAM_KINDS = {torch.bfloat16: 1, torch.float16: 2, torch.float32: 3}


@dataclasses.dataclass(frozen=True)
class GroupNormPlan:
    """How the kernel covers ``rows`` rows of ``row_len`` elements: a cluster
    of ``cluster`` blocks a row, ``chunk`` elements (a multiple of ``vec``)
    a block of ``threads`` threads; ``one_read``: each chunk is staged in
    shared memory by ``pieces`` bulk copies and x is read once, else twice.
    ``smem_bytes`` of dynamic shared memory a block."""

    rows: int
    row_len: int
    vec: int
    cluster: int
    chunk: int
    threads: int
    one_read: bool
    pieces: int
    smem_bytes: int

    @property
    def grid(self) -> int:
        return self.rows * self.cluster


def smem_bytes(chunk: int, itemsize: int, cpg: int, one_read: bool) -> int:
    """Dynamic shared memory of a block, as the kernel lays it out: the
    chunk (one-read path, rounded up to 16 bytes), MAX_PIECES mbarriers, a
    scale and a shift a channel of the group."""
    buf = -(-chunk * itemsize // 16) * 16 if one_read else 0
    return buf + 8 * MAX_PIECES + 8 * cpg


@functools.lru_cache(maxsize=1024)
def launch_plan(rows: int, row_len: int, spatial: int, cpg: int, itemsize: int,
                aligned: bool, sms: int) -> GroupNormPlan:
    """The kernel's plan for ``rows`` (sample, group) rows of ``cpg``
    channels x ``spatial`` elements of ``itemsize`` bytes on a card of
    ``sms`` SMs; ``aligned``: x starts on 16 bytes.

    16-byte vectors where every channel's run of S elements is whole
    vectors and x is aligned, else single elements. The fewest blocks a row
    (1, 2, 4, 8, 16) whose chunk fits shared memory with four blocks to an
    SM (so that one block's loads overlap another's stores), else two, else
    one; where no chunk fits (or the vectors are single elements) one block
    a row and the two-read path. Then twice the blocks a row, up to
    PORTABLE_CLUSTER, while the grid is short of FILL_BLOCKS_PER_SM blocks
    an SM and a chunk keeps MIN_CHUNK_BYTES, so that 64 rows fill the card
    as 1024 do. The threads: the most of THREADS that leave each
    VECTORS_PER_THREAD."""
    if min(rows, row_len, spatial, cpg, itemsize, sms) < 1 or cpg * spatial != row_len:
        raise ValueError(f"no group-norm plan for rows={rows} row_len={row_len} "
                         f"spatial={spatial} cpg={cpg}")
    full = 16 // itemsize
    vec = full if aligned and spatial % full == 0 else 1

    def chunk_for(k):  # ceil(row_len / k), rounded up to whole vectors
        per_block = -(-row_len // k)
        return -(-per_block // vec) * vec

    def smem(k, one_read):
        return smem_bytes(chunk_for(k), itemsize, cpg, one_read)

    ks = [1 << i for i in range(MAX_CLUSTER.bit_length())]
    fits = [[k for k in ks if vec > 1
             and smem(k, True) <= min(SMEM_LIMIT, SMEM_PER_SM // b - 1024 - STATIC_SMEM)]
            for b in BLOCKS_PER_SM]
    one_read = bool(fits[-1])
    k = next((f[0] for f in fits if f), 1)
    while (k < PORTABLE_CLUSTER and rows * k < FILL_BLOCKS_PER_SM * sms
           and chunk_for(2 * k) * itemsize >= MIN_CHUNK_BYTES):
        k *= 2
    chunk = chunk_for(k)
    threads = next((t for t in reversed(THREADS) if chunk // vec >= VECTORS_PER_THREAD * t),
                   THREADS[0])
    pieces = min(MAX_PIECES, max(1, -(-chunk * itemsize // PIECE_BYTES))) if one_read else 1
    return GroupNormPlan(rows=rows, row_len=row_len, vec=vec, cluster=k, chunk=chunk,
                         threads=threads, one_read=one_read, pieces=pieces,
                         smem_bytes=smem_bytes(chunk, itemsize, cpg, one_read))


def group_norm_reference(x, num_groups: int, weight=None, bias=None, eps: float = 1e-5,
                         silu: bool = False) -> torch.Tensor:
    """Plain version: ``F.group_norm`` then, where ``silu``, ``F.silu``, both
    in x's dtype (what ``nn.GroupNorm`` and ``nn.SiLU`` compute)."""
    y = F.group_norm(x, num_groups, weight, bias, eps)
    return F.silu(y) if silu else y


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bind(lib):
    """The typed C entry point of a built group-norm library."""
    fn = lib.tm_group_norm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    return fn


@functools.cache
def _launcher():
    """The built library and its typed C entry point (built on first call)."""
    lib = load_library("group_norm")
    return lib, bind(lib)


def _param(t, c: int, x: torch.Tensor, what: str):
    """(pointer, kind) of a [C] weight or bias, (None, 0) for none."""
    if t is None:
        return None, 0
    if t.dtype not in PARAM_KINDS or t.device != x.device or t.numel() != c or not t.is_contiguous():
        raise ValueError(f"group_norm kernel takes a contiguous {what} of {c} elements on "
                         f"{x.device} in bf16, fp16 or fp32; got {tuple(t.shape)} {t.dtype} "
                         f"on {t.device}")
    return t.data_ptr(), PARAM_KINDS[t.dtype]


def _launch_cuda(x, num_groups: int, weight, bias, eps: float, silu: bool) -> torch.Tensor:
    """One launch at ``launch_plan``'s plan, into a new tensor."""
    if x.dtype not in DTYPES:
        raise TypeError(f"group_norm kernel takes bf16, fp16 or fp32 x, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"group_norm kernel takes a non-empty [N, C, *] x, got {tuple(x.shape)}")
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    x = x.contiguous()
    spatial = x.numel() // (n * c)
    cpg = c // num_groups
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    plan = launch_plan(n * num_groups, cpg * spatial, spatial, cpg, x.element_size(),
                       x.data_ptr() % 16 == 0, _sm_count(dev))
    w_ptr, w_kind = _param(weight, c, x, "weight")
    b_ptr, b_kind = _param(bias, c, x, "bias")
    y = torch.empty_like(x)
    lib, fn = _launcher()
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), y.data_ptr(), w_ptr, b_ptr, w_kind, b_kind, DTYPES[x.dtype],
                 plan.rows, plan.row_len, spatial, cpg, num_groups, eps, int(silu), plan.cluster,
                 plan.threads, plan.chunk, plan.vec, int(plan.one_read), plan.pieces,
                 torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, err, "group_norm")
    group_norm.launches += 1
    if not torch.cuda.is_current_stream_capturing():
        group_norm.paths["one_read" if plan.one_read else "reread"] += 1
    return y


def _forward(x, num_groups, weight, bias, eps, silu) -> torch.Tensor:
    if x.device.type in ("cpu", "meta"):
        return group_norm_reference(x, num_groups, weight, bias, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on cuda or cpu tensors, got {x.device}")
    return _launch_cuda(x, num_groups, weight, bias, float(eps), silu)


class GroupNormFunction(torch.autograd.Function):
    """``group_norm`` with a gradient: the forward is the same call (the
    kernel on a card), the backward recomputes the plain version and takes
    its vjp. No backward kernel is written: the JAX package's GroupNorm
    backward is plain XLA too."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups: int, eps: float, silu: bool):
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (num_groups, eps, silu)
        return _forward(x, num_groups, weight, bias, eps, silu)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad)]
            out = group_norm_reference(leaves[0], ctx.args[0], leaves[1], leaves[2],
                                       *ctx.args[1:])
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t is not None and t.requires_grad else None
                     for t in leaves) + (None, None, None)


def group_norm(x, num_groups: int, weight=None, bias=None, eps: float = 1e-5,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm of an [N, C, *] tensor over ``num_groups`` groups (biased
    variance, rstd = rsqrt(var + eps)), the per-channel ``weight`` and
    ``bias``, then SiLU where ``silu``. On a CUDA tensor one launch of the
    Hopper kernel (or it raises); on the CPU the plain version. Returns x's
    shape and dtype, contiguous on a card."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias)):
        return GroupNormFunction.apply(x, weight, bias, num_groups, eps, silu)
    return _forward(x, num_groups, weight, bias, eps, silu)


counts_launches(group_norm, "group_norm_kernel")
group_norm.paths = {"one_read": 0, "reread": 0}
