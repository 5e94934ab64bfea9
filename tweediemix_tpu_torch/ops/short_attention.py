"""Frame-axis (short-sequence) self-attention: a hand-written Hopper kernel
and its plain PyTorch version.

The video UNet's temporal transformers attend over the S = 16 frames of
every pixel row: [N, S, H·dh] projections with N = batch·h·w pixel rows. The
kernel (``csrc/short_attention.cu``) replaces the Pallas TPU kernel
``tweediemix_tpu/ops/short_attention.py::_short_kernel``: per-head softmax
attention within each row's S-band, fp32 scores, row max in the log2
domain, denominator floored at 1e-30, output in the merged [N, S, H·dh]
layout. It reads q, k and v through their row strides (the self-attention's
q/k/v are ``chunk(3)`` views of the merged ``to_qkv`` output) and is bounded
by bytes; the source's header says how. The TPU devices (128/S bands packed
into a 128-row MXU tile with a block-diagonal mask, the head-major
``[H, N·S, dh]`` relayout, the ones-column denominator, a bf16-rounded
pre-scaled q) stay behind.

``short_seq_attention`` launches the kernel for CUDA tensors and raises when
it cannot; it takes the plain version only for tensors on the CPU.
``tile_plan`` is the kernel's launch plan (tile shape, ring stages,
persistent grid), computed here so that the CPU can check it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from tweediemix_tpu_torch.ops.cuda_build import check_launch, counts_launches, load_library

MAX_S = 32
HEAD_DIMS = (32, 64, 128)
CONSUMER_WARPS = 4  # csrc/short_attention.cu kConsumers: the stages are a multiple
MAX_SMEM_PER_BLOCK = 232448  # sm_90's opt-in shared memory per block (kMaxSmem)
SMEM_PER_SM = 233472  # sm_90's shared memory per SM; each resident block also reserves 1 KB
MAX_STAGES = 16
MAX_BOX = 256  # TMA: elements per box dimension
ROWS_PER_TILE = (4, 2, 1)  # the pixel-row counts the plan tries, most first
TILES_PER_WARP = 4  # fewer rows per tile until every consumer warp has this many tiles


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How the kernel covers [N, S, H·dh]: tiles of ``rows`` pixel rows by one
    head (each a TMA box of [panel, 1, sp, rows] per dh panel), a ring of
    ``stages`` stages, ``grid`` persistent blocks that walk the ``tiles``
    tiles, heads fastest (tile t: rows (t // heads)·rows, head t % heads),
    ``smem_bytes`` of shared memory each."""

    sp: int
    dh: int
    heads: int
    rows: int
    stages: int
    blocks_per_sm: int
    grid: int
    tiles: int
    smem_bytes: int

    @property
    def panel(self) -> int:
        """dh elements per box row: 128 bytes (128-byte swizzle), or 64 bytes
        (64-byte swizzle) at dh 32."""
        return min(self.dh, 64)

    @property
    def box(self) -> tuple:
        """The TMA box, innermost first: [panel, 1 head, sp frames, rows]."""
        return (self.panel, 1, self.sp, self.rows)

    @property
    def tile_bytes(self) -> int:
        return self.rows * self.sp * self.dh * 2

    def bands(self, t: int) -> list:
        """The (pixel row, head) bands of tile ``t`` before the tensor's
        edge clips it, as the kernel decodes it."""
        n0 = (t // self.heads) * self.rows
        return [(n0 + r, t % self.heads) for r in range(self.rows)]


def smem_bytes(sp: int, dh: int, rows: int, stages: int) -> int:
    """Shared memory of one block, as the kernel lays it out: ``stages``
    stages of q, k and v tiles, two output tiles per consumer warp, two
    mbarriers per stage, 1024 bytes to align the swizzled tiles."""
    tile = rows * sp * dh * 2
    return (3 * stages + 2 * CONSUMER_WARPS) * tile + 16 * stages + 1024


def _stages_for(sp, dh, rows, blocks_per_sm):
    """The most stages (a multiple of the consumer warps, at most
    MAX_STAGES) whose blocks fit ``blocks_per_sm`` to an SM; 0 if none."""
    budget = min(MAX_SMEM_PER_BLOCK, SMEM_PER_SM // blocks_per_sm - 1024)
    for stages in range(MAX_STAGES, 0, -CONSUMER_WARPS):
        if smem_bytes(sp, dh, rows, stages) <= budget:
            return stages
    return 0


@functools.lru_cache(maxsize=256)
def tile_plan(n: int, s: int, heads: int, dh: int, sms: int) -> TilePlan:
    """The kernel's plan for q/k/v [n, s, heads·dh] on a card of ``sms`` SMs.

    One head per tile: a box of several heads puts a band's frames that many
    128-byte lines apart, and an even count makes ldmatrix's eight rows
    share banks. Two blocks per SM wherever a tile leaves each of them a
    stage per consumer warp, else one: eight consumer warps on an SM beat
    one block's deeper ring. Then the most pixel rows per tile (4, 2, 1)
    that still give every consumer warp of the grid TILES_PER_WARP tiles,
    so that the persistent blocks end together, else the fewest (on an
    H100: two rows at the video shapes, one at the smallest)."""
    if s < 1 or s > MAX_S or dh not in HEAD_DIMS or n < 1 or heads < 1 or sms < 1:
        raise ValueError(f"no short-attention plan for n={n} s={s} heads={heads} dh={dh}")
    sp = 16 if s <= 16 else 32
    for bps in (2, 1):
        fits = [(r, _stages_for(sp, dh, r, bps)) for r in ROWS_PER_TILE]
        fits = [(r, stages) for r, stages in fits if stages >= CONSUMER_WARPS]
        if fits:
            break
    else:
        raise ValueError(f"no short-attention tile fits at s={s} dh={dh}")
    enough = TILES_PER_WARP * CONSUMER_WARPS * bps * sms
    rows, stages = next(((r, st) for r, st in fits if -(-n // r) * heads >= enough), fits[-1])
    tiles = -(-n // rows) * heads
    return TilePlan(sp=sp, dh=dh, heads=heads, rows=rows, stages=stages, blocks_per_sm=bps,
                    grid=min(tiles, bps * sms), tiles=tiles,
                    smem_bytes=smem_bytes(sp, dh, rows, stages))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def short_seq_attention_reference(q, k, v, num_heads: int, scale: float | None = None):
    """Plain version over [N, S, H·dh] q/k/v: the heads split as
    ``ops.attention.split_heads`` splits them, fp32 scores and softmax,
    output in q's dtype."""
    n, s, d = q.shape
    dh = d // num_heads
    if scale is None:
        scale = dh**-0.5
    qh, kh, vh = (t.float().reshape(n, s, num_heads, dh).transpose(1, 2) for t in (q, k, v))
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
    return torch.matmul(p, vh).transpose(1, 2).reshape(n, s, d).to(q.dtype)


def _check(q, k, v, num_heads: int) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected q, k, v of one [N, S, H*dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] < 1 or q.shape[1] < 1 or num_heads < 1 or q.shape[2] % num_heads:
        raise ValueError(f"shape {tuple(q.shape)} does not split into {num_heads} heads")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")


def bind(lib):
    """The typed C entry point of a built short-attention library."""
    fn = lib.tm_short_attention_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 3)
    return fn


@functools.cache
def _launcher():
    """The built library and its typed C entry point (built on first call)."""
    lib = load_library("short_attention")
    return lib, bind(lib)


def _launch_cuda(q, k, v, num_heads: int, scale: float,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's launch at ``tile_plan``'s plan, into a new tensor (or
    into ``out``: contiguous bf16 [N, S, H·dh], 16-byte aligned)."""
    n, s, d = q.shape
    dh = d // num_heads
    if dh not in HEAD_DIMS:
        raise ValueError(f"short-attention kernel takes dh in {HEAD_DIMS}, got {dh}")
    if s > MAX_S:
        raise ValueError(f"short-attention kernel takes S <= {MAX_S}, got {s}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"short-attention kernel takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(f"short-attention kernel needs {name} with a unit last stride, "
                             f"row strides in multiples of 8 and a 16-byte aligned start; "
                             f"got strides {t.stride()}")
    lib, fn = _launcher()
    plan = tile_plan(n, s, num_heads, dh, _sm_count(q.device.index or 0))
    if out is None:
        out = torch.empty((n, s, d), dtype=torch.bfloat16, device=q.device)
    elif (out.shape != q.shape or out.dtype != torch.bfloat16 or out.device != q.device
          or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError("out must be a contiguous, 16-byte aligned bf16 tensor of q's shape")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                 n, s, num_heads, dh, scale * math.log2(math.e), stream,
                 plan.rows, plan.stages, plan.grid)
    check_launch(lib, err, "short_attention")
    short_seq_attention.launches += 1
    return out


def short_seq_attention(q, k, v, num_heads: int, scale: float | None = None) -> torch.Tensor:
    """Multi-head self-attention within each row's S-band of [N, S, H·dh]
    q/k/v (S is the frame axis).

    On a CUDA tensor this launches the Hopper kernel (bf16, S <= 32, dh in
    {32, 64, 128}, unit last stride) or raises; ``short_seq_attention.launches``
    counts those launches. On a CPU tensor it returns the plain version.
    Returns [N, S, H·dh] in q's dtype."""
    _check(q, k, v, num_heads)
    if scale is None:
        scale = (q.shape[-1] // num_heads) ** -0.5
    if q.device.type == "cpu":
        return short_seq_attention_reference(q, k, v, num_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"short_seq_attention runs on cuda or cpu tensors, got {q.device}")
    return _launch_cuda(q, k, v, num_heads, float(scale))


counts_launches(short_seq_attention, "short_attn_kernel")
