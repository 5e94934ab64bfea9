"""GroupNorm with an optional SiLU (``ops/group_norm.py``) on the CPU, without
JAX: the wrapper is the plain composition bit for bit, the rewired UNet
blocks compute what they computed with ``nn.GroupNorm`` and ``F.silu`` and
keep their parameter names, the gradient path's gradients are the plain
version's, the launch plan covers every row within shared memory and fills
the card at the main paths' shapes, and a UNet call makes 46 (SDXL) or 166
(I2VGen-XL) calls of the op. The kernel itself is tested on the card in
``tests/test_torch_port_kernels.py``.
"""

import functools
import math
import os
import sys

import pytest
import torch
import torch.nn.functional as F

from tweediemix_tpu_torch.models import unet2d as port_unet2d
from tweediemix_tpu_torch.models import unet3d as port_unet3d
from tweediemix_tpu_torch.ops import group_norm as gn_module
from tweediemix_tpu_torch.ops.group_norm import GroupNormFunction, group_norm, launch_plan

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

H100_SMS = 132


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((2, 12, 5, 7), 3), ((2, 8, 3, 4, 5), 4), ((3, 6, 9), 6)])
def test_group_norm_on_the_cpu_is_the_plain_composition_bit_for_bit(shape, groups, dtype, silu):
    g = _gen(1)
    x = (3.0 + 2.0 * torch.randn(shape, generator=g)).to(dtype)
    w = (1.0 + 0.3 * torch.randn(shape[1], generator=g)).to(dtype)
    b = (0.3 * torch.randn(shape[1], generator=g)).to(dtype)
    want = F.group_norm(x, groups, w, b, 1e-5)
    if silu:
        want = F.silu(want)
    got = group_norm(x, groups, w, b, 1e-5, silu=silu)
    assert got.dtype == dtype and torch.equal(got, want)
    norm = torch.nn.GroupNorm(groups, shape[1], eps=1e-6).to(dtype)
    assert torch.equal(port_unet2d.norm_act(norm, x, silu=False), norm(x))


def _old_norm_act(norm, x, silu=True):
    """What the blocks ran before: the module, then ``F.silu``."""
    y = norm(x)
    return F.silu(y) if silu else y


def _old_temporal_conv(m, x, num_frames):
    y = port_unet3d._frames_channels_first(x, num_frames)
    for stage in (m.conv1, m.conv2, m.conv3, m.conv4):
        y = stage(y)  # GroupNorm, SiLU, (dropout), conv: the diffusers Sequential
    return x + y.transpose(1, 2).reshape(x.shape)


def _block(name, dtype):
    g = _gen(2)
    b, f, c, h, w = 2, 3, 16, 4, 6
    if name == "ResnetBlock2D":
        m = port_unet2d.ResnetBlock2D(16, 24, 8, 4)
        args = (torch.randn(b, c, h, w, generator=g), torch.randn(b, 8, generator=g))
        keys = {"norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias"}
    elif name == "Transformer2DModel":
        m = port_unet2d.Transformer2DModel(16, 2, 8, 1, 12, 4)
        args = (torch.randn(b, c, h, w, generator=g), torch.randn(b, 5, 12, generator=g), None)
        keys = {"norm.weight", "norm.bias"}
    elif name == "TemporalConvLayer":
        m = port_unet3d.TemporalConvLayer(16, 4)
        args = (torch.randn(b * f, c, h, w, generator=g), f)
        keys = {f"conv{i}.0.{p}" for i in range(1, 5) for p in ("weight", "bias")}
    else:
        m = port_unet3d.TransformerTemporalModel(16, 2, 8, 1, 4)
        args = (torch.randn(b * f, c, h, w, generator=g), f)
        keys = {"norm.weight", "norm.bias"}
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g) + (1.0 if p.dim() == 1 else 0.0))
    m = m.to(dtype)
    args = tuple(a.to(dtype) if isinstance(a, torch.Tensor) else a for a in args)
    return m, args, keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["ResnetBlock2D", "Transformer2DModel", "TemporalConvLayer",
                                  "TransformerTemporalModel"])
def test_rewired_blocks_compute_what_they_did_and_keep_their_names(monkeypatch, name, dtype):
    m, args, keys = _block(name, dtype)
    norms = {n for n, mod in m.named_modules() if isinstance(mod, torch.nn.GroupNorm)}
    assert keys == {f"{n}.{p}" for n in norms for p in ("weight", "bias")}
    assert keys <= set(m.state_dict())
    with torch.no_grad():
        got = m(*args)
        if name == "TemporalConvLayer":
            want = _old_temporal_conv(m, *args)
        else:
            monkeypatch.setattr(port_unet2d, "norm_act", _old_norm_act)
            monkeypatch.setattr(port_unet3d, "norm_act", _old_norm_act)
            want = m(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups", [((2, 12, 5, 7), 3), ((2, 8, 3, 4, 5), 4)])
def test_the_gradient_path_gives_the_plain_gradients(shape, groups, silu, affine):
    g = _gen(3)
    x0 = 2.0 + torch.randn(shape, generator=g)
    w0 = 1.0 + 0.3 * torch.randn(shape[1], generator=g) if affine else None
    b0 = 0.3 * torch.randn(shape[1], generator=g) if affine else None
    up = torch.randn(shape, generator=g)

    def grads(fn):
        leaves = [None if t is None else t.clone().requires_grad_() for t in (x0, w0, b0)]
        out = fn(*leaves)
        (out * up).sum().backward()
        return out, [None if t is None else t.grad for t in leaves]

    out, got = grads(lambda x, w, b: group_norm(x, groups, w, b, 1e-5, silu=silu))
    assert out.grad_fn.name() == "GroupNormFunctionBackward"
    want_out, want = grads(lambda x, w, b: gn_module.group_norm_reference(x, groups, w, b, 1e-5,
                                                                          silu))
    assert torch.equal(out, want_out)
    for a, e in zip(got, want):
        assert (a is None and e is None) or torch.equal(a, e)
    # only x needs a gradient: gamma and beta get none
    x = x0.clone().requires_grad_()
    y = GroupNormFunction.apply(x, w0, b0, groups, 1e-5, silu)
    (y * up).sum().backward()
    assert torch.equal(x.grad, want[0])


# (rows, cpg, spatial) at the main paths' GroupNorm shapes: the video
# UNet's temporal rows (B = 2 samples x 32 groups, F = 16 frames) and its
# spatial ones (32 folded frames x 32 groups), SDXL's at 2 and 4 rows
MAIN_ROWS = [(64, 10, 16 * 4096), (64, 20, 16 * 1024), (64, 40, 16 * 256), (64, 40, 16 * 64),
             (1024, 10, 4096), (1024, 30, 4096), (1024, 20, 1024), (1024, 80, 64),
             (64, 10, 16384), (128, 30, 16384), (128, 20, 4096), (64, 80, 1024)]
EDGE_ROWS = [(4, 32, 16 * 4096), (4, 32, 8 * 4096), (2, 3, 7), (96, 1, 1), (8, 1000, 999)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows,cpg,spatial", MAIN_ROWS + EDGE_ROWS)
def test_launch_plan_covers_each_row_within_shared_memory(rows, cpg, spatial, itemsize, aligned):
    row_len = cpg * spatial
    plan = launch_plan(rows, row_len, spatial, cpg, itemsize, aligned, H100_SMS)
    assert plan.cluster in (1, 2, 4, 8, 16) and plan.threads in gn_module.THREADS
    assert plan.chunk % plan.vec == 0 and spatial % plan.vec == 0
    assert plan.chunk * plan.cluster >= row_len > plan.chunk * (plan.cluster - 1)
    assert plan.vec == (16 // itemsize if aligned and spatial % (16 // itemsize) == 0 else 1)
    assert plan.smem_bytes == gn_module.smem_bytes(plan.chunk, itemsize, cpg, plan.one_read)
    assert plan.smem_bytes <= gn_module.SMEM_LIMIT
    # one read wherever sixteen blocks' chunks of whole vectors fit their shared memory
    share = -(-(-(-row_len // 16)) // plan.vec) * plan.vec
    assert plan.one_read == (plan.vec > 1 and gn_module.smem_bytes(share, itemsize, cpg, True)
                             <= gn_module.SMEM_LIMIT)
    assert 1 <= plan.pieces <= gn_module.MAX_PIECES
    if plan.one_read:  # each bulk copy within the mbarrier's byte count
        assert -(-plan.chunk * itemsize // plan.pieces) < 2**20
    if (rows, cpg, spatial) in MAIN_ROWS and itemsize == 2 and aligned:
        # bf16 at the main paths: one read of x, at least two blocks to an SM, and a grid
        # of FILL_BLOCKS_PER_SM blocks an SM wherever a chunk can stay above MIN_CHUNK_BYTES
        assert plan.one_read and plan.vec == 8
        assert 2 * (plan.smem_bytes + 1024 + gn_module.STATIC_SMEM) <= gn_module.SMEM_PER_SM
        assert (plan.grid >= gn_module.FILL_BLOCKS_PER_SM * H100_SMS
                or plan.cluster >= gn_module.PORTABLE_CLUSTER
                or plan.chunk * itemsize < 2 * gn_module.MIN_CHUNK_BYTES)


def test_launch_plan_at_the_long_rows():
    # the video's temporal rows of 1.3 MB: sixteen blocks a row of 80 KB each, two to an
    # SM, x read once
    plan = launch_plan(64, 655360, 65536, 10, 2, True, H100_SMS)
    assert (plan.cluster, plan.chunk, plan.one_read, plan.threads, plan.grid) == (16, 40960, True,
                                                                                  256, 1024)
    # 1024 spatial rows of 80 KB: two blocks a row of 40 KB, four to an SM
    plan = launch_plan(1024, 40960, 4096, 10, 2, True, H100_SMS)
    assert (plan.cluster, plan.chunk, plan.one_read) == (2, 20480, True)
    assert 4 * (plan.smem_bytes + 1024 + gn_module.STATIC_SMEM) <= gn_module.SMEM_PER_SM
    # a row of 4 MB does not fit sixteen blocks' shared memory: two reads
    plan = launch_plan(4, 1 << 21, 65536, 32, 2, True, H100_SMS)
    assert (plan.cluster, plan.one_read) == (8, False)
    with pytest.raises(ValueError):
        launch_plan(4, 100, 7, 10, 2, True, H100_SMS)


def test_the_wrapper_refuses_devices_it_has_no_path_for():
    x = torch.randn(2, 4, 3, 3)
    assert group_norm(x.to("meta"), 2).device.type == "meta"
    launches = group_norm.launches
    group_norm(x, 2, silu=True)
    assert group_norm.launches == launches  # the CPU never counts a launch
    assert gn_module.group_norm.kernel == "group_norm_kernel"


@functools.cache
def _sites():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke.group_norm_sites()


# (call, GroupNorms, of them followed by SiLU, of them over [B, C, F, h, w])
@pytest.mark.parametrize("call,sites,silu,temporal", [("sdxl_2_rows", 46, 35, 0),
                                                      ("sdxl_4_rows", 46, 35, 0),
                                                      ("video", 166, 133, 105)])
def test_a_unet_call_makes_its_group_norms_each_reading_x_once(call, sites, silu, temporal):
    """The GroupNorm calls of one UNet call (a forward on ``meta``, the op
    and the attention cores stubbed; the video cache's pass makes none),
    and at each of their shapes a plan that reads x once."""
    calls = _sites()[call]
    assert sum(calls.values()) == sites
    assert sum(m for (_, _, s), m in calls.items() if s) == silu
    assert sum(m for (shape, _, _), m in calls.items() if len(shape) == 5) == temporal
    for shape, groups, _ in calls:
        n, c = shape[:2]
        spatial = math.prod(shape[2:])
        plan = launch_plan(n * groups, c // groups * spatial, spatial, c // groups, 2, True,
                           H100_SMS)
        assert plan.one_read
