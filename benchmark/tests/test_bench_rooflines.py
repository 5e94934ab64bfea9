"""The yardstick's counts on known shapes: the launches each request makes
at the configurations' published sizes, the bounds of each kernel shape,
and the work counter."""

import pytest
import torch

from benchmark import rooflines
from benchmark.harness import load_cell
from benchmark.reference import ops as ref_ops


def test_fusion_sites_give_5250_flash_launches_per_image():
    wl, cfg = load_cell("sdxl-fusion-n3.bf16-1seed")
    b4 = rooflines.fusion_flash_shapes(cfg["unet"], (128, 128), 4)
    b2 = rooflines.fusion_flash_shapes(cfg["unet"], (128, 128), 2)
    assert b4 == {(40, 4096, 4096, 64): 10, (80, 1024, 1024, 64): 60}
    assert b2 == {(20, 4096, 4096, 64): 10, (40, 1024, 1024, 64): 60}
    # 51 calls of 4 rows and 24 of 2 per image
    assert 51 * rooflines.launches(b4) + 24 * rooflines.launches(b2) == 5250


def test_video_sites_give_1700_short_and_500_flash_launches_per_clip():
    wl, cfg = load_cell("i2vgen-xl.bf16-clip")
    flash, short = rooflines.video_kernel_shapes(cfg["unet"], (64, 64), 2, 16)
    assert flash == {(160, 4096, 4096, 64): 5, (320, 1024, 1024, 64): 5}
    assert short == {(8192, 16, 8, 64): 2, (8192, 16, 5, 64): 10, (2048, 16, 10, 64): 10,
                     (512, 16, 20, 64): 10, (128, 16, 20, 64): 2}
    assert 50 * rooflines.launches(flash) == 500 and 50 * rooflines.launches(short) == 1700


@pytest.mark.parametrize("fn,shape,ms", [
    (rooflines.flash_bound_s, (40, 4096, 4096, 64), 0.1737),  # operations
    (rooflines.flash_bound_s, (80, 1024, 1024, 64), 0.0217),
    (rooflines.flash_bound_s, (640, 256, 256, 64), 0.0250),  # bytes
    (rooflines.flash_int8_bound_s, (160, 4096, 4096, 64), 0.3472),
    (rooflines.short_bound_s, (8192, 16, 8, 64), 0.1603),
    (rooflines.short_bound_s, (128, 16, 20, 64), 0.0063),
])
def test_bounds_of_known_shapes(fn, shape, ms):
    assert fn(*shape) * 1e3 == pytest.approx(ms, abs=6e-5)


def test_work_counter_counts_products_by_kind():
    lin = ref_ops.Linear(64, 32)
    lin.weight.data.normal_()
    lin.bias.data.zero_()
    with ref_ops.counting() as cnt:
        lin(torch.ones(3, 5, 64))
        ref_ops.softmax_attention(*(torch.ones(2, 7, 16) for _ in range(3)), 0.25)
    assert cnt.ops == {"gemm": 2 * 15 * 64 * 32, "attention": 4 * 2 * 7 * 7 * 16}
    lin.site = "s"
    ref_ops.set_precision(lin, ref_ops.Precision(amax={"s": 1.0}))
    with ref_ops.counting() as cnt:
        lin(torch.ones(3, 64))
    assert cnt.ops == {"gemm_int8": 2 * 3 * 64 * 32}
    assert rooflines.least_seconds({"gemm_int8": 1979e12, "gemm": 989e12, "vae_conv": 67e12},
                                   unet_int8=True) == pytest.approx(3.0)


def test_request_work_on_meta_at_full_size():
    from benchmark.systems.fusion import System

    wl, cfg = load_cell("sdxl-fusion-n3.bf16-1seed")
    system = System.__new__(System)
    system.cfg, system.wl, system.S, system.n, system.hw = cfg, wl, 1, 3, (128, 128)
    from benchmark.reference.sampling import FusionReference
    system.plain = FusionReference(cfg["sampling"])
    work = system.work()
    unet = sum(v for k, v in work.items() if not k.startswith("vae_"))
    # about 6 to 8 TFLOP per row of a UNet call, 228 rows per image
    assert 228 * 5e12 < unet < 228 * 9e12
    assert 5e12 < sum(v for k, v in work.items() if k.startswith("vae_")) < 2e13
