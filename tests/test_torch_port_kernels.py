"""The port's hand-written kernels and their build, without JAX.

This file imports torch and the port only, so it also runs on the GPU
machine, which has no JAX:
``python -m pytest --noconftest tests/test_torch_port_kernels.py -m cuda``.
Tests marked ``cuda`` need a CUDA card and nvcc and skip elsewhere.
Tolerance on the card: max |kernel - plain| / max |plain| <= 1e-2, the plain
version in fp32 on the same bf16 inputs (for the int8 kernel: on the same
int8 inputs, with the kernel's block_k), for the flash kernels and the
short-sequence (frame-axis) kernel alike. The limit is relative because randn
inputs give outputs of std ~ sqrt(e/Sk), far below 1; bf16 output rounding
alone reads up to ~4e-3. The GroupNorm kernel is held to the exact (fp64)
computation on the same bf16 inputs: its max abs error at most 1.05 times
that of PyTorch's bf16 ``F.group_norm`` (then ``F.silu``) on those inputs.
"""

import ctypes
import json
import os
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from tweediemix_tpu_torch.ops import cuda_build
from tweediemix_tpu_torch.ops import flash_attention as flash_module
from tweediemix_tpu_torch.ops import short_attention as short_module
from tweediemix_tpu_torch.ops.attention import attention, multi_head_attention
from tweediemix_tpu_torch.ops.flash_attention import (
    INT8_BLOCK_K,
    bind_int8,
    flash_attention,
    flash_attention_int8,
    flash_attention_int8_core,
    flash_attention_int8_core_reference,
    flash_attention_reference,
    pack_v_int8,
    permuted_key,
    quantize_qkv_int8,
    quantize_qkv_int8_fused,
)

from tweediemix_tpu_torch.ops.short_attention import short_seq_attention, short_seq_attention_reference
from tweediemix_tpu_torch.ops import group_norm as gn_module
from tweediemix_tpu_torch.ops.group_norm import group_norm
from tweediemix_tpu_torch.ops import quant as quant_module
from tweediemix_tpu_torch.tools import int8_variants, short_timing

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

INT8_TOL = 1e-2
SHORT_TOL = 1e-2
# (N, S, heads, dh): the video path's five shapes (transformer_in, levels
# 0-2, mid), then the edge cases
SHORT_MAIN_SHAPES = [(8192, 16, 8, 64), (8192, 16, 5, 64), (2048, 16, 10, 64),
                     (512, 16, 20, 64), (128, 16, 20, 64)]
SHORT_EDGE_SHAPES = [(300, 1, 4, 64), (300, 7, 4, 64), (300, 12, 5, 64), (300, 17, 5, 64),
                     (300, 32, 5, 64), (257, 16, 4, 32), (257, 16, 2, 128), (100, 32, 3, 128),
                     (33, 20, 6, 32), (257, 7, 5, 32), (3, 16, 2, 64)]
# shapes whose plan on an H100 has tiles of several pixel rows that N does
# not fill: (N, S, heads, dh) and the rows per tile
SHORT_RAGGED_SHAPES = [((2049, 16, 5, 64), 2), ((4097, 7, 5, 32), 4), ((1699, 17, 5, 32), 2)]
H100_SMS = 132
# (M, K, N) of the SDXL W8A8 sites at 2 and 4 latent rows: six per
# transformer block and proj_in/proj_out, 4096 tokens a row at 640
# channels, 1024 at 1280
W8A8_MAIN_SHAPES = [(rows * tokens, k, n) for rows in (2, 4)
                    for tokens, pairs in ((4096, ((640, 1920), (640, 640), (640, 5120), (2560, 640))),
                                          (1024, ((1280, 3840), (1280, 1280), (1280, 10240),
                                                  (5120, 1280))))
                    for k, n in pairs]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda on the GPU machine")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bh,sq,sk,dh",
    [(4, 1024, 1024, 64), (2, 300, 300, 128), (2, 1024, 77, 256), (1, 65, 4100, 64),
     (3, 1, 1, 128),
     # the kernel's tile edges: partial 128-row query blocks (Sq = 129, 1000),
     # partial last key tiles (Sk = 129, 4100, 77), dh 128 and 256 at ragged
     # lengths, BH = 320
     (2, 129, 129, 64), (1, 1000, 4100, 64), (2, 1000, 77, 64), (2, 129, 4100, 128),
     (2, 1000, 129, 128), (2, 129, 1000, 256), (2, 1000, 77, 256), (320, 129, 129, 64),
     (320, 1024, 77, 64)],
)
def test_flash_kernel_matches_plain_on_card(bh, sq, sk, dh):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(bh + sq + sk + dh)
    q, k, v = (torch.randn((bh, s, dh), generator=gen, device="cuda").to(torch.bfloat16)
               for s in (sq, sk, sk))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    ref = flash_attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-0.125, 0.0, 2.0])
@pytest.mark.parametrize("bh,sq,sk,dh", [(2, 300, 300, 64), (1, 129, 4100, 128)])
def test_flash_kernel_takes_any_scale_on_card(bh, sq, sk, dh, scale):
    """The kernel reduces rows by their max for a scale >= 0 and by their min
    for a negative one (its other instance); both match the plain version."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(bh + sq + sk + dh)
    q, k, v = (torch.randn((bh, s, dh), generator=gen, device="cuda").to(torch.bfloat16)
               for s in (sq, sk, sk))
    out = flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    ref = flash_attention_reference(q.float(), k.float(), v.float(), scale)
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take_on_card():
    _card()
    q = torch.zeros((2, 64, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        flash_attention(q[..., :32].contiguous(), q[..., :32].contiguous(), q[..., :32].contiguous())
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), q, q)


@pytest.mark.cuda
def test_attention_dispatch_launches_kernel_on_card():
    _card()
    q = torch.randn((2, 1024, 64), device="cuda").to(torch.bfloat16)
    k77 = torch.randn((2, 77, 64), device="cuda").to(torch.bfloat16)
    before = flash_attention.launches
    attention(q, q, q)
    assert flash_attention.launches == before + 1
    attention(q, k77, k77)  # cross-attention stays on the math path
    assert flash_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,dh", [(640, 256, 64), (80, 200, 64), (2, 257, 128)])
def test_flash_min_s_routes_short_self_attention_to_the_kernel_on_card(monkeypatch, bh, s, dh):
    """Under TWEEDIEMIX_FLASH_MIN_S the kernel takes S below 1024: the video
    UNet's 256-token level (BH = 32 frames x 20 heads) and S that are not
    a multiple of its 128-row query tile, against its plain version."""
    _card()
    monkeypatch.setenv("TWEEDIEMIX_FLASH_MIN_S", "128")
    gen = torch.Generator(device="cuda").manual_seed(bh + s + dh)
    q, k, v = (torch.randn((bh, s, dh), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    before = flash_attention.launches
    out = attention(q, k, v)
    assert flash_attention.launches == before + 1
    torch.cuda.synchronize()
    ref = flash_attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


def _copy_sources(name, dst):
    """Copy ``csrc/<name>.cu`` and the headers it includes into ``dst``;
    returns the copied source's text."""
    src = cuda_build.CSRC_DIR / f"{name}.cu"
    for header in cuda_build.local_headers(src):
        shutil.copy(header, dst / header.name)
    return src.read_text()


@pytest.mark.cuda
def test_flash_check_catches_a_skipped_key_tile_on_card(tmp_path, monkeypatch):
    """Mutation check: a copy of the bf16 kernel whose consumers drop their
    second key tile (its probabilities zeroed, its scores left out of the
    running max and sum) must fail the comparison with the plain version."""
    _card()
    softmax = ("online_softmax<BN, kNegScale, kSplitExp>(s, m_run, l_run, corr, scale_log2, n * BN,\n"
               "                                               sk, n == n_tiles - 1);")
    src = _copy_sources("flash_attention", tmp_path)
    assert src.count(softmax) == 1
    skip = ("if (n == 1) { corr[0] = corr[1] = 1.f; for (int i = 0; i < BN / 2; ++i) s[i] = 0.f; }"
            " else " + softmax)
    (tmp_path / "flash_attention.cu").write_text(src.replace(softmax, skip))
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    lib = ctypes.CDLL(str(cuda_build.build_library("flash_attention")))
    fn = lib.tm_flash_attention_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    monkeypatch.setattr(flash_module, "_launcher", lambda: (lib, fn))
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn((40, 1024, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    rel = _rel(out, flash_attention_reference(q.float(), k.float(), v.float()))
    print(f"bf16 kernel with its second key tile skipped: max err / max |plain| = {rel:.3e}")
    assert rel > 1e-2


def _int8_case(bh, sq, sk, dh, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((bh, s, dh), generator=gen, device="cuda").to(torch.bfloat16)
               for s in (sq, sk, sk))
    q8, k8, v8, scales = quantize_qkv_int8(q, k, v)
    plain = flash_attention_int8_core_reference(q8, k8, v8, scales, INT8_BLOCK_K[dh])
    return (q, k, v), (q8, k8, pack_v_int8(v8, INT8_BLOCK_K[dh]), scales), plain


def _rel(out, plain):
    return (out.float() - plain).abs().max().item() / plain.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bh,sq,sk,dh",
    [(4, 1024, 1024, 64), (2, 300, 300, 128), (2, 1024, 77, 256), (1, 65, 4100, 64),
     (3, 1, 1, 128), (2, 200, 333, 256)],
)
def test_int8_kernel_matches_plain_on_card(bh, sq, sk, dh):
    _card()
    (q, k, v), qkv8, plain = _int8_case(bh, sq, sk, dh, bh + sq + sk + dh)
    before = flash_attention_int8.launches, quantize_qkv_int8_fused.launches
    out = flash_attention_int8(q, k, v)
    assert (flash_attention_int8.launches, quantize_qkv_int8_fused.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert _rel(out, plain) <= INT8_TOL
    # the core on the plain quantise's inputs gives the wrapper's output
    assert torch.equal(flash_attention_int8_core(*qkv8), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
def test_int8_kernel_matches_plain_on_loud_inputs_on_card(dh):
    """q and k of randn x 8: a score scale above 0.01, where a rounded
    exponent addend would lift a row max's p8 to 128, -128 as an s8 operand."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, k = (torch.randn((4, 1024, dh), generator=gen, device="cuda").mul(8).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn((4, 1024, dh), generator=gen, device="cuda").to(torch.bfloat16)
    q8, k8, v8, scales = quantize_qkv_int8(q, k, v)
    assert scales[0].item() > 1e-2
    plain = flash_attention_int8_core_reference(q8, k8, v8, scales, INT8_BLOCK_K[dh])
    assert _rel(flash_attention_int8(q, k, v), plain) <= INT8_TOL


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bh,sq,sk,dh",
    [(4, 1024, 1024, 64), (2, 300, 300, 128), (2, 1024, 77, 256), (1, 65, 4100, 64),
     (3, 1, 1, 128), (2, 1, 333, 64), (2, 200, 333, 256), (5, 129, 45, 64)],
)
def test_int8_fused_quantise_is_bitwise_on_card(bh, sq, sk, dh):
    """The two hand-written quantise passes give exactly quantize_qkv_int8's
    q8, k8 and scales and pack_v_int8's V^T, ragged Sk and Sq = 1 included."""
    _card()
    (q, k, v), (q8, k8, vt8, scales), _ = _int8_case(bh, sq, sk, dh, 3 * bh + sq + sk + dh)
    got = quantize_qkv_int8_fused(q, k, v)
    torch.cuda.synchronize()
    for name, want, have in zip(("q8", "k8", "vt8", "scales"), (q8, k8, vt8, scales), got):
        assert have.shape == want.shape and have.dtype == want.dtype, name
        assert torch.equal(have, want), name


@pytest.mark.cuda
def test_int8_kernel_rejects_what_it_does_not_take_on_card():
    _card()
    q = torch.zeros((2, 64, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        flash_attention_int8(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        flash_attention_int8(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError):
        q32 = q[..., :32].contiguous()
        flash_attention_int8(q32, q32, q32)
    q8 = torch.zeros((2, 64, 64), device="cuda", dtype=torch.int8)
    vt8 = torch.zeros((2, 64, INT8_BLOCK_K[64]), device="cuda", dtype=torch.int8)
    scales = torch.ones(2, device="cuda")
    with pytest.raises(ValueError, match="scales"):
        flash_attention_int8_core(q8, q8, vt8, torch.ones(3, device="cuda"))
    with pytest.raises(ValueError, match="scales"):
        flash_attention_int8_core(q8, q8, vt8, scales.double())
    with pytest.raises(ValueError, match="vt8"):
        flash_attention_int8_core(q8, q8, q8, scales)  # natural v8, not V^T


@pytest.mark.cuda
def test_int8_knob_dispatches_to_the_int8_kernel_on_card(monkeypatch):
    _card()
    q = torch.randn((2, 1024, 64), device="cuda").to(torch.bfloat16)
    monkeypatch.setenv("TWEEDIEMIX_FLASH_INT8", "1")
    bf16, int8 = flash_attention.launches, flash_attention_int8.launches
    attention(q, q, q)
    assert (flash_attention.launches, flash_attention_int8.launches) == (bf16, int8 + 1)
    monkeypatch.setenv("TWEEDIEMIX_FLASH_INT8", "0")
    attention(q, q, q)
    assert (flash_attention.launches, flash_attention_int8.launches) == (bf16 + 1, int8 + 1)


@pytest.mark.cuda
def test_int8_check_catches_a_skipped_key_tile_on_card(tmp_path, monkeypatch):
    """Mutation check: a copy of the int8 kernel whose consumers drop their
    second key tile (its p8 zeroed, its scores left out of the running max
    and the denominator) must fail the comparison with the plain version."""
    _card()
    softmax = "softmax_int8<C, false>(s, m_run, den, corr, sc, n * BN, sk);"
    src = _copy_sources("flash_attention_int8", tmp_path)
    assert src.count(softmax) == 1
    skip = ("if (n == 1) { corr[0] = corr[1] = 1.f; for (int i = 0; i < BN / 2; ++i) s[i] = kMagic; }"
            " else " + softmax)
    (tmp_path / "flash_attention_int8.cu").write_text(src.replace(softmax, skip))
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    lib = ctypes.CDLL(str(cuda_build.build_library("flash_attention_int8")))
    monkeypatch.setattr(flash_module, "_launcher_int8", lambda: (lib, bind_int8(lib)))
    _, qkv8, plain = _int8_case(40, 1024, 1024, 64, 7)
    rel = _rel(flash_attention_int8_core(*qkv8), plain)
    print(f"int8 kernel with its second key tile skipped: max err / max |plain| = {rel:.3e}")
    assert rel > INT8_TOL


@pytest.mark.parametrize("bh,sk,dh,block", [(2, 45, 64, 128), (1, 77, 128, 64), (3, 33, 256, 32),
                                            (1, 1, 64, 128), (2, 256, 64, 128), (1, 70, 32, 32)])
def test_pack_v_int8_round_trips_and_follows_permuted_key(bh, sk, dh, block):
    """V^T as the int8 kernel reads it: keys padded with zeros to a multiple
    of the block, transposed, and within each 32-key step position 4t+i
    holding key 2t + (i&1) + 8(i>>1) (+16 in the upper half), the columns
    that an s32 accumulator fragment gives lane t of each quad."""
    order = [permuted_key(kp) for kp in range(32)]
    assert sorted(order) == list(range(32))
    for t in range(4):
        for i in range(4):
            for half in (0, 16):
                assert order[half + 4 * t + i] == half + 2 * t + (i & 1) + 8 * (i >> 1)
    gen = torch.Generator().manual_seed(bh + sk + dh)
    v8 = torch.randint(-127, 128, (bh, sk, dh), generator=gen, dtype=torch.int8)
    vt = pack_v_int8(v8, block)
    skp = -(-sk // block) * block
    assert vt.shape == (bh, dh, skp) and vt.dtype == torch.int8 and vt.is_contiguous()
    back = torch.zeros((bh, skp, dh), dtype=torch.int8)
    for kp in range(skp):
        back[:, (kp // 32) * 32 + order[kp % 32]] = vt[:, :, kp]
    assert torch.equal(back[:, :sk], v8)
    assert not back[:, sk:].any()


@pytest.mark.parametrize("name", sorted(int8_variants.VARIANTS))
def test_int8_variants_apply_to_the_kernel_source(name):
    """Each variant that tools/int8_variants.py builds replaces lines that
    are in the kernel's source exactly once."""
    src = (cuda_build.CSRC_DIR / "flash_attention_int8.cu").read_text()
    out = int8_variants.variant_source(src, int8_variants.VARIANTS[name])
    assert (out == src) == (name == "kernel")


def test_int8_plain_takes_the_kernel_tile_or_an_explicit_block_k():
    """The plain core's default block_k is the kernel's key tile of that dh;
    a dh that the kernel does not take has no default."""
    gen = torch.Generator().manual_seed(5)
    for dh in (32, 64, 128, 256):
        q, k, v = (torch.randn((1, 40, dh), generator=gen) for _ in range(3))
        q8, k8, v8, scales = quantize_qkv_int8(q, k, v)
        if dh in INT8_BLOCK_K:
            assert torch.equal(flash_attention_int8_core_reference(q8, k8, v8, scales),
                               flash_attention_int8_core_reference(q8, k8, v8, scales,
                                                                   INT8_BLOCK_K[dh]))
        else:
            with pytest.raises(ValueError, match="dh"):
                flash_attention_int8_core_reference(q8, k8, v8, scales)
            assert flash_attention_int8_core_reference(q8, k8, v8, scales, 32).shape == q.shape


def test_build_reuses_the_library_of_the_same_source(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    path = cuda_build.library_path("flash_attention")
    assert path.parent == tmp_path and path.name.startswith("libflash_attention_")
    path.write_bytes(b"")

    def no_nvcc():
        raise AssertionError("a library that exists must not be rebuilt")

    monkeypatch.setattr(cuda_build, "find_nvcc", no_nvcc)
    assert cuda_build.build_library("flash_attention") == path


def test_build_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    """An edited header gives a new library path (so it is rebuilt) to every
    source that includes it, and a source that includes no header keeps its
    path."""
    for name in ("flash_attention", "short_attention"):
        assert [h.name for h in cuda_build.local_headers(cuda_build.CSRC_DIR / f"{name}.cu")] \
            == ["hopper.cuh"]
    _copy_sources("flash_attention", tmp_path)
    shutil.copy(cuda_build.CSRC_DIR / "flash_attention.cu", tmp_path)
    shutil.copy(cuda_build.CSRC_DIR / "short_attention.cu", tmp_path)
    (tmp_path / "plain.cu").write_text('extern "C" int tm_plain() { return 0; }\n')
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    names = ("flash_attention", "short_attention", "plain")
    before = [cuda_build.library_path(name) for name in names]
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [cuda_build.library_path(name) for name in names]
    assert after[0] != before[0] and after[1] != before[1] and after[2] == before[2]
    assert cuda_build.library_path("flash_attention") == after[0]  # stable for the same bytes


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    if shutil.which("nvcc") or (cuda_build.Path("/usr/local/cuda/bin/nvcc")).is_file():
        pytest.skip("this host has nvcc")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_library("flash_attention")
    assert not list(tmp_path.glob("*.so"))


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def no_library(name):
        raise AssertionError("CPU tensors must take the plain version")

    monkeypatch.setattr("tweediemix_tpu_torch.ops.flash_attention.load_library", no_library)
    q = torch.randn((2, 1024, 64)).to(torch.bfloat16)
    out = attention(q, q, q)
    ref = flash_attention_reference(q, q, q)
    assert torch.equal(out, ref)


def test_cpu_tensors_never_reach_the_int8_kernel(monkeypatch):
    def no_library(name):
        raise AssertionError("CPU tensors must take the plain version")

    monkeypatch.setattr("tweediemix_tpu_torch.ops.flash_attention.load_library", no_library)
    monkeypatch.setenv("TWEEDIEMIX_FLASH_INT8", "1")
    q = torch.randn((2, 1024, 64)).to(torch.bfloat16)
    counts = flash_attention.launches, flash_attention_int8.launches
    out = attention(q, q, q)
    assert torch.equal(out, flash_module.flash_attention_int8_reference(q, q, q))
    assert out.dtype == torch.bfloat16
    assert (flash_attention.launches, flash_attention_int8.launches) == counts


def _short_case(n, s, heads, dh, seed, merged=True):
    """bf16 q/k/v [N, S, heads·dh] on the card: ``chunk(3)`` views of one
    merged projection (row stride 3·heads·dh, as the model's self-attention
    gives them) or three contiguous tensors."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = heads * dh
    if merged:
        qkv = torch.randn((n, s, 3 * d), generator=gen, device="cuda").to(torch.bfloat16)
        return qkv.chunk(3, dim=-1)
    return [torch.randn((n, s, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)]


def _short_rel(q, k, v, heads, out):
    plain = short_seq_attention_reference(q.float(), k.float(), v.float(), heads)
    return (out.float() - plain).abs().max().item() / plain.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("n,s,heads,dh", SHORT_MAIN_SHAPES + SHORT_EDGE_SHAPES)
def test_short_kernel_matches_plain_on_card(n, s, heads, dh, merged):
    _card()
    q, k, v = _short_case(n, s, heads, dh, n + s + heads + dh, merged)
    before = short_seq_attention.launches
    out = short_seq_attention(q, k, v, heads)
    assert short_seq_attention.launches == before + 1
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == torch.bfloat16 and out.is_contiguous()
    assert torch.isfinite(out).all()
    assert _short_rel(q, k, v, heads, out) <= SHORT_TOL


@pytest.mark.cuda
def test_short_kernel_strongly_negative_scores_on_card():
    """Anti-aligned q/k at large magnitude: every row still a softmax
    average of v, as the plain version gives it."""
    _card()
    n, s, heads, dh = 64, 16, 2, 32
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.full((n, s, heads * dh), 8.0, device="cuda")
    k = -8.0 * (1.0 + 0.01 * torch.randn(q.shape, generator=gen, device="cuda"))
    v = torch.randn(q.shape, generator=gen, device="cuda")
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    out = short_seq_attention(q, k, v, heads)
    torch.cuda.synchronize()
    assert out.float().abs().max().item() > 1e-2
    assert _short_rel(q, k, v, heads, out) <= SHORT_TOL


@pytest.mark.cuda
def test_short_kernel_rejects_what_it_does_not_take_on_card():
    _card()
    q = torch.zeros((4, 16, 128), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        short_seq_attention(q.float(), q.float(), q.float(), 2)
    with pytest.raises(ValueError):  # dh = 16
        short_seq_attention(q, q, q, 8)
    q33 = torch.zeros((4, 33, 128), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # S > 32
        short_seq_attention(q33, q33, q33, 2)
    wide = torch.zeros((4, 16, 130), device="cuda", dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError):  # a row stride of 130 elements
        short_seq_attention(wide, wide, wide, 2)


@pytest.mark.cuda
def test_short_knob_dispatches_to_the_short_kernel_on_card(monkeypatch):
    _card()
    q, k, v = _short_case(64, 16, 2, 64, 1)
    before = short_seq_attention.launches
    monkeypatch.setenv("TWEEDIEMIX_SHORT_ATTENTION", "1")
    on = multi_head_attention(q, k, v, 2)
    assert short_seq_attention.launches == before + 1
    monkeypatch.setenv("TWEEDIEMIX_SHORT_ATTENTION", "0")
    off = multi_head_attention(q, k, v, 2)
    assert short_seq_attention.launches == before + 1
    assert (on.float() - off.float()).abs().max().item() <= SHORT_TOL * off.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [shape for shape, _ in SHORT_RAGGED_SHAPES]
                         + [(3, 16, 2, 64), (300, 7, 4, 64), (100, 32, 3, 128)])
def test_short_kernel_writes_only_its_output_on_card(shape):
    """At ragged edges the kernel matches the plain version and leaves a
    sentinel before and after its output untouched (TMA stores clip frames
    past S and rows past N)."""
    _card()
    n, s, heads, dh = shape
    q, k, v = _short_case(n, s, heads, dh, n + s + heads, merged=True)
    guard, numel = 4096, n * s * heads * dh
    fill = torch.finfo(torch.bfloat16).max
    big = torch.full((numel + 2 * guard,), fill, device="cuda", dtype=torch.bfloat16)
    out = big[guard:guard + numel].view(n, s, heads * dh)
    assert short_module._launch_cuda(q, k, v, heads, dh**-0.5, out=out) is out
    torch.cuda.synchronize()
    assert (big[:guard] == fill).all() and (big[guard + numel:] == fill).all()
    assert _short_rel(q, k, v, heads, out) <= SHORT_TOL


@pytest.mark.cuda
def test_short_plan_shared_memory_agrees_with_the_kernel_on_card():
    _card()
    lib, _ = short_module._launcher()
    fn = lib.tm_short_attention_smem_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, s, heads, dh in _plan_shapes():
        plan = short_module.tile_plan(n, s, heads, dh, sms)
        assert fn(s, dh, plan.rows, plan.stages) == plan.smem_bytes


@pytest.mark.cuda
def test_short_check_catches_an_unmasked_frame_on_card(tmp_path, monkeypatch):
    """Mutation check: a copy of the short kernel that does not mask the
    padded key frames (S = 12 pads to 16; the padded keys read as zeros and
    score 0) must fail the comparison with the plain version."""
    _card()
    masked = "const float val = col < s ? sc[j][e] * scale_log2 : kNegInf;"
    src = _copy_sources("short_attention", tmp_path)
    assert src.count(masked) == 1
    (tmp_path / "short_attention.cu").write_text(
        src.replace(masked, "const float val = sc[j][e] * scale_log2;"))
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    lib = ctypes.CDLL(str(cuda_build.build_library("short_attention")))
    monkeypatch.setattr(short_module, "_launcher", lambda: (lib, short_module.bind(lib)))
    q, k, v = _short_case(2048, 12, 10, 64, 7)
    rel = _short_rel(q, k, v, 10, short_seq_attention(q, k, v, 10))
    print(f"short kernel with its padded frames unmasked at S = 12: max err / max |plain| = {rel:.3e}")
    assert rel > SHORT_TOL


def _plan_shapes():
    return (SHORT_MAIN_SHAPES + SHORT_EDGE_SHAPES + [shape for shape, _ in SHORT_RAGGED_SHAPES]
            + [(1, 1, 1, 32), (4099, 16, 20, 128), (77, 32, 33, 128), (8193, 16, 3, 32),
               (130, 32, 7, 64)])


@pytest.mark.parametrize("shape", _plan_shapes())
def test_short_plan_covers_every_band_once(shape):
    """The persistent grid's walk, as the kernel decodes it (block b takes
    tiles b, b + grid, ...; tile t its rows and head, clipped at N), covers
    every (pixel row, head) band exactly once, and every consumer warp
    always meets the same stages."""
    n, s, heads, dh = shape
    plan = short_module.tile_plan(n, s, heads, dh, H100_SMS)
    assert plan.tiles == -(-n // plan.rows) * heads
    assert 1 <= plan.grid <= min(plan.tiles, plan.blocks_per_sm * H100_SMS)
    seen = torch.zeros((n, heads), dtype=torch.int32)
    for b in range(plan.grid):
        for t in range(b, plan.tiles, plan.grid):
            for r, h in plan.bands(t):
                if r < n:
                    seen[r, h] += 1
    assert bool((seen == 1).all())
    assert plan.stages % short_module.CONSUMER_WARPS == 0 and plan.stages >= short_module.CONSUMER_WARPS


@pytest.mark.parametrize("shape", _plan_shapes())
def test_short_plan_respects_tma_and_shared_memory_limits(shape):
    n, s, heads, dh = shape
    plan = short_module.tile_plan(n, s, heads, dh, H100_SMS)
    assert plan.sp in (16, 32) and s <= plan.sp < s + 16
    assert all(1 <= b <= short_module.MAX_BOX for b in plan.box)
    assert plan.box[0] * 2 in (64, 128) and dh % plan.box[0] == 0  # within the swizzle span
    assert plan.tile_bytes % 1024 == 0  # every box starts on the swizzle's 1024-byte period
    assert plan.smem_bytes == short_module.smem_bytes(plan.sp, dh, plan.rows, plan.stages)
    assert plan.smem_bytes <= short_module.MAX_SMEM_PER_BLOCK
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= short_module.SMEM_PER_SM


def test_short_plan_of_the_video_shapes():
    """Every consumer warp of the grid gets tiles at the video path's shapes,
    and the smallest shape still spreads over every SM."""
    for n, s, heads, dh in SHORT_MAIN_SHAPES:
        plan = short_module.tile_plan(n, s, heads, dh, H100_SMS)
        assert plan.grid == plan.blocks_per_sm * H100_SMS
        assert plan.tiles >= plan.grid * short_module.CONSUMER_WARPS
    with pytest.raises(ValueError):
        short_module.tile_plan(8, 33, 2, 64, H100_SMS)
    with pytest.raises(ValueError):
        short_module.tile_plan(8, 16, 2, 80, H100_SMS)


@pytest.mark.parametrize("shape,rows", SHORT_RAGGED_SHAPES)
def test_short_ragged_shapes_reach_a_ragged_row_edge(shape, rows):
    """The ragged cases that chip_smoke.py and the card tests run do have
    a last tile that N does not fill, at the plan an H100 takes."""
    n, s, heads, dh = shape
    plan = short_module.tile_plan(n, s, heads, dh, H100_SMS)
    assert plan.rows == rows and n % rows


def test_short_timing_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        short_timing.main([])


def test_short_timing_tool_times_the_video_shapes():
    assert short_timing.SHAPES == SHORT_MAIN_SHAPES
    assert sum(short_timing.LAUNCHES_PER_CLIP) == 1700  # 34 launches per UNet call x 50
    assert short_timing.short_bytes(128, 16, 20, 64) == 4 * 128 * 16 * 20 * 64 * 2


def test_short_timing_tool_times_each_tree_in_its_own_process(tmp_path, monkeypatch, capsys):
    """With --parent, each turn (parent, this, this, parent) runs the tool's
    own file in a fresh process rooted at its tree, and each tree's rows are
    the mean of its turns."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []

    def fake_run(cmd, cwd, env, capture_output, text):
        calls.append((cmd, cwd, env["PYTHONPATH"]))
        ms = 1.0 if cwd == tmp_path else 0.5
        rows = [dict(shape=list(shape), merged_qkv=merged, rel_err=1e-3, ms=ms,
                     flushed_ms=ms + len(calls), host_us=30.0)
                for shape in short_timing.SHAPES for merged in (True, False)]
        out = "\n".join(["building"] + ["ROW " + json.dumps(r) for r in rows])
        return subprocess.CompletedProcess(cmd, 0, out, "")

    monkeypatch.setattr(short_timing.subprocess, "run", fake_run)
    short_timing.main(["--parent", str(tmp_path), "--out", str(tmp_path / "rows.jsonl")])
    this = short_timing.ROOT
    assert [(cwd, path) for _, cwd, path in calls] == [
        (tmp_path, str(tmp_path)), (this, str(this)), (this, str(this)), (tmp_path, str(tmp_path))]
    assert all(cmd[1:] == [str(Path(short_timing.__file__).resolve()), "--child"]
               for cmd, _, _ in calls)
    rows = [json.loads(line) for line in (tmp_path / "rows.jsonl").read_text().splitlines()]
    assert len(rows) == 2 * 2 * len(short_timing.SHAPES)
    first = {r["tree"]: r for r in rows if r["shape"] == [8192, 16, 8, 64] and r["merged_qkv"]}
    assert first["parent"]["ms"] == 1.0 and first["parent"]["flushed_ms"] == 3.5  # turns 1, 4
    assert first["this"]["ms"] == 0.5 and first["this"]["flushed_ms"] == 3.0  # turns 2, 3
    assert first["this"]["share_of_bound"] == first["this"]["bound_ms"] / 3.0
    assert len(capsys.readouterr().out.splitlines()) == len(rows)


def test_short_timing_tool_takes_its_timers_by_path():
    """The tool loads this tree's utils/profiling.py by its path beside
    another tree's package, so that module imports nothing of the package."""
    timers = short_timing._timers()
    assert all(callable(getattr(timers, name)) for name in ("graph_ms", "flushed_ms",
                                                             "host_us_per_call"))
    source = Path(timers.__file__).read_text()
    assert "tweediemix_tpu" not in "".join(line for line in source.splitlines()
                                           if line.startswith(("import ", "from ")))


def test_cpu_tensors_never_reach_the_short_kernel(monkeypatch):
    def no_library(name):
        raise AssertionError("CPU tensors must take the plain version")

    monkeypatch.setattr("tweediemix_tpu_torch.ops.short_attention.load_library", no_library)
    monkeypatch.setenv("TWEEDIEMIX_SHORT_ATTENTION", "1")
    q, k, v = torch.randn((3, 8, 16, 128)).to(torch.bfloat16).unbind(0)
    before = short_seq_attention.launches
    out = multi_head_attention(q, k, v, 2)
    assert torch.equal(out, short_seq_attention_reference(q, k, v, 2))
    assert short_seq_attention.launches == before


# -- the W8A8 linear kernels ---------------------------------------------------------


def _w8a8_case(m, k, n, dtype, seed, bias=True):
    """x [m, k] (randn, a few loud rows), an int8 weight [n, k] with fp32
    scales and a bias on the card; the static abs-max clips the loud rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda")
    x[:: 7] *= 6.0
    w = torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5
    wq, ws = quant_module.quantize_weight_int8(w)
    b = torch.randn(n, generator=gen, device="cuda").to(dtype) if bias else None
    return x.to(dtype), wq, ws, b, 0.5 * x.abs().max().item()


def _w8a8_check(x, wq, ws, b, amax):
    """The kernels' y, x_q and row scales against the plain version's on
    the card, byte for byte: x_q and the scales read from the work buffer
    the wrapper is handed."""
    m, k = x.shape
    xq_bytes = quant_module.w8a8_work_bytes(m, k, False)
    work = torch.full((quant_module.w8a8_work_bytes(m, k, True),), 0xA5, dtype=torch.uint8,
                      device="cuda")
    y = quant_module.w8a8_matmul_cuda(x, wq, ws, amax, b, work=work)
    want_q, want_s = quant_module.quantize_activation_int8(x, amax)
    want = quant_module.w8a8_matmul_reference(x, wq, ws, amax, b)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and y.shape == want.shape
    assert torch.equal(work[: m * k].view(torch.int8).view(m, k), want_q), "x_q"
    if amax > 0:
        assert (work[xq_bytes:] == 0xA5).all(), "a static scale writes no row scales"
    else:
        assert torch.equal(work[xq_bytes:].view(torch.float32), want_s[:, 0]), "row scales"
    differ = (y != want).sum().item()
    assert differ == 0, f"{differ} of {y.numel()} outputs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", W8A8_MAIN_SHAPES)
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("bias", [True, False])
def test_w8a8_kernels_equal_plain_at_the_sdxl_sites_on_card(m, k, n, static, bias):
    _card()
    x, wq, ws, b, amax = _w8a8_case(m, k, n, torch.bfloat16, m + k + n, bias)
    _w8a8_check(x, wq, ws, b, amax if static else 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 17, 308])
@pytest.mark.parametrize("k,n", [(640, 1920), (5120, 1280), (320, 960), (32, 48)])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8a8_kernels_equal_plain_at_ragged_rows_on_card(m, k, n, static, dtype):
    """Ragged M (TMA's zero fill and clipped stores), a K that is not a
    multiple of the 128-wide k tile, N below one tile, and fp32 activations
    (the tiny presets' UNets under --quant)."""
    _card()
    x, wq, ws, b, amax = _w8a8_case(m, k, n, dtype, 3 * m + k + n)
    _w8a8_check(x, wq, ws, b, amax if static else 0.0)


@pytest.mark.cuda
def test_w8a8_qlinear_launches_the_kernels_on_card():
    """A bf16 QLinear on the card: two launches a call through
    ``w8a8_matmul``, its output the plain version's, a [B, S, K] input
    and a non-contiguous one alike."""
    _card()
    lin = quant_module.QLinear(640, 1280).to("cuda", torch.bfloat16)
    with torch.no_grad():
        lin.bias.normal_()
    x = torch.randn((2, 300, 640), device="cuda").to(torch.bfloat16)
    before = quant_module.w8a8_matmul_cuda.launches
    for static in (0.0, 3.0):
        lin.static_amax = static
        with torch.no_grad():
            got = lin(x)
            strided = lin(x.transpose(0, 1).contiguous().transpose(0, 1))
        want = quant_module.w8a8_matmul_reference(x, lin.weight_q, lin.weight_scale, static, lin.bias)
        assert got.shape == (2, 300, 1280) and torch.equal(got, want) and torch.equal(strided, want)
    assert quant_module.w8a8_matmul_cuda.launches == before + 4


@pytest.mark.cuda
def test_w8a8_kernels_reject_what_they_do_not_take_on_card():
    _card()
    wq = torch.zeros((64, 64), dtype=torch.int8, device="cuda")
    ws = torch.ones(64, device="cuda")
    with pytest.raises(TypeError):
        quant_module.w8a8_matmul(torch.zeros((4, 64), device="cuda", dtype=torch.float16), wq, ws)
    with pytest.raises(ValueError):
        quant_module.w8a8_matmul(torch.zeros((4, 72), device="cuda", dtype=torch.bfloat16),
                                 torch.zeros((64, 72), dtype=torch.int8, device="cuda"), ws)
    with pytest.raises(ValueError):
        quant_module.w8a8_matmul(torch.zeros((4, 64), device="cuda", dtype=torch.bfloat16),
                                 wq.t(), ws)  # not contiguous
    with pytest.raises(ValueError):
        quant_module.w8a8_matmul(torch.zeros((4, 64), device="cuda", dtype=torch.bfloat16),
                                 wq.cpu(), ws)
    with pytest.raises(ValueError):  # a work buffer one byte short
        quant_module.w8a8_matmul_cuda(
            torch.zeros((4, 64), device="cuda", dtype=torch.bfloat16), wq, ws,
            work=torch.empty(quant_module.w8a8_work_bytes(4, 64, True) - 1, dtype=torch.uint8,
                             device="cuda"))


@pytest.mark.cuda
def test_w8a8_check_catches_a_skipped_k_tile_on_card(tmp_path, monkeypatch):
    """Mutation check: a copy of the GEMM whose consumers skip their second
    k tile (no product issued for it, its stage still released) must fail
    the byte comparison with the plain version."""
    _card()
    loop = "for (int kk = 0; kk < kBlockK / 32; ++kk) {"
    src = _copy_sources("w8a8_linear", tmp_path)
    assert src.count(loop) == 1
    skip = "for (int kk = 0; kk < (kt == 1 ? 0 : kBlockK / 32); ++kk) {"
    (tmp_path / "w8a8_linear.cu").write_text(src.replace(loop, skip))
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    lib = ctypes.CDLL(str(cuda_build.build_library("w8a8_linear")))
    monkeypatch.setattr(quant_module, "_launcher", lambda: (lib, quant_module.bind(lib)))
    x, wq, ws, b, _ = _w8a8_case(2048, 1280, 1280, torch.bfloat16, 7)
    y = quant_module.w8a8_matmul(x, wq, ws, 0.0, b)
    want = quant_module.w8a8_matmul_reference(x, wq, ws, 0.0, b)
    torch.cuda.synchronize()
    rel = _rel(y, want.float())
    print(f"W8A8 GEMM with its second k tile skipped: max err / max |plain| = {rel:.3e}")
    assert rel > 1e-2


def test_cpu_tensors_never_reach_the_w8a8_kernels(monkeypatch):
    def no_library(name):
        raise AssertionError("CPU tensors must take the plain version")

    monkeypatch.setattr(quant_module, "load_library", no_library)
    lin = quant_module.QLinear(64, 48)
    x = torch.randn((2, 5, 64))
    before = quant_module.w8a8_matmul_cuda.launches
    with torch.no_grad():
        got = lin(x)
    want = quant_module.w8a8_matmul_reference(x, lin.weight_q, lin.weight_scale, 0.0, lin.bias)
    assert torch.equal(got, want) and quant_module.w8a8_matmul_cuda.launches == before


# -- GroupNorm (csrc/group_norm.cu) ------------------------------------------------------

# (x shape, groups): the video UNet's 64 temporal rows of 1.3 MB (sixteen
# blocks a row), 1024 spatial rows of 80 and 240 KB, SDXL's 128 rows at 128²
# (983 KB at 960 channels), and 4 rows of 4 MB that no cluster's shared
# memory holds (x read twice)
GN_CARD_SHAPES = [((2, 320, 16, 64, 64), 32), ((32, 320, 64, 64), 32), ((32, 960, 64, 64), 32),
                  ((4, 320, 128, 128), 32), ((4, 960, 128, 128), 32), ((2, 64, 16, 64, 64), 2)]
GN_TOL = 1.05


def _gn_case(shape, seed, mean=0.0, std=1.0, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (mean + std * torch.randn(shape, generator=g, device="cuda")).to(dtype)
    w = (1.0 + 0.2 * torch.randn(shape[1], generator=g, device="cuda")).to(dtype)
    b = (0.2 * torch.randn(shape[1], generator=g, device="cuda")).to(dtype)
    return x, w, b


def _gn_errors(x, groups, w, b, silu, eps=1e-5):
    """The kernel's output and the max abs errors of it and of PyTorch's
    composition in x's dtype, against the exact computation (fp64) on the
    same inputs."""
    exact = gn_module.group_norm_reference(x.double(), groups, w.double(), b.double(), eps, silu)
    got = group_norm(x, groups, w, b, eps, silu=silu)
    lib = gn_module.group_norm_reference(x, groups, w, b, eps, silu)
    torch.cuda.synchronize()
    return (got, (got.double() - exact).abs().max().item(),
            (lib.double() - exact).abs().max().item())


def _gn_plan(x, groups):
    n, c = x.shape[:2]
    spatial = x.numel() // (n * c)
    return gn_module.launch_plan(n * groups, c // groups * spatial, spatial, c // groups,
                                 x.element_size(), x.data_ptr() % 16 == 0,
                                 torch.cuda.get_device_properties(0).multi_processor_count)


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,groups", GN_CARD_SHAPES)
def test_group_norm_kernel_is_no_less_exact_than_pytorch_on_card(shape, groups, silu):
    _card()
    x, w, b = _gn_case(shape, 11)
    plan = _gn_plan(x, groups)
    launches, paths = group_norm.launches, dict(group_norm.paths)
    got, err, lib_err = _gn_errors(x, groups, w, b, silu)
    print(f"group_norm {shape} G={groups} silu={silu} plan {plan}: max err {err:.3e}, "
          f"PyTorch bf16 {lib_err:.3e}")
    assert got.shape == x.shape and got.dtype == x.dtype and torch.isfinite(got).all()
    assert err <= GN_TOL * lib_err
    assert group_norm.launches == launches + 1
    path = "one_read" if plan.one_read else "reread"
    assert group_norm.paths[path] == paths[path] + 1
    assert plan.one_read == (shape != (2, 64, 16, 64, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [GN_CARD_SHAPES[0], GN_CARD_SHAPES[-1]])
def test_group_norm_kernel_merges_rows_far_from_zero_on_card(shape, groups):
    """Mean 1000 and standard deviation 8: a sum of squares in fp32 loses
    the variance to cancellation; Chan's merge keeps it."""
    _card()
    x, w, b = _gn_case(shape, 12, mean=1000.0, std=8.0)
    got, err, lib_err = _gn_errors(x, groups, w, b, False)
    print(f"group_norm {shape} mean 1000 std 8: max err {err:.3e}, PyTorch bf16 {lib_err:.3e}")
    assert err <= GN_TOL * lib_err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset", [(torch.float32, 0), (torch.float16, 0),
                                          (torch.bfloat16, 1), (torch.float32, 3)])
@pytest.mark.parametrize("shape,groups", [((2, 12, 5, 7), 3), ((3, 64, 16, 16), 8),
                                          ((2, 32, 4, 9, 9), 4)])
def test_group_norm_kernel_takes_other_types_and_unaligned_tensors_on_card(shape, groups, dtype,
                                                                           offset):
    """fp32 and fp16, and x one element past a 16-byte boundary (or S not a
    whole number of 16 bytes): single-element loads and two reads."""
    _card()
    numel = 1
    for d in shape:
        numel *= d
    g = torch.Generator(device="cuda").manual_seed(13)
    x = (2.0 + torch.randn(numel + offset, generator=g, device="cuda")).to(dtype)[offset:].view(shape)
    w = (1.0 + 0.2 * torch.randn(shape[1], generator=g, device="cuda")).to(dtype)
    b = (0.2 * torch.randn(shape[1], generator=g, device="cuda")).to(dtype)
    for silu in (False, True):
        got, err, lib_err = _gn_errors(x, groups, w, b, silu)
        assert got.dtype == dtype and err <= 2 * lib_err + 1e-6, (err, lib_err)
    full = 16 // x.element_size()
    spatial = x.numel() // (shape[0] * shape[1])
    assert _gn_plan(x, groups).vec == (1 if offset or spatial % full else full)


@pytest.mark.cuda
def test_group_norm_kernel_in_a_graph_capture_on_card():
    """Captured in a CUDA graph and replayed on new inputs, the kernel gives
    what an eager launch gives, bit for bit; the capture counts a launch
    and no path."""
    _card()
    x, w, b = _gn_case((2, 320, 16, 32, 32), 14)
    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        group_norm(static, 32, w, b, 1e-6, silu=True)  # the library's first load, off the capture
    torch.cuda.current_stream().wait_stream(side)
    launches, paths = group_norm.launches, dict(group_norm.paths)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = group_norm(static, 32, w, b, 1e-6, silu=True)
    assert group_norm.launches == launches + 1 and group_norm.paths == paths
    for seed in (15, 16):
        fresh, _, _ = _gn_case((2, 320, 16, 32, 32), seed)
        static.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, group_norm(fresh, 32, w, b, 1e-6, silu=True))


@pytest.mark.cuda
def test_group_norm_gradient_path_launches_the_kernel_on_card():
    _card()
    x, w, b = _gn_case((2, 64, 4, 16, 16), 17)
    up = torch.randn(x.shape, device="cuda").to(x.dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    launches = group_norm.launches
    out = group_norm(*leaves[:1], 8, *leaves[1:], 1e-5, silu=True)
    assert group_norm.launches == launches + 1 and out.grad_fn.name() == "GroupNormFunctionBackward"
    (out.float() * up.float()).sum().backward()
    plain = [t.clone().requires_grad_() for t in (x, w, b)]
    ref = gn_module.group_norm_reference(plain[0], 8, plain[1], plain[2], 1e-5, True)
    (ref.float() * up.float()).sum().backward()
    for a, e in zip(leaves, plain):
        assert torch.equal(a.grad, e.grad)


@pytest.mark.cuda
def test_group_norm_plan_shared_memory_agrees_with_the_kernel_on_card():
    _card()
    lib, fn = gn_module._launcher()
    smem = lib.tm_group_norm_smem_bytes
    smem.restype = ctypes.c_longlong
    smem.argtypes = [ctypes.c_int] * 4
    for shape, groups in GN_CARD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.empty(shape, dtype=dtype, device="cuda")
            plan = _gn_plan(x, groups)
            cpg = shape[1] // groups
            assert smem(plan.chunk, x.element_size(), cpg, int(plan.one_read)) == plan.smem_bytes
    x = torch.ones((2, 8, 4, 4), dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        group_norm(x, 2)
    with pytest.raises(ValueError):
        group_norm(x.float(), 3)
    y = torch.empty((2, 8, 4, 4), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    # a cluster of three blocks is no plan the kernel takes
    assert fn(y.data_ptr(), y.data_ptr(), None, None, 0, 0, 0, 4, 64, 16, 4, 2, 1e-5, 0, 3, 128,
              32, 8, 1, 1, stream) != 0


@pytest.mark.cuda
def test_group_norm_check_catches_an_unmerged_cluster_on_card(tmp_path, monkeypatch):
    """Mutation check: a copy of the kernel in which every block of a
    cluster takes the first block's statistics for the row's must fail the
    comparison at the temporal rows (sixteen blocks a row)."""
    _card()
    merged = "if (static_cast<uint32_t>(lane) < cluster) {"
    src = _copy_sources("group_norm", tmp_path)
    assert src.count(merged) == 1
    (tmp_path / "group_norm.cu").write_text(src.replace(merged, "if (lane == 0) {"))
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    lib = ctypes.CDLL(str(cuda_build.build_library("group_norm")))
    monkeypatch.setattr(gn_module, "_launcher", lambda: (lib, gn_module.bind(lib)))
    x, w, b = _gn_case((2, 320, 16, 64, 64), 18)
    # channels of different means, so that the first block's share of a row is not the row
    x = (x.float() + 0.05 * torch.arange(320, device="cuda").view(1, 320, 1, 1, 1)).to(x.dtype)
    _, err, lib_err = _gn_errors(x, 32, w, b, False)
    print(f"group_norm with one block's statistics for the cluster's: max err {err:.3e}, "
          f"PyTorch bf16 {lib_err:.3e}")
    assert err > GN_TOL * lib_err
