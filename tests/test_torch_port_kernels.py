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
alone reads up to ~4e-3.
"""

import ctypes
import os
import shutil

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
from tweediemix_tpu_torch.tools import int8_variants

# each xdist worker takes its share of the host's cores (a serial run keeps them all)
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

INT8_TOL = 1e-2
SHORT_TOL = 1e-2
# (N, S, heads, dh): the video path's five shapes (transformer_in, levels
# 0-2, mid), then the edge cases
SHORT_MAIN_SHAPES = [(8192, 16, 8, 64), (8192, 16, 5, 64), (2048, 16, 10, 64),
                     (512, 16, 20, 64), (128, 16, 20, 64)]
SHORT_EDGE_SHAPES = [(300, 1, 4, 64), (300, 7, 4, 64), (300, 12, 5, 64), (300, 32, 5, 64),
                     (257, 16, 4, 32), (257, 16, 2, 128), (100, 32, 3, 128), (33, 20, 6, 32)]


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
    """An edited header gives a new library path (so it is rebuilt), and a
    source that includes no header keeps its path."""
    assert [h.name for h in cuda_build.local_headers(cuda_build.CSRC_DIR / "flash_attention.cu")] \
        == ["hopper.cuh"]
    _copy_sources("flash_attention", tmp_path)
    shutil.copy(cuda_build.CSRC_DIR / "flash_attention.cu", tmp_path)
    shutil.copy(cuda_build.CSRC_DIR / "short_attention.cu", tmp_path)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    before = cuda_build.library_path("flash_attention"), cuda_build.library_path("short_attention")
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = cuda_build.library_path("flash_attention"), cuda_build.library_path("short_attention")
    assert after[0] != before[0] and after[1] == before[1]
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
def test_short_check_catches_an_unmasked_frame_on_card(tmp_path, monkeypatch):
    """Mutation check: a copy of the short kernel that does not mask the
    padded key frames (S = 12 pads to 16) must fail the comparison with the
    plain version."""
    _card()
    masked = "const float val = col < s ? sc[j][e] * scale_log2 : kNegInf;"
    src = (cuda_build.CSRC_DIR / "short_attention.cu").read_text()
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
