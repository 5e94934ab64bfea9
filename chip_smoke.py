#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
the ``tweediemix_tpu_torch`` package beside this file; it imports nothing of
JAX or of the JAX package. Phases:

1. the card's name and power limit, torch/CUDA versions, the kernels'
   build (one nvcc per source, sm_90a, all started together) and its time;
2. kernels: each hand-written kernel against its plain PyTorch version on
   the same inputs at the main paths' shapes and the edge cases, with its
   time, the plain version's, one PyTorch library call's (a yardstick only)
   and the bound (for the bf16 kernel also the softmax's exp2 floor and the
   wrapper's host cost per call); the int8 kernel also against exact fp32
   attention, with its exp2 and issue floors, and its two fused quantise
   passes bitwise against their plain versions, timed against their byte
   bound; the bf16 kernel with a gradient at the training shape
   (``FlashAttention``: the kernel forward, the math backward), dq/dk/dv
   against autograd of the fp32 plain version, with the backward's time,
   bound and SDPA's forward+backward;
3. reference: a small UNet and a short fusion sample on the card (bf16,
   through the kernel) against the same weights on the CPU (fp32, plain
   versions); with resampling, the card's distance from fp32 is held
   against the plain bf16 path's on the CPU; then small W8A8 UNets
   ("int8" and "int8_conv", the int8 attention core on) the same way, and
   small W8A8 UNet3Ds (both knobs on) likewise; the tiny SAM and OWL-ViT
   detector, and the tiny GroundingDINO, on the card against the CPU in
   fp32 (finite logits, the -inf pattern and the top queries); one train
   step of a small
   config (remat, a modifier token, prior preservation) on the card in bf16
   against the CPU in fp32, held against the plain bf16 path's distance;
4. main path: the SDXL multi-concept fusion sample at full width (UNet
   ``sdxl(concept_slots=4)`` in bf16 with seeded random weights, fp32 VAE,
   50 DDIM steps at 1024², N=3, t_cond 0.2, resampling 10, jumping 5, half
   masks) through ``TweedieMixPipeline.sample``, twice, with the kernel's
   launch count checked on each run, then one batch-4 and one batch-2 UNet
   call under torch.profiler (device time by kernel class, idle share);
   then the CLI path: a full-width SDXL checkpoint of seeded random weights
   in the diffusers layout (its parameter counts held to the published
   checkpoint's), synthetic 49408-entry tokenizers and three concept deltas
   (one in the compressed [u, v] form) are written under ``build/`` and
   ``tweediemix_tpu_torch.cli.fusion_sampling.main`` runs from them, in
   process, with the main path's sampling flags and the heuristic
   segmenter, to one 1024² PNG: the PNG is decoded and checked, the bf16
   kernel's launches counted, the modifier rows of both embedding tables
   held to the deltas, and both towers in bf16 on the card held to fp32 on
   the CPU on the seven prompts' ids; then text-guided segmentation from
   the same directory (``phase_cli_segmentation``): a segment-anything
   ViT-H ``.pth`` and an OWL-ViT base-patch32 directory of seeded random
   weights are written, the CLI runs again with ``--sam_checkpoint`` and
   ``--detector_dir`` (SAM and the detector at the boundary step) to one
   PNG with its segmentation seconds, scores, mask areas, peak memory and
   launches, ``tweediemix_tpu_torch.cli.segment.main`` writes a mask PNG
   per concept from that PNG, and the fusion CLI reads them back through
   ``--mask_dir`` for a 4-step sample; SAM's encoder, the detector and the
   decoder are timed, and one global and one windowed ViT-H block are held
   to fp32 on the CPU; then GroundingDINO (``phase_cli_dino``): a Swin-B
   ``.pth`` of seeded random weights in the original repo's layout (its
   232,313,216 parameters held) and a synthetic 30522-line ``vocab.txt``
   are written, the fusion CLI runs with ``--detector dino`` and ``auto``
   (launches counted, one PNG each), the segment CLI with ``dino``, one
   ``DinoDetector`` call is timed by stage and profiled, and a Swin-B
   block, an encoder layer and a decoder layer are held to fp32 on the
   CPU; then, from the same directory, the training CLI
   (``phase_cli_train``): instance PNGs, class images sampled into an empty
   directory, 10 steps at 512² with prior preservation, a modifier token and
   remat (saving at 5), then 3 steps with ``--train_text_encoder
   --use_8bit_adam``, each run's launches per step counted, its trainable
   leaves moved and frozen ones bit-equal, one step profiled, and the
   trained delta sampled by the fusion CLI; the directory is deleted (the
   fusion PNG is kept for phase 7);
5. W8A8 main path: the same sample with ``quant="int8"`` at four seeds,
   static per-site activation scales calibrated on the card for these
   weights (timesteps 999/501/1 at batch 4, margin 1.25) and the int8
   attention core on (``TWEEDIEMIX_FLASH_INT8=1``): one warm and one timed
   call, the int8 kernel's and its quantise passes' launch counts checked
   and the bf16 kernel's held at 0, then one batch-4 call profiled with the int8 core on and off;
6. video: the short-sequence (frame-axis) kernel against its plain version
   at the video path's five shapes (as views of a merged qkv and
   contiguous) and its edge cases; a small UNet3D and a 3-step video
   trajectory on the card (bf16, both kernels) against the CPU (fp32, plain
   versions); the I2VGen-XL image-to-video path at full width
   (``UNet3DConfig.i2vgen()`` in bf16 with seeded random weights, fp32 VAE,
   50 DDIM steps, CFG 9, 16 frames at 512², the short-attention knob on)
   through ``I2VPipeline.generate``, one warm and one timed clip with both
   kernels' launch counts checked, then one batch-2 UNet call profiled with
   the knob on and off;
7. the video CLI: a full-width I2VGen-XL directory of seeded random weights
   in the diffusers layout (its parameter counts held, fp16 variant files,
   the VAE in fp32) is written under ``build/`` and
   ``tweediemix_tpu_torch.cli.run_video.main`` turns phase 4's PNG into a
   16-frame 512² GIF at the reference's defaults, in bf16 and with
   ``--quant int8`` and the int8 core on: each run's launches of all three
   kernels are counted and its GIF read back by the port's decoder.

It prints a JSON line of kernel results, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Any failed check
exits non-zero without that line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12  # HBM3 bytes/s, H100 SXM data sheet
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
H100_SMS = 132
# the SM clock at which H100_BF16_FLOPS holds: 4096 dense bf16 flops per
# clock per SM (about 1830 MHz)
H100_PEAK_CLOCK_HZ = H100_BF16_FLOPS / (H100_SMS * 4096)
MUFU_EX2_PER_CLOCK_PER_SM = 16  # exp2 on the special-function units, sm_90
ISSUE_PER_CLOCK_PER_SM = 128  # four schedulers, one warp instruction (32 threads) each
# instructions per score of the int8 kernel at dh 64, counted once by hand
# in the SASS of one build (cuobjdump -sass, the loop's path for a tile that
# is not the last, over the 64 scores a consumer thread holds per tile): a
# kernel edit can change it, so the issue floor it gives is only logged
INT8_INSTR_PER_SCORE = 10.2
# max |kernel - plain| / max |plain|, the plain version in fp32 on the same
# bf16 inputs. randn q/k/v give outputs of std ~ sqrt(e/Sk), far below 1, so
# the limit is relative: the kernel's bf16 output rounding alone reads up to
# ~4e-3, while a skipped 64-key tile at Sk = 4096 reads ~1e-1.
FLASH_REL_TOL = 1e-2
EPS_REL_TOL = 5e-2  # small UNet eps, bf16 card vs fp32 CPU, relative to max |eps|
SAMPLE_REL_TOL = 1e-2  # short trajectory latent without resampling, same comparison
# With resampling, bf16 rounding anywhere is amplified step by step (the
# composed Tweedie (N-1)·x0_multi − Σ x0_single cancels most of x), so the
# card's error against fp32 is held against the plain bf16 path's error on
# the CPU: a kernel fault shows as a card error far above the plain one.
RESAMPLE_RATIO_TOL = 3.0
# The video trajectory's CFG 9 multiplies the eps error of bf16 by up to 19,
# so its latent is held the same way: the card's distance from the CPU fp32
# run within 3x the plain bf16 path's on the CPU (which alone reads ~9e-2
# of max |latent| after 3 steps at the small config).
VIDEO_RATIO_TOL = 3.0
# The int8 kernel against its plain version on the same int8 inputs with the
# same block_k: the same arithmetic but for exp2 ulps, the row-sum order and
# the bf16 output, so the bf16 kernel's relative limit holds. Against exact
# fp32 attention: the JAX package's own bounds for the int8 core
# (tests/test_attention.py::test_flash_int8_qkpv_matches_fp_kernel, corr >
# 0.999 and max err < 0.12 of max) at that test's shapes. At the main
# path's shapes the int8 algorithm's max-element error grows with Sk and the
# element count (0.11-0.24 of max on an H100, the kernel and its plain
# version alike), so there corr > 0.999 holds with the relative L2 error
# < 0.05 (0.030-0.038 on an H100).
INT8_EXACT_CORR, INT8_EXACT_REL, INT8_EXACT_L2 = 0.999, 0.12, 0.05
INT8_JAX_TEST_SHAPES = [(4, 256, 256, 64), (2, 300, 300, 64), (2, 128, 128, 128),
                        (2, 300, 300, 128)]
# q and k of randn x INT8_LOUD give a score scale q_s·k_s above 0.01, where
# a rounded exponent addend would lift a row max's p8 to 128 (-128 as an s8
# operand): held against the plain version like the main shapes
INT8_LOUD, INT8_LOUD_SHAPES = 8.0, [(8, 1024, 1024, 64), (4, 1024, 1024, 128)]
# A W8A8 UNet on the card (bf16) against the same int8 weights on the CPU
# (fp32): an int8 rounding flips wherever bf16 moves an activation across a
# half step, so the card's distance is held against the plain bf16 W8A8
# path's distance on the CPU, as for the resampled sample.
W8A8_RATIO_TOL = 3.0
# (BH, Sq, Sk, dh): the main path's four shapes, then the edge cases
MAIN_SHAPES = [(40, 4096, 4096, 64), (20, 4096, 4096, 64), (80, 1024, 1024, 64), (40, 1024, 1024, 64)]
# partial 128-row query blocks (Sq = 129, 1000), partial last key tiles (Sk =
# 77, 129, 1000, 4100), dh 128 and 256 at ragged lengths, BH = 320
EDGE_SHAPES = [(2, 300, 300, 128), (8, 1024, 1024, 256), (4, 1024, 77, 64), (2, 129, 129, 64),
               (1, 1000, 4100, 64), (320, 129, 77, 64), (2, 1000, 129, 128), (2, 129, 4100, 128),
               (2, 129, 1000, 256)]
# the W8A8 main path's four shapes at four seeds (the sampler folds seeds
# into the rows of each call)
INT8_MAIN_SHAPES = [(160, 4096, 4096, 64), (80, 4096, 4096, 64), (320, 1024, 1024, 64),
                    (160, 1024, 1024, 64)]
# the video path's bf16 flash shapes: spatial self-attention of 32 folded
# frames at the 64x64 and 32x32 latent levels
VIDEO_FLASH_SHAPES = [(160, 4096, 4096, 64), (320, 1024, 1024, 64)]
# (N, S, heads, dh) of the short-sequence kernel: the video path's five
# shapes per UNet call (transformer_in, levels 0-2, mid; N = 2 rows x h x w
# pixels, S = 16 frames), then the edge cases
SHORT_MAIN_SHAPES = [(8192, 16, 8, 64), (8192, 16, 5, 64), (2048, 16, 10, 64),
                     (512, 16, 20, 64), (128, 16, 20, 64)]
SHORT_EDGE_SHAPES = [(300, 1, 4, 64), (300, 7, 4, 64), (300, 12, 5, 64), (300, 32, 5, 64),
                     (257, 16, 4, 32), (257, 16, 2, 128), (100, 32, 3, 128)]
KERNELS = ("flash_attention", "flash_attention_int8", "short_attention")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def host_us_per_call(fn, calls: int = 200, repeats: int = 5) -> float:
    """Host microseconds to enqueue one call, timed while the device is kept
    busy (so the launch queue neither drains nor fills); the median of
    ``repeats`` runs of ``calls`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        torch.cuda._sleep(500_000_000)  # ~0.3 s of device time
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(runs)[repeats // 2]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call, from CUDA events after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from tweediemix_tpu_torch.ops import cuda_build

    log(f"gpu: {gpu_name_and_power()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, together
        list(pool.map(cuda_build.build_library, KERNELS))
    for name in KERNELS:
        cuda_build.load_library(name)
    log(f"kernel build: {', '.join(KERNELS)} {time.perf_counter() - t0:.3f} s (nvcc, sm_90a)")
    for name in KERNELS:
        ptxas = cuda_build.BUILD_DIR / f"{name}.ptxas.txt"
        if ptxas.exists():
            log(ptxas.read_text().strip())


def phase_kernels() -> list:
    import torch
    import torch.nn.functional as F

    from tweediemix_tpu_torch.ops import flash_attention as flash_module
    from tweediemix_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    results = []
    for bh, sq, sk, dh in MAIN_SHAPES + EDGE_SHAPES + VIDEO_FLASH_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(bh * 7 + sq + sk + dh)
        q, k, v = (torch.randn((bh, s, dh), generator=gen, device="cuda").to(torch.bfloat16)
                   for s in (sq, sk, sk))
        out = flash_attention(q, k, v)
        ref = flash_attention_reference(q.float(), k.float(), v.float())  # fp32 output
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        if not torch.isfinite(out).all():
            fail(f"flash_attention non-finite output at {(bh, sq, sk, dh)}")
        big = sq * sk >= 1024 * 1024
        reps = 20 if big else 50
        ms = cuda_ms(lambda: flash_attention(q, k, v), reps)
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v), max(3, reps // 5))
        q4, k4, v4 = q[None], k[None], v[None]  # [1, BH, S, dh] reaches SDPA's fused kernels
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), reps)
        flops = 4.0 * bh * sq * sk * dh
        nbytes = 2.0 * bh * (2 * sq + 2 * sk) * dh
        t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_HBM_BYTES * 1e3
        # the softmax's floor, logged beside the bound: one exp2 per score on
        # the special-function units at the clock of the tensor peak (at dh 64
        # it equals the operations bound: 256 flops per score at 4096 per clock)
        exp2_ms = bh * sq * sk / (MUFU_EX2_PER_CLOCK_PER_SM * H100_SMS * H100_PEAK_CLOCK_HZ) * 1e3
        row = dict(shape=[bh, sq, sk, dh], max_abs_err=err, rel_err=rel, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   sdpa_ratio=ms / library_ms, tflops=flops / ms / 1e9)
        log(f"flash_attention {tuple(row['shape'])}: max_abs_err {err:.3e} rel_err {rel:.3e} "
            f"ms {ms:.4f} plain_ms {plain_ms:.4f} sdpa_ms {library_ms:.4f} (kernel/sdpa "
            f"{row['sdpa_ratio']:.3f}) bound_ms {row['bound_ms']:.4f} ({row['bound_by']}) "
            f"exp2_floor_ms {exp2_ms:.4f} {row['tflops']:.1f} TFLOP/s")
        if not rel <= FLASH_REL_TOL:
            fail(f"flash_attention disagrees with its plain version at {(bh, sq, sk, dh)}: "
                 f"max err / max |plain| = {rel:.3e} > {FLASH_REL_TOL}")
        results.append(row)
        del q, k, v, q4, k4, v4, out, ref
        torch.cuda.empty_cache()
    # host cost of one call: the wrapper, and its C entry point alone (three
    # tensor-map encodes and the launch), against one SDPA call
    q = torch.randn((1, 128, 64), device="cuda").to(torch.bfloat16)
    out = torch.empty_like(q)
    _, entry = flash_module._launcher()
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), 1, 128, 128, 64, 0.18, stream)
    host = dict(wrapper_us=host_us_per_call(lambda: flash_attention(q, q, q)),
                c_entry_us=host_us_per_call(lambda: entry(*args)),
                sdpa_us=host_us_per_call(lambda: F.scaled_dot_product_attention(q[None], q[None],
                                                                               q[None])))
    results[0]["host_cost"] = host
    log(f"flash_attention host cost per call while the device is busy (median of 5 x 200 calls): "
        f"wrapper {host['wrapper_us']:.2f} us, its C entry point {host['c_entry_us']:.2f} us, "
        f"SDPA {host['sdpa_us']:.2f} us")
    return results


def _exact_attention_chunked(q, k, v, rows=20):
    """fp32 attention in chunks of BH rows (the full score tensor at BH=160,
    4096² would take 10 GiB)."""
    import torch

    from tweediemix_tpu_torch.ops.flash_attention import flash_attention_reference

    return torch.cat([flash_attention_reference(q[i : i + rows].float(), k[i : i + rows].float(),
                                                v[i : i + rows].float())
                      for i in range(0, q.shape[0], rows)])


def phase_kernels_int8() -> list:
    import torch
    import torch.nn.functional as F

    from tweediemix_tpu_torch.ops import flash_attention as flash_module
    from tweediemix_tpu_torch.ops.flash_attention import (
        INT8_BLOCK_K,
        flash_attention_int8,
        flash_attention_int8_core,
        flash_attention_int8_core_reference,
        pack_v_int8,
        quantize_qkv_int8,
        quantize_qkv_int8_fused,
    )

    lib, _ = flash_module._launcher_int8()
    for dh, block in INT8_BLOCK_K.items():  # the plain version's block_k is the kernel's tile
        if lib.tm_int8_block_k(dh) != block:
            fail(f"int8 kernel tiles {lib.tm_int8_block_k(dh)} keys at dh {dh}, INT8_BLOCK_K {block}")
    results = []
    for bh, sq, sk, dh in INT8_MAIN_SHAPES + EDGE_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(bh * 11 + sq + sk + dh)
        q, k, v = (torch.randn((bh, s, dh), generator=gen, device="cuda").to(torch.bfloat16)
                   for s in (sq, sk, sk))
        block = INT8_BLOCK_K[dh]
        q8, k8, v8, scales = quantize_qkv_int8(q, k, v)
        qkv8 = (q8, k8, pack_v_int8(v8, block), scales)  # the plain quantise's kernel inputs
        fused = quantize_qkv_int8_fused(q, k, v)
        out = flash_attention_int8_core(*qkv8)
        plain = flash_attention_int8_core_reference(q8, k8, v8, scales, block)  # fp32 output
        wrapped = flash_attention_int8(q, k, v)
        torch.cuda.synchronize()
        quant_err = 0.0
        for name, want, have in zip(("q8", "k8", "vt8", "scales"), qkv8, fused):
            if not (have.shape == want.shape and torch.equal(have, want)):
                fail(f"fused int8 quantise's {name} differs from its plain version at "
                     f"{(bh, sq, sk, dh)}")
            quant_err = max(quant_err, (have.float() - want.float()).abs().max().item())
        if not torch.isfinite(out).all():
            fail(f"flash_attention_int8 non-finite output at {(bh, sq, sk, dh)}")
        if not torch.equal(out, wrapped):
            fail(f"flash_attention_int8's wrapper and its kernel disagree at {(bh, sq, sk, dh)}")
        err = (out.float() - plain).abs().max().item()
        rel = err / plain.abs().max().item()
        corr, rel_exact, l2_exact = _against_exact(out, q, k, v)
        big = sq * sk >= 1024 * 1024
        reps = 20 if big else 50
        ms = cuda_ms(lambda: flash_attention_int8_core(*qkv8), reps)
        quant_ms = cuda_ms(lambda: quantize_qkv_int8_fused(q, k, v), reps)
        wrapper_ms = cuda_ms(lambda: flash_attention_int8(q, k, v), reps)
        plain_ms = cuda_ms(lambda: flash_attention_int8_core_reference(q8, k8, v8, scales, block), 3)
        quant_plain_ms = cuda_ms(lambda: pack_v_int8(quantize_qkv_int8(q, k, v)[2], block), 3)
        q4, k4, v4 = q[None], k[None], v[None]
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), reps)
        ops = 4.0 * bh * sq * sk * dh
        nbytes = 1.0 * bh * (sq + 2 * sk) * dh + 2.0 * bh * sq * dh  # int8 q/k/v, bf16 o
        t_ops, t_bytes = ops / H100_INT8_OPS * 1e3, nbytes / H100_HBM_BYTES * 1e3
        scores = 1.0 * bh * sq * sk
        # the softmax's floors, logged beside the bound, at the clock of the
        # tensor peak: one exp2 per score on the special-function units, and
        # the kernel's instructions per score at four schedulers' issue rate
        exp2_ms = scores / (MUFU_EX2_PER_CLOCK_PER_SM * H100_SMS * H100_PEAK_CLOCK_HZ) * 1e3
        issue_ms = (scores * INT8_INSTR_PER_SCORE
                    / (ISSUE_PER_CLOCK_PER_SM * H100_SMS * H100_PEAK_CLOCK_HZ) * 1e3)
        # the quantise: bf16 q/k/v read once, int8 q8/k8 and padded V^T
        # written once (the two passes read the inputs twice)
        skp = -(-sk // block) * block
        q_in = 2.0 * bh * (sq + 2 * sk) * dh
        q_out = 1.0 * bh * (sq + sk) * dh + 1.0 * bh * dh * skp
        quant_bound_ms = (q_in + q_out) / H100_HBM_BYTES * 1e3
        quant_two_pass_ms = (2 * q_in + q_out) / H100_HBM_BYTES * 1e3
        row = dict(shape=[bh, sq, sk, dh], max_abs_err=err, rel_err=rel, corr_exact=corr,
                   rel_err_exact=rel_exact, l2_err_exact=l2_exact, ms=ms, wrapper_ms=wrapper_ms,
                   plain_ms=plain_ms, library_ms=None, sdpa_bf16_ms=sdpa_ms,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes", tops=ops / ms / 1e9,
                   quant_ms=quant_ms, quant_plain_ms=quant_plain_ms,
                   quant_bound_ms=quant_bound_ms, quant_max_abs_err=quant_err)
        log(f"flash_attention_int8 {tuple(row['shape'])}: max_abs_err {err:.3e} rel_err {rel:.3e} "
            f"vs exact corr {corr:.6f} rel {rel_exact:.3e} l2 {l2_exact:.3e}; ms {ms:.4f} wrapper_ms "
            f"{wrapper_ms:.4f} plain_ms {plain_ms:.4f} sdpa_bf16_ms {sdpa_ms:.4f} bound_ms "
            f"{row['bound_ms']:.4f} ({row['bound_by']}) exp2_floor_ms {exp2_ms:.4f} issue_floor_ms "
            f"{issue_ms:.4f} {row['tops']:.1f} TOP/s; fused quantise bitwise equal, ms "
            f"{quant_ms:.4f} plain_ms {quant_plain_ms:.4f} bound_ms {quant_bound_ms:.4f} "
            f"(two passes {quant_two_pass_ms:.4f})")
        if not rel <= FLASH_REL_TOL:
            fail(f"flash_attention_int8 disagrees with its plain version at {(bh, sq, sk, dh)}: "
                 f"max err / max |plain| = {rel:.3e} > {FLASH_REL_TOL}")
        if not (corr > INT8_EXACT_CORR and l2_exact < INT8_EXACT_L2):
            fail(f"flash_attention_int8 too far from exact attention at {(bh, sq, sk, dh)}: "
                 f"corr {corr:.6f}, L2 err / L2 {l2_exact:.3e}")
        results.append(row)
        del q, k, v, q4, k4, v4, q8, k8, v8, qkv8, fused, out, plain, wrapped
        torch.cuda.empty_cache()
    # host cost of one call: the wrapper (two quantise passes and the kernel)
    q = torch.randn((1, 128, 64), device="cuda").to(torch.bfloat16)
    host_us = host_us_per_call(lambda: flash_attention_int8(q, q, q))
    results[0]["host_us_per_call"] = host_us
    log(f"flash_attention_int8 host cost per call while the device is busy (median of 5 x 200 "
        f"calls): wrapper {host_us:.2f} us")
    for shape in INT8_JAX_TEST_SHAPES:  # the JAX package's test, on the card
        bh, sq, sk, dh = shape
        gen = torch.Generator(device="cuda").manual_seed(11)
        q, k, v = (torch.randn((bh, s, dh), generator=gen, device="cuda").to(torch.bfloat16)
                   for s in (sq, sk, sk))
        corr, rel_exact, l2_exact = _against_exact(flash_attention_int8(q, k, v), q, k, v)
        log(f"flash_attention_int8 {shape} vs exact (the JAX test's bounds): corr {corr:.6f} "
            f"rel {rel_exact:.3e} l2 {l2_exact:.3e}")
        if not (corr > INT8_EXACT_CORR and rel_exact < INT8_EXACT_REL):
            fail(f"flash_attention_int8 outside the JAX test's bounds at {shape}: "
                 f"corr {corr:.6f}, max err / max {rel_exact:.3e}")
    for bh, sq, sk, dh in INT8_LOUD_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(13)
        q, k, v = (torch.randn((bh, s, dh), generator=gen, device="cuda").mul(m).to(torch.bfloat16)
                   for s, m in ((sq, INT8_LOUD), (sk, INT8_LOUD), (sk, 1.0)))
        q8, k8, v8, scales = quantize_qkv_int8(q, k, v)
        plain = flash_attention_int8_core_reference(q8, k8, v8, scales, INT8_BLOCK_K[dh])
        rel = (flash_attention_int8(q, k, v).float() - plain).abs().max().item() / \
            plain.abs().max().item()
        log(f"flash_attention_int8 {(bh, sq, sk, dh)} q, k x {INT8_LOUD}: score scale "
            f"{scales[0].item():.4f}, max err / max |plain| {rel:.3e}")
        if not rel <= FLASH_REL_TOL:
            fail(f"flash_attention_int8 disagrees with its plain version on loud inputs at "
                 f"{(bh, sq, sk, dh)}: {rel:.3e} > {FLASH_REL_TOL}")
    return results


def _against_exact(out, q, k, v):
    """(corr, max err / max, L2 err / L2) of ``out`` against fp32 attention."""
    import torch

    e = _exact_attention_chunked(q, k, v).flatten()
    o = out.float().flatten()
    corr = torch.corrcoef(torch.stack([o, e]))[0, 1].item()
    return (corr, ((o - e).abs().max() / e.abs().max()).item(),
            ((o - e).norm() / e.norm()).item())


def _random_embeds(n_concepts, ctx_len, ctx_dim, pool_dim, device, seed):
    import torch

    from tweediemix_tpu_torch.fusion.sampler import TextEmbeds

    gen = torch.Generator(device="cpu").manual_seed(seed)

    def rows(n):
        return (0.1 * torch.randn((n, ctx_len, ctx_dim), generator=gen),
                0.1 * torch.randn((n, pool_dim), generator=gen))

    jc, jp = rows(2)
    sc, sp = rows(n_concepts - 1)
    cc, cp = rows(n_concepts + 1)
    return TextEmbeds(*(t.to(device) for t in (jc, jp, sc, sp, cc, cp)))


def _half_masks(n_concepts, h, w, device):
    import torch

    fg = torch.zeros((n_concepts - 1, h, w), device=device)
    fg[0, :, : w // 2] = 1.0
    fg[1, :, w // 2 :] = 1.0
    return fg


def phase_reference():
    """A small config whose self-attention reaches the kernel (1024 tokens,
    dh=64): the card (bf16, kernel) against the CPU (fp32, plain)."""
    import torch

    from tweediemix_tpu_torch.fusion.pipeline import TweedieMixPipeline
    from tweediemix_tpu_torch.fusion.sampler import FusionConfig
    from tweediemix_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
    from tweediemix_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention

    n = 3
    kw = dict(block_out_channels=(64, 128), num_attention_heads=(1, 2),
              cross_attention_dim=64, pooled_projection_dim=64, concept_slots=n + 1)
    fcfg = FusionConfig(n_timesteps=4, t_cond=0.5, resampling_steps=0, jumping_steps=1,
                        height=512, width=512, num_concepts=n)
    torch.manual_seed(1)
    unet_cpu = UNet2DConditionModel(UNetConfig.tiny(**kw), device="cpu")
    vae_cpu = AutoencoderKL(VAEConfig.tiny(), device="cpu")
    unet_gpu = UNet2DConditionModel(UNetConfig.tiny(dtype=torch.bfloat16, **kw), device="cuda")
    unet_gpu.load_state_dict(unet_cpu.state_dict())
    unet_cpu16 = UNet2DConditionModel(UNetConfig.tiny(dtype=torch.bfloat16, **kw), device="cpu")
    unet_cpu16.load_state_dict(unet_cpu.state_dict())
    vae_gpu = AutoencoderKL(VAEConfig.tiny(), device="cuda")
    vae_gpu.load_state_dict(vae_cpu.state_dict())

    h, w = fcfg.latent_hw
    gen = torch.Generator(device="cpu").manual_seed(2)
    x = torch.randn((2, h, w, 4), generator=gen)
    ctx = 0.2 * torch.randn((2, 9, 64), generator=gen)
    pooled = 0.2 * torch.randn((2, 64), generator=gen)
    tids = torch.tensor([[512.0, 512, 0, 0, 512, 512]]).expand(2, 6)
    idx = torch.tensor([0, 2])
    with torch.inference_mode():
        want = unet_cpu(x, 501, ctx, pooled, tids, idx)
        flash_attention.launches = 0
        got = unet_gpu(x.cuda(), 501, ctx.cuda(), pooled.cuda(), tids.cuda(), idx.cuda()).cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"reference: small UNet eps, card bf16 vs CPU fp32: max err / max |eps| = {rel:.3e} "
        f"(flash launches {flash_attention.launches})")
    sites = flash_sites_per_call(unet_gpu.config, (h, w))
    if sites == 0 or flash_attention.launches != sites or not rel <= EPS_REL_TOL:
        fail(f"small UNet on the card disagrees with the CPU: rel {rel:.3e}, "
             f"launches {flash_attention.launches}")

    embeds = _random_embeds(n, 9, 64, 64, "cpu", seed=3)
    embeds_gpu = embeds._replace(**{f: getattr(embeds, f).cuda() for f in embeds._fields})
    fg = _half_masks(n, fcfg.height, fcfg.width, "cpu")
    x_init = torch.randn((1, h, w, 4), generator=gen)

    def sample(unet, vae, cfg, device):
        pipe = TweedieMixPipeline(unet, vae, cfg, device=device)
        on_card = device == "cuda"
        img = pipe.sample(embeds_gpu if on_card else embeds, fg_masks=fg.to(device),
                          x_init=x_init.to(device))
        return pipe.last_latent.float().cpu(), img.float().cpu()

    def rel_err(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    lat_cpu, img_cpu = sample(unet_cpu, vae_cpu, fcfg, "cpu")
    lat_gpu, img_gpu = sample(unet_gpu, vae_gpu, fcfg, "cuda")
    rel = rel_err(lat_gpu, lat_cpu)
    img_err = (img_gpu - img_cpu).abs().max().item()
    log(f"reference: 4-step fusion sample, no resampling, card bf16 vs CPU fp32: latent "
        f"max err / max = {rel:.3e}, image max abs err {img_err:.3e}")
    if not rel <= SAMPLE_REL_TOL:
        fail(f"short fusion sample on the card disagrees with the CPU: {rel:.3e}")

    # the same sample with resampling, as the main path runs it; the plain
    # bf16 path on the CPU says how far bf16 alone carries it from fp32
    rcfg = dataclasses.replace(fcfg, resampling_steps=2)
    lat_cpu, _ = sample(unet_cpu, vae_cpu, rcfg, "cpu")
    lat_cpu16, _ = sample(unet_cpu16, vae_cpu, rcfg, "cpu")
    lat_gpu, _ = sample(unet_gpu, vae_gpu, rcfg, "cuda")
    rel_card, rel_plain = rel_err(lat_gpu, lat_cpu), rel_err(lat_cpu16, lat_cpu)
    log(f"reference: the same sample with resampling 2, latent max err / max against CPU "
        f"fp32: card bf16 (kernel) {rel_card:.3e}, CPU bf16 (plain) {rel_plain:.3e}")
    if not (math.isfinite(rel_card) and rel_card <= RESAMPLE_RATIO_TOL * rel_plain):
        fail(f"resampled sample on the card is {rel_card:.3e} from fp32, more than "
             f"{RESAMPLE_RATIO_TOL} x the plain bf16 path's {rel_plain:.3e}")


def phase_reference_w8a8() -> dict:
    """Small W8A8 UNets ("int8" and "int8_conv") with the int8 attention
    core, whose self-attention reaches the int8 kernel (1024 tokens, dh=64):
    the card (bf16) against the same int8 weights on the CPU (fp32), held
    against the plain bf16 W8A8 path's distance from the same CPU fp32 run."""
    import torch

    from tweediemix_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention, flash_attention_int8

    kw = dict(block_out_channels=(64, 128), num_attention_heads=(1, 2),
              cross_attention_dim=64, pooled_projection_dim=64, concept_slots=4)
    h = w = 64
    gen = torch.Generator(device="cpu").manual_seed(4)
    x = torch.randn((2, h, w, 4), generator=gen)
    ctx = 0.2 * torch.randn((2, 9, 64), generator=gen)
    pooled = 0.2 * torch.randn((2, 64), generator=gen)
    tids = torch.tensor([[512.0, 512, 0, 0, 512, 512]]).expand(2, 6)
    idx = torch.tensor([0, 2])
    args = (x, 501, ctx, pooled, tids, idx)
    out = {}
    os.environ["TWEEDIEMIX_FLASH_INT8"] = "1"
    try:
        for quant in ("int8", "int8_conv"):
            torch.manual_seed(5)
            cpu = UNet2DConditionModel(UNetConfig.tiny(quant=quant, **kw), device="cpu")
            cpu16 = UNet2DConditionModel(UNetConfig.tiny(quant=quant, dtype=torch.bfloat16, **kw),
                                         device="cpu")
            gpu = UNet2DConditionModel(UNetConfig.tiny(quant=quant, dtype=torch.bfloat16, **kw),
                                       device="cuda")
            cpu16.load_state_dict(cpu.state_dict())
            gpu.load_state_dict(cpu.state_dict())
            with torch.inference_mode():
                want = cpu(*args)
                plain16 = cpu16(*args)
                flash_attention.launches = flash_attention_int8.launches = 0
                got = gpu(*(a.cuda() if torch.is_tensor(a) else a for a in args)).cpu()
            scale = want.abs().max()
            rel_card = ((got - want).abs().max() / scale).item()
            rel_plain = ((plain16 - want).abs().max() / scale).item()
            sites = flash_sites_per_call(gpu.config, (h, w))
            launches = (flash_attention_int8.launches, flash_attention.launches)
            log(f"reference: small W8A8 UNet ({quant}, int8 core) eps, max err / max |eps| "
                f"against CPU fp32: card bf16 (kernels) {rel_card:.3e}, CPU bf16 (plain) "
                f"{rel_plain:.3e}; int8/bf16 flash launches {launches}")
            if not (torch.isfinite(got).all() and rel_card <= W8A8_RATIO_TOL * rel_plain):
                fail(f"small W8A8 UNet ({quant}) on the card is {rel_card:.3e} from the CPU, "
                     f"more than {W8A8_RATIO_TOL} x the plain bf16 path's {rel_plain:.3e}")
            if sites == 0 or launches != (sites, 0):
                fail(f"small W8A8 UNet ({quant}): int8/bf16 flash launches {launches}, "
                     f"expected ({sites}, 0)")
            out[quant] = dict(rel_card=rel_card, rel_plain_bf16=rel_plain)
    finally:
        os.environ.pop("TWEEDIEMIX_FLASH_INT8", None)
    return out


def flash_sites_per_call(ucfg, latent_hw) -> int:
    """Self-attentions of one UNet call that the dispatcher sends to the
    flash kernel."""
    from tweediemix_tpu_torch.models.unet2d import cross_attention_names
    from tweediemix_tpu_torch.ops.attention import uses_flash

    h, w = latent_hw
    sites = 0
    for level, _ in cross_attention_names(ucfg):
        tokens = (h >> level) * (w >> level)
        dh = ucfg.block_out_channels[level] // ucfg.num_attention_heads[level]
        if uses_flash(tokens, tokens, dh):
            sites += ucfg.transformer_layers_per_block[level]
    return sites


def expected_flash_launches(ucfg, fcfg) -> int:
    """Flash-kernel launches per image: kernel sites per UNet call × calls."""
    return flash_sites_per_call(ucfg, fcfg.latent_hw) * fcfg.unet_calls()


def phase_main_path() -> dict:
    import torch

    from tweediemix_tpu_torch.fusion.pipeline import TweedieMixPipeline
    from tweediemix_tpu_torch.fusion.sampler import FusionConfig
    from tweediemix_tpu_torch.models.unet2d import UNetConfig
    from tweediemix_tpu_torch.models.vae import VAEConfig
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention

    n = 3  # cat + dog + background
    ucfg = UNetConfig.sdxl(concept_slots=n + 1, dtype=torch.bfloat16)
    vcfg = VAEConfig.sdxl()
    fcfg = FusionConfig(n_timesteps=50, guidance_scale=0.8, t_cond=0.2, resampling_steps=10,
                        jumping_steps=5, height=1024, width=1024, num_concepts=n)
    expected = expected_flash_launches(ucfg, fcfg)
    if expected != 5250:
        fail(f"expected 5250 flash launches for this config, the config gives {expected}")

    t0 = time.perf_counter()
    pipe = TweedieMixPipeline.from_random_weights(ucfg, vcfg, fcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    log(f"main path: UNet {n_params / 1e9:.3f} B params bf16, built in "
        f"{time.perf_counter() - t0:.1f} s; {fcfg.unet_calls()} UNet calls per image")
    embeds = _random_embeds(n, 77, 2048, 1280, "cuda", seed=0)
    fg = _half_masks(n, fcfg.height, fcfg.width, "cuda")

    runs = []
    for run in range(2):
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        img = pipe.sample(embeds, seed=run, fg_masks=fg, num_seeds=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention.launches
        latent = pipe.last_latent
        stats = dict(
            s_per_image=wall, launches=launches,
            phases={k: round(v, 4) for k, v in pipe.phase_seconds.items()},
            max_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
            image_mean=img.float().mean().item(), latent_absmax=latent.abs().max().item(),
        )
        log(f"main path run {run}: {json.dumps(stats)}")
        if tuple(img.shape) != (1, 1024, 1024, 3):
            fail(f"image shape {tuple(img.shape)}")
        if not torch.isfinite(latent).all() or not torch.isfinite(img).all():
            fail("non-finite latent or image")
        if img.min().item() < 0.0 or img.max().item() > 1.0:
            fail("image outside [0, 1]")
        if launches != expected:
            fail(f"flash_attention launched {launches} times on the main path, expected {expected}")
        runs.append(stats)
    # the fp32 decode alone: its mid-block attention holds a 16384 x 16384
    # fp32 score matrix (1 GiB) and its softmax
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pipe.decode_final(pipe.last_latent)
    torch.cuda.synchronize()
    decode_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"decode peak above the resident weights and latent: {decode_gib:.3f} GiB")
    fcfg = pipe.fusion_config
    calls = {"fused_batch4": (embeds.concept_ctx, embeds.concept_pooled,
                              torch.arange(fcfg.num_concepts + 1, device="cuda")),
             "joint_batch2": (embeds.joint_ctx, embeds.joint_pooled,
                              torch.zeros(2, dtype=torch.long, device="cuda"))}
    profile = {label: profile_call(pipe, label, *call) for label, call in calls.items()}
    return dict(runs=runs, expected_launches=expected, decode_peak_gib=decode_gib, profile=profile)


# parameters of the published SDXL checkpoint (stabilityai/stable-diffusion-
# xl-base-1.0), per diffusers folder: the synthetic checkpoint must match them
SDXL_PUBLISHED_PARAMS = {"unet": 2_567_463_684, "text_encoder": 123_060_480,
                         "text_encoder_2": 694_659_840, "vae": 83_653_863}
CLI_CONCEPTS = (("cat", "<cat1>"), ("dog", "<dog1>"), ("mountain", "<mountain1>"))
CLI_DELTA_RANK = 16  # the third delta is stored as the compressed pair [u, v]
# the CLI phase's sampling flags: the main path's FusionConfig
CLI_FUSION = dict(n_timesteps=50, guidance_scale=0.8, t_cond=0.2, resampling_steps=10,
                  jumping_steps=5, height=1024, width=1024, num_concepts=3)
# both SDXL towers in bf16 on the card against the same towers in fp32 on
# the CPU, relative to max |ctx| and max |pooled|
TOWER_REL_TOL = 5e-2


def write_checkpoint_dir(root, configs, seed, device) -> dict:
    """A checkpoint directory in the diffusers layout with seeded random
    weights (torch's default initialisation of the port's modules, whose
    names are the diffusers names): every folder in fp16 but ``vae/``, in
    fp32 with a ``config.json``. ``configs`` maps each folder to its
    (module class, config). An I2VGen-XL UNet's spatial transformers hold
    their projections as diffusers does, 1x1 convolutions [O, I, 1, 1]; the
    towers carry the ``position_ids`` buffers older HF checkpoints hold.
    The fp16 files are named as the hub names its fp16 variant
    (``*.fp16.safetensors``). Returns {folder: parameters} and the bytes
    written."""
    import torch

    from tweediemix_tpu_torch.models.clip import CLIPVisionModel
    from tweediemix_tpu_torch.models.convert import checkpoint_state_dict, save_safetensors
    from tweediemix_tpu_torch.models.unet3d import UNet3DConditionModel

    torch.manual_seed(seed)
    counts, written = {}, 0
    for folder, (cls, cfg) in configs.items():
        os.makedirs(os.path.join(root, folder))
        dtype = torch.float32 if folder == "vae" else torch.float16
        state = checkpoint_state_dict(cls(dataclasses.replace(cfg, dtype=dtype), device=device))
        counts[folder] = sum(t.numel() for t in state.values())
        if cls is UNet3DConditionModel:
            for key, t in state.items():
                if ".attentions." in key and key.endswith(("proj_in.weight", "proj_out.weight")):
                    state[key] = t[:, :, None, None]
        if folder == "text_encoder":  # the buffer older HF checkpoints carry
            state["text_model.embeddings.position_ids"] = torch.arange(cfg.max_positions)[None]
        if cls is CLIPVisionModel:
            state["vision_model.embeddings.position_ids"] = torch.arange(cfg.num_patches + 1)[None]
        name = "diffusion_pytorch_model" if folder in ("unet", "vae") else "model"
        if dtype == torch.float16:
            name += ".fp16"
        written += save_safetensors(os.path.join(root, folder, f"{name}.safetensors"), state)
        del state
        if folder == "vae":
            with open(os.path.join(root, folder, "config.json"), "w") as f:
                json.dump({"_class_name": "AutoencoderKL", "scaling_factor": cfg.scaling_factor}, f)
    return dict(params=counts, bytes=written)


def write_tokenizers(root, vocab_size=49408) -> int:
    """``tokenizer/`` and ``tokenizer_2/`` with a synthetic CLIP vocabulary
    of ``vocab_size`` entries (the 256 bytes, each with ``</w>``, a few
    merges, filler, then ``<|startoftext|>`` and ``<|endoftext|>`` last);
    the second pads with "!", as SDXL's does. Returns the bytes written."""
    from tweediemix_tpu_torch.utils.tokenizer import bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": len(chars) + i for i, c in enumerate(chars)})
    merges = ["c a", "ca t</w>", "d o", "do g</w>", "o f</w>", "r u", "n n", "i n", "in g</w>"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    while len(vocab) < vocab_size - 2:
        vocab[f"<filler{len(vocab)}>"] = len(vocab)
    vocab["<|startoftext|>"] = vocab_size - 2
    vocab["<|endoftext|>"] = vocab_size - 1
    written = 0
    for folder, pad in (("tokenizer", "<|endoftext|>"), ("tokenizer_2", "!")):
        os.makedirs(os.path.join(root, folder))
        files = {"vocab.json": json.dumps(vocab), "merges.txt": "#version: 0.2\n" + "\n".join(merges),
                 "tokenizer_config.json": json.dumps({"pad_token": pad, "model_max_length": 77})}
        for name, text in files.items():
            with open(os.path.join(root, folder, name), "w", encoding="utf-8") as f:
                written += f.write(text)
    return written


def write_concept_deltas(root, unet_shapes, dims, seed, device) -> list:
    """One reference ``delta-*.bin`` per concept of ``CLI_CONCEPTS``: the K/V
    of every cross-attention (``unet_shapes``: {name: [out, in]}) and a
    modifier embedding per tower (``dims``), seeded; the last delta holds
    its K/V as the compressed pair [u, v]. Returns the paths."""
    import torch

    from tweediemix_tpu_torch.concepts.delta import is_cross_kv, save_reference_delta

    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, std=1.0):
        return (std * torch.randn(shape, generator=gen, device=device)).cpu()

    paths = []
    for i, (concept, token) in enumerate(CLI_CONCEPTS):
        unet = {}
        for name in filter(is_cross_kv, unet_shapes):
            out, inn = unet_shapes[name]
            if i == len(CLI_CONCEPTS) - 1:
                unet[name] = (randn(out, CLI_DELTA_RANK, std=CLI_DELTA_RANK**-0.5),
                              randn(CLI_DELTA_RANK, inn, std=(3 * inn) ** -0.5))
            else:
                unet[name] = randn(out, inn, std=(3 * inn) ** -0.5)
        path = os.path.join(root, f"delta-{concept}.bin")
        save_reference_delta(path, unet, {token: randn(dims[0])}, {token: randn(dims[1])})
        paths.append(path)
    return paths


def phase_cli(keep_png: str) -> dict:
    """The port's CLI from a full-width SDXL checkpoint directory and three
    concept deltas to one 1024² PNG (the main path's FusionConfig, masks
    from the heuristic segmenter at the boundary step), then its checks;
    then, from the same directory, ``phase_cli_segmentation``. The PNG is
    copied to ``keep_png`` for the video CLI (the directory is deleted)."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tweediemix_tpu_torch.cli import fusion_sampling
    from tweediemix_tpu_torch.concepts.delta import load_reference_delta
    from tweediemix_tpu_torch.fusion.pipeline import insert_modifier
    from tweediemix_tpu_torch.fusion.sampler import FusionConfig
    from tweediemix_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel, DualTextEncoder
    from tweediemix_tpu_torch.models.convert import checkpoint_shapes, load_clip_text_model
    from tweediemix_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
    from tweediemix_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention
    from tweediemix_tpu_torch.utils.image import read_png

    c1, c2 = CLIPTextConfig.sdxl_text_encoder(), CLIPTextConfig.sdxl_text_encoder_2()
    configs = {"unet": (UNet2DConditionModel, UNetConfig.sdxl()),
               "text_encoder": (CLIPTextModel, c1), "text_encoder_2": (CLIPTextModel, c2),
               "vae": (AutoencoderKL, VAEConfig.sdxl())}
    prompt = "photo of a cat running+photo of a dog running+mountain background"
    prompt_orig = "photo of a cat and a dog running"
    fcfg = FusionConfig(**CLI_FUSION)
    expected = expected_flash_launches(UNetConfig.sdxl(concept_slots=4, dtype=torch.bfloat16), fcfg)
    if expected != 5250:
        fail(f"expected 5250 flash launches on the CLI path, the config gives {expected}")

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="cli_sdxl_", dir=os.path.join(REPO, "build"))
    build_pipeline = fusion_sampling.build_pipeline
    try:
        t0 = time.perf_counter()
        ckpt = write_checkpoint_dir(root, configs, seed=0, device="cuda")
        if ckpt["params"] != SDXL_PUBLISHED_PARAMS:
            fail(f"checkpoint parameters {ckpt['params']} differ from SDXL's {SDXL_PUBLISHED_PARAMS}")
        written = ckpt["bytes"] + write_tokenizers(root)
        unet_shapes = checkpoint_shapes(UNet2DConditionModel(UNetConfig.sdxl(), device="meta"))
        deltas = write_concept_deltas(root, unet_shapes, (c1.hidden_size, c2.hidden_size),
                                      seed=1, device="cuda")
        written += sum(os.path.getsize(p) for p in deltas)
        write_s = time.perf_counter() - t0
        log(f"cli: wrote {written / 1e9:.3f} GB in {write_s:.1f} s: {json.dumps(ckpt['params'])}")
        torch.cuda.empty_cache()

        out = os.path.join(root, "out")
        argv = ["--model_dir", root, "--personal_checkpoint", "+".join(deltas), "--mode", "cd",
                "--prompt", prompt, "--prompt_orig", prompt_orig,
                "--concepts", "+".join(c for c, _ in CLI_CONCEPTS),
                "--modifier_token", "+".join(t for _, t in CLI_CONCEPTS),
                "--seg_concepts", "a cat+a dog", "--seed", "0", "--output_path", out,
                "--resolution_h", str(fcfg.height), "--resolution_w", str(fcfg.width)]
        for flag in ("n_timesteps", "t_cond", "resampling_steps", "jumping_steps", "guidance_scale"):
            argv += [f"--{flag}", str(getattr(fcfg, flag))]
        kept = {}

        def keep_pipeline(opt, device="cuda", timings=None):
            kept["pipe"] = build_pipeline(opt, device=device, timings=timings)
            return kept["pipe"]

        fusion_sampling.build_pipeline = keep_pipeline
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            rc = fusion_sampling.main(argv, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention.launches
        fusion_sampling.build_pipeline = build_pipeline
        log(stdout.getvalue().strip())
        if rc != 0:
            fail(f"the CLI returned {rc}")
        timings = json.loads(stdout.getvalue().split("timings: ", 1)[1].splitlines()[0])
        if launches != expected:
            fail(f"flash_attention launched {launches} times on the CLI path, expected {expected}")

        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        if pngs != [f"{prompt_orig}_0.png"]:
            fail(f"the CLI wrote {pngs}, expected one PNG")
        png_bytes = os.path.getsize(os.path.join(out, pngs[0]))
        ihdr, pixels = read_png(os.path.join(out, pngs[0]))
        pixels = pixels.reshape(fcfg.height, fcfg.width, -1)
        if ihdr != dict(width=fcfg.width, height=fcfg.height, bit_depth=8, color_type=2, interlace=0):
            fail(f"PNG header {ihdr}, expected {fcfg.width}x{fcfg.height} 8-bit RGB")
        if pixels.min() == pixels.max():
            fail("every pixel of the PNG is equal")
        shutil.copyfile(os.path.join(out, pngs[0]), keep_png)

        pipe = kept["pipe"]
        refs = [load_reference_delta(p) for p in deltas]
        token_ids = []
        for tok, model, coll in ((pipe.tokenizer_1, pipe.text.model1, "modifier_token"),
                                 (pipe.tokenizer_2, pipe.text.model2, "modifier_token_2")):
            table = model.text_model.embeddings.token_embedding.weight
            ids = [tok.convert_tokens_to_ids(t) for _, t in CLI_CONCEPTS]
            want_ids = [c1.vocab_size + i for i in range(len(CLI_CONCEPTS))]  # 49408-49410
            if ids != want_ids or table.shape[0] != want_ids[-1] + 1:
                fail(f"modifier ids {ids}, table rows {table.shape[0]}: expected {want_ids} "
                     f"of {want_ids[-1] + 1}")
            for tid, ref in zip(ids, refs):
                want = next(iter(ref[coll].values())).to(table.dtype)
                if not torch.equal(table[tid].cpu(), want):
                    fail(f"{coll} row {tid} differs from its delta's vector")
            token_ids.append(ids)

        # the seven prompts prepare_text_embeds encodes, through both towers
        # in bf16 on the card and in fp32 on the CPU (plain ops, no TF32)
        per_concept = [insert_modifier(p, c, t) for p, (c, t) in zip(prompt.split("+"), CLI_CONCEPTS)]
        prompts = ([fusion_sampling.build_parser().get_default("negative_prompt"), prompt_orig]
                   + prompt.split("+")[:2] + per_concept)
        ids1, ids2 = pipe.tokenizer_1(prompts), pipe.tokenizer_2(prompts)
        if token_ids[0][0] not in ids1[4] or token_ids[1][2] not in ids2[6]:
            fail("the modifier tokens are missing from the encoded prompts")
        t0 = time.perf_counter()
        ctx, pooled = pipe.text.encode_ids(ids1, ids2)
        torch.cuda.synchronize()
        towers_ms = (time.perf_counter() - t0) * 1e3
        cpu_text = DualTextEncoder(load_clip_text_model(os.path.join(root, "text_encoder"), c1, "cpu"),
                                   load_clip_text_model(os.path.join(root, "text_encoder_2"), c2, "cpu"))
        cpu_text.add_modifier_tokens(
            token_ids[0], [next(iter(r["modifier_token"].values())) for r in refs],
            token_ids[1], [next(iter(r["modifier_token_2"].values())) for r in refs])
        ctx_ref, pooled_ref = cpu_text.encode_ids(ids1, ids2)
        ctx_err = ((ctx.float().cpu() - ctx_ref).abs().max() / ctx_ref.abs().max()).item()
        pooled_err = ((pooled.float().cpu() - pooled_ref).abs().max() / pooled_ref.abs().max()).item()
        if not (torch.isfinite(ctx).all() and torch.isfinite(pooled).all()):
            fail("non-finite text embeddings")
        if (tuple(ctx.shape) != (7, 77, c1.hidden_size + c2.hidden_size)
                or tuple(pooled.shape) != (7, c2.projection_dim)):
            fail(f"text embeddings {tuple(ctx.shape)} / {tuple(pooled.shape)}")
        if ctx_err > TOWER_REL_TOL or pooled_err > TOWER_REL_TOL:
            fail(f"towers on the card vs fp32 on the CPU: ctx {ctx_err:.3e}, pooled "
                 f"{pooled_err:.3e} (limit {TOWER_REL_TOL})")
        stats = dict(
            gpu=gpu_name_and_power(), bytes_written=written, write_s=write_s,
            load_s=timings["load_s"], build_s=timings["build_s"], encode_s=timings["encode_s"],
            s_per_image=timings["sample_s"], phases=timings["phases"], cli_wall_s=wall,
            max_memory_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
            expected_launches=expected, png_bytes=png_bytes, pixel_mean=float(pixels.mean()),
            towers_ms=towers_ms, ctx_rel_err=ctx_err, pooled_rel_err=pooled_err,
            ctx_absmax=ctx_ref.abs().max().item(), pooled_absmax=pooled_ref.abs().max().item(),
        )
        log(f"cli path: {json.dumps(stats)}")
        del pipe, kept["pipe"], cpu_text, ctx, pooled
        torch.cuda.empty_cache()
        stats["segmentation"] = phase_cli_segmentation(root, argv, expected)
        torch.cuda.empty_cache()
        stats["train"] = phase_cli_train(root, argv, deltas)
        return stats
    finally:
        fusion_sampling.build_pipeline = build_pipeline
        shutil.rmtree(root)


# segment-anything's prompt-encoder tensors for point and mask prompts, which
# the port skips (sam_vit_h holds them; mask_in_chans 16)
SAM_PROMPT_EXTRAS = {
    "prompt_encoder.point_embeddings.0.weight": (1, 256),
    "prompt_encoder.point_embeddings.1.weight": (1, 256),
    "prompt_encoder.not_a_point_embed.weight": (1, 256),
    "prompt_encoder.mask_downscaling.0.weight": (4, 1, 2, 2), "prompt_encoder.mask_downscaling.0.bias": (4,),
    "prompt_encoder.mask_downscaling.1.weight": (4,), "prompt_encoder.mask_downscaling.1.bias": (4,),
    "prompt_encoder.mask_downscaling.3.weight": (16, 4, 2, 2), "prompt_encoder.mask_downscaling.3.bias": (16,),
    "prompt_encoder.mask_downscaling.4.weight": (16,), "prompt_encoder.mask_downscaling.4.bias": (16,),
    "prompt_encoder.mask_downscaling.6.weight": (256, 16, 1, 1), "prompt_encoder.mask_downscaling.6.bias": (256,),
}
# SAM and the detector on the card against the CPU, fp32: logits and block
# outputs relative to their largest magnitude
SEG_REL_TOL = 1e-4
SEG_CONCEPTS = "a cat+a dog"
# the --mask_dir sample: a short trajectory, the masks read from PNGs
MASK_DIR_FUSION = dict(n_timesteps=4, t_cond=0.5, resampling_steps=0, jumping_steps=1)


def sam_encoder_flops(cfg) -> dict:
    """Multiply-adds × 2 of one SAM image-encoder call, by part (the
    windowed blocks compute on the grid padded to whole windows)."""
    c, g, win = cfg.encoder_dim, cfg.grid, cfg.window_size
    padded = -(-g // win) * win
    out = dict(global_blocks=0.0, window_blocks=0.0)
    for i in range(cfg.encoder_layers):
        if i in cfg.global_attn_indexes:
            t, attn = g * g, 4 * (g * g) ** 2 * c + 2 * 2 * g * g * c * g
            key = "global_blocks"
        else:
            t = padded * padded
            attn = (padded // win) ** 2 * (4 * win**4 * c + 2 * 2 * win * win * c * win)
            key = "window_blocks"
        out[key] += 2 * t * c * 3 * c + 2 * t * c * c + attn + 2 * g * g * c * 8 * c
    p = cfg.prompt_dim
    out["embed_and_neck"] = (2 * g * g * 3 * cfg.patch_size**2 * c + 2 * g * g * c * p
                             + 2 * g * g * p * p * 9)
    out["total"] = sum(out.values())
    return out


def write_sam_checkpoint(path, seed, device) -> dict:
    """A segment-anything ViT-H checkpoint of seeded random weights
    (``lang_sam.seeded_init_``, the relative-position tables 0.02·N(0, 1)
    so that they act) under upstream's names, the point- and mask-prompt
    tensors included, written with ``torch.save`` as upstream ships it."""
    import torch

    from tweediemix_tpu_torch.segmentation.lang_sam import seeded_init_
    from tweediemix_tpu_torch.segmentation.sam import SAM, SAMConfig

    gen = torch.Generator(device=device).manual_seed(seed)
    sam = seeded_init_(SAM(SAMConfig.vit_h(), device=device), gen)
    with torch.no_grad():
        for name, t in sam.named_parameters():
            if "rel_pos" in name:
                t.copy_(0.02 * torch.randn(t.shape, generator=gen, device=device))
    state = {k: v.cpu() for k, v in sam.state_dict().items()}
    for k, shape in SAM_PROMPT_EXTRAS.items():
        state[k] = (0.02 * torch.randn(shape, generator=gen, device=device)).cpu()
    torch.save(state, path)
    return dict(params=sum(t.numel() for t in state.values()),
                port_params=sum(t.numel() for t in sam.state_dict().values()),
                bytes=os.path.getsize(path))


def write_owlvit_dir(root, seed, device) -> dict:
    """An HF ``OwlViTForObjectDetection`` directory (base-patch32) of seeded
    random weights: ``model.safetensors`` with the contrastive head and
    position-id buffers, and a synthetic 49408-entry tokenizer under
    ``tokenizer/``."""
    import torch

    from tweediemix_tpu_torch.models.convert import save_safetensors
    from tweediemix_tpu_torch.segmentation.detector import DetectorConfig, TextBoxDetector
    from tweediemix_tpu_torch.segmentation.lang_sam import seeded_init_

    cfg = DetectorConfig.owlvit_base_patch32()
    gen = torch.Generator(device=device).manual_seed(seed)
    det = seeded_init_(TextBoxDetector(cfg, device=device), gen)
    state = dict(det.state_dict())
    state["owlvit.logit_scale"] = torch.tensor(2.6592)
    state["owlvit.visual_projection.weight"] = 0.02 * torch.randn(
        (cfg.embed_dim, cfg.vision.hidden_size), generator=gen, device=device)
    state["owlvit.text_model.embeddings.position_ids"] = torch.arange(cfg.text.max_positions)[None]
    state["owlvit.vision_model.embeddings.position_ids"] = torch.arange(
        cfg.vision.num_patches + 1)[None]
    os.makedirs(root)
    written = save_safetensors(os.path.join(root, "model.safetensors"), state)
    written += write_tokenizers(root)
    return dict(params=sum(t.numel() for k, t in state.items() if not k.endswith("position_ids")),
                port_params=sum(t.numel() for t in det.state_dict().values()), bytes=written)


# bert-base-uncased's ids of the tokens GroundingDINO's phrase masks key on
# ([CLS], [SEP], ".", "?") and of the other special tokens
BERT_SPECIAL_IDS = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103,
                    ".": 1012, "?": 1029}
BERT_WORDS = ("a", "cat", "dog", "photo", "of", "and", "the", "running", "mountain", "background",
              "run", "##ning", "##s", ",", "!")
# GroundingDINO Swin-B's parameters (jax.eval_shape of the JAX package's tree)
DINO_SWINB_PARAMS = 232_313_216


def write_bert_vocab(path, size: int) -> int:
    """A synthetic uncased WordPiece ``vocab.txt`` of ``size`` lines:
    ``BERT_SPECIAL_IDS`` at bert-base-uncased's ids (else every phrase mask
    would be the identity), ``BERT_WORDS`` from id 1100 on, ``[unusedN]``
    elsewhere. Returns its bytes."""
    lines = [f"[unused{i}]" for i in range(size)]
    for token, i in BERT_SPECIAL_IDS.items():
        lines[i] = token
    for i, word in enumerate(BERT_WORDS):
        lines[1100 + i] = word
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return os.path.getsize(path)


def _dino_original_name(name: str) -> tuple:
    """A port ``GroundingDino`` name → (its original-layout name, the q/k/v
    part it fills of a merged tensor or None)."""
    m = re.match(r"backbone\.layers_(\d+)_blocks_(\d+)\.(.*)", name)
    if m:
        base, rest = f"backbone.0.layers.{m.group(1)}.blocks.{m.group(2)}.", m.group(3)
        q = re.match(r"attention\.(query|key|value)\.(weight|bias)$", rest)
        if q:
            return base + f"attn.qkv.{q.group(2)}", q.group(1)
        for old, new in (("layernorm_before.", "norm1."), ("layernorm_after.", "norm2."),
                         ("attention.out.", "attn.proj."),
                         ("attention.relative_position_bias_table", "attn.relative_position_bias_table"),
                         ("intermediate.", "mlp.fc1."), ("output.", "mlp.fc2.")):
            if rest.startswith(old):
                return base + new + rest[len(old):], None
    m = re.match(r"backbone\.norm_stage(\d)\.(.*)", name)
    if m:
        return f"backbone.0.norm{int(m.group(1)) - 1}.{m.group(2)}", None
    m = re.match(r"backbone\.layers_(\d+)_downsample\.(.*)", name)
    if m:
        return f"backbone.0.layers.{m.group(1)}.downsample.{m.group(2)}", None
    for old, new in (("backbone.patch_embed.", "backbone.0.patch_embed.proj."),
                     ("backbone.patch_norm.", "backbone.0.patch_embed.norm."),
                     ("text_projection.", "feat_map."), ("level_embed", "transformer.level_embed"),
                     ("query_position_embeddings.", "transformer.tgt_embed."),
                     ("enc_output.", "transformer.enc_output."),
                     ("enc_output_norm.", "transformer.enc_output_norm."),
                     ("decoder_layer_norm.", "transformer.decoder.norm.")):
        if name.startswith(old):
            return new + name[len(old):], None
    for old, new in (("encoder_output_bbox_embed.", "transformer.enc_out_bbox_embed."),
                     ("reference_points_head.", "transformer.decoder.ref_point_head.")):
        if name.startswith(old):
            return new + re.sub(r"layers_(\d+)", r"layers.\1", name[len(old):]), None
    m = re.match(r"input_proj_(\d+)_(conv|norm)\.(.*)", name)
    if m:
        return f"input_proj.{m.group(1)}.{0 if m.group(2) == 'conv' else 1}.{m.group(3)}", None
    m = re.match(r"text_backbone\.(.*)", name)
    if m:
        rest = m.group(1)
        if rest in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
            return f"bert.embeddings.{rest}.weight", None
        if rest.startswith("embeddings_norm."):
            return "bert.embeddings.LayerNorm." + rest[len("embeddings_norm."):], None
        m = re.match(r"layer_(\d+)\.(\w+)\.(weight|bias)$", rest)
        part = {"query": "attention.self.query", "key": "attention.self.key",
                "value": "attention.self.value", "attn_out": "attention.output.dense",
                "attn_norm": "attention.output.LayerNorm", "intermediate": "intermediate.dense",
                "output": "output.dense", "output_norm": "output.LayerNorm"}[m.group(2)]
        return f"bert.encoder.layer.{m.group(1)}.{part}.{m.group(3)}", None
    m = re.match(r"encoder_layers_(\d+)\.(\w+)\.(.*)", name)
    if m:
        i, sub, rest = m.groups()
        if sub == "deformable_layer":
            for old, new in (("fc1.", "linear1."), ("fc2.", "linear2."),
                             ("self_attn_layer_norm.", "norm1."), ("final_layer_norm.", "norm2.")):
                rest = new + rest[len(old):] if rest.startswith(old) else rest
            return f"transformer.encoder.layers.{i}.{rest}", None
        if sub == "text_enhancer_layer":
            q = re.match(r"self_attn\.(query|key|value)\.(weight|bias)$", rest)
            if q:
                return f"transformer.encoder.text_layers.{i}.self_attn.in_proj_{q.group(2)}", q.group(1)
            for old, new in (("fc1.", "linear1."), ("fc2.", "linear2."),
                             ("layer_norm_before.", "norm1."), ("layer_norm_after.", "norm2.")):
                rest = new + rest[len(old):] if rest.startswith(old) else rest
            return f"transformer.encoder.text_layers.{i}.{rest}", None
        for old, new in (("vision_param", "gamma_v"), ("text_param", "gamma_l"),
                         ("layer_norm_vision.", "layer_norm_v."), ("layer_norm_text.", "layer_norm_l."),
                         ("attn.values_vision_proj.", "attn.values_v_proj."),
                         ("attn.values_text_proj.", "attn.values_l_proj."),
                         ("attn.out_vision_proj.", "attn.out_v_proj."),
                         ("attn.out_text_proj.", "attn.out_l_proj."),
                         ("attn.vision_proj.", "attn.v_proj."), ("attn.text_proj.", "attn.l_proj.")):
            rest = new + rest[len(old):] if rest.startswith(old) else rest
        return f"transformer.encoder.fusion_layers.{i}.{rest}", None
    m = re.match(r"decoder_layers_(\d+)\.(.*)", name)
    if m:
        i, rest = m.groups()
        q = re.match(r"(self_attn|encoder_attn_text)\.(query|key|value)\.(weight|bias)$", rest)
        if q:
            mod = "self_attn" if q.group(1) == "self_attn" else "ca_text"
            return f"transformer.decoder.layers.{i}.{mod}.in_proj_{q.group(3)}", q.group(2)
        for old, new in (("encoder_attn_text.", "ca_text."),
                         ("encoder_attn_text_layer_norm.", "catext_norm."),
                         ("encoder_attn_layer_norm.", "norm1."), ("encoder_attn.", "cross_attn."),
                         ("self_attn_layer_norm.", "norm2."), ("final_layer_norm.", "norm3."),
                         ("fc1.", "linear1."), ("fc2.", "linear2.")):
            if rest.startswith(old):
                rest = new + rest[len(old):]
                break
        return f"transformer.decoder.layers.{i}.{rest}", None
    raise ValueError(f"{name}: no original GroundingDINO name")


def dino_original_state_dict(module) -> dict:
    """A ``GroundingDino``'s tensors in the original groundingdino repo's
    layout (the reference's ``groundingdino_swinb_cogcoor.pth`` holds it
    under ``"model"``), the inverse of ``load_dino``'s reading of it: each
    Swin block's q/k/v merged into ``attn.qkv``, the text and decoder
    attentions' into ``in_proj_weight``/``in_proj_bias``, the shared box
    head as every decoder layer's ``bbox_embed.{i}`` and
    ``transformer.decoder.bbox_embed.{i}``, and the buffers upstream holds
    (each block's ``relative_position_index``, BERT's ``position_ids``)."""
    import torch

    from tweediemix_tpu_torch.models.swin import _rel_pos_index

    cfg = module.config
    out, merged = {}, {}
    for name, t in module.state_dict().items():
        if name.startswith("bbox_embed."):
            continue
        orig, part = _dino_original_name(name)
        if part is None:
            out[orig] = t
        else:
            merged.setdefault(orig, {})[part] = t
    for orig, parts in merged.items():
        out[orig] = torch.cat([parts[p] for p in ("query", "key", "value")], dim=0)
    for name, t in module.bbox_embed.state_dict().items():
        leaf = re.sub(r"layers_(\d+)", r"layers.\1", name)
        for i in range(cfg.decoder_layers):
            out[f"bbox_embed.{i}.{leaf}"] = t
            out[f"transformer.decoder.bbox_embed.{i}.{leaf}"] = t
    index = torch.from_numpy(_rel_pos_index(cfg.swin.window_size))
    for i, depth in enumerate(cfg.swin.depths):
        for j in range(depth):
            out[f"backbone.0.layers.{i}.blocks.{j}.attn.relative_position_index"] = index
    out["bert.embeddings.position_ids"] = torch.arange(cfg.text.max_position_embeddings)[None]
    return out


def write_dino_checkpoint(path, config, seed, device) -> dict:
    """A GroundingDINO checkpoint of seeded random weights
    (``lang_sam.seeded_init_``: norms 1 and 0, matrices N(0, 1/fan_in),
    tables and layer scales N(0, 0.02²)) in the original groundingdino
    repo's layout (``dino_original_state_dict``: merged q/k/v, the
    box head under every decoder layer, the buffers), saved as upstream
    ships it (``{"model": state_dict}``), with a synthetic ``vocab.txt`` of
    ``config.text.vocab_size`` lines beside it."""
    import torch

    from tweediemix_tpu_torch.models.dino import GroundingDino
    from tweediemix_tpu_torch.segmentation.lang_sam import seeded_init_

    gen = torch.Generator(device=device).manual_seed(seed)
    model = seeded_init_(GroundingDino(config, device=device), gen)
    state = {k: v.cpu() for k, v in dino_original_state_dict(model).items()}
    torch.save({"model": state}, path)
    vocab_bytes = write_bert_vocab(os.path.join(os.path.dirname(path), "vocab.txt"), config.text.vocab_size)
    return dict(params=sum(t.numel() for t in model.parameters()), file_tensors=len(state),
                bytes=os.path.getsize(path) + vocab_bytes)


def run_cli(main, argv):
    """``main(argv, device="cuda")`` with its standard output captured:
    (return code, output, wall seconds ending in a device synchronise)."""
    import contextlib
    import io

    import torch

    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(stdout.getvalue().strip())
    return rc, stdout.getvalue(), wall


def _flag(argv, name, value):
    """``argv`` with ``--name``'s value replaced (appended where absent)."""
    argv = list(argv)
    if f"--{name}" in argv:
        argv[argv.index(f"--{name}") + 1] = str(value)
    else:
        argv += [f"--{name}", str(value)]
    return argv


def _segment_files_and_mask_dir(root, argv, masks_dir, rc) -> dict:
    """Checks the segment CLI's mask PNGs, then runs the fusion CLI's short
    ``--mask_dir`` sample on them."""
    from tweediemix_tpu_torch.cli import fusion_sampling
    from tweediemix_tpu_torch.utils.image import read_png

    if rc != 0:
        fail(f"the segment CLI returned {rc}")
    mask_areas = []
    for name in SEG_CONCEPTS.split("+"):
        header, mask = read_png(os.path.join(masks_dir, f"{name}.png"))
        if (header["width"], header["height"], header["color_type"]) != (1024, 1024, 0):
            fail(f"{name}.png: {header}")
        if not set(mask.reshape(-1).tolist()) <= {0, 255}:
            fail(f"{name}.png holds values other than 0 and 255")
        mask_areas.append(float((mask > 0).mean()))
    short = os.path.join(root, "out_mask_dir")
    mask_argv = _flag(argv, "output_path", short) + ["--mask_dir", masks_dir]
    for flag, value in MASK_DIR_FUSION.items():
        mask_argv = _flag(mask_argv, flag, value)
    rc, text, mask_wall = run_cli(fusion_sampling.main, mask_argv)
    if rc != 0 or "segmentation: " in text:
        fail(f"the --mask_dir run returned {rc} or segmented")
    pngs = [f for f in os.listdir(short) if f.endswith(".png")]
    if len(pngs) != 1 or read_png(os.path.join(short, pngs[0]))[0]["width"] != 1024:
        fail(f"the --mask_dir run wrote {pngs}")
    return dict(segment_cli_mask_areas=mask_areas, mask_dir_wall_s=mask_wall,
                mask_dir_sample_s=json.loads(text.split("timings: ", 1)[1].splitlines()[0])["sample_s"])


def phase_cli_segmentation(root, argv, expected) -> dict:
    """Text-guided segmentation in the fusion CLI at full width, from the
    SDXL directory of ``phase_cli`` (``argv``: its flags): a SAM ViT-H
    checkpoint and an OWL-ViT base-patch32 directory of seeded random
    weights are written under ``root``; the fusion CLI runs with
    ``--sam_checkpoint``/``--detector_dir`` (the ``sam`` preset: SAM and the
    detector at the boundary step) to one 1024² PNG; the segment CLI writes
    a mask PNG per concept from that PNG; the fusion CLI reads them back
    through ``--mask_dir`` for a short sample. Then SAM's encoder, the
    detector and the decoder are timed on the card, and one global and one
    windowed ViT-H block from the checkpoint are held to the CPU in fp32."""
    import copy
    import importlib.util

    import torch

    from tweediemix_tpu_torch.cli import fusion_sampling, segment
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention
    from tweediemix_tpu_torch.segmentation.lang_sam import LangSAM
    from tweediemix_tpu_torch.utils.image import read_png

    sam_path = os.path.join(root, "sam_vit_h.pth")
    det_dir = os.path.join(root, "owlvit-base-patch32")
    t0 = time.perf_counter()
    sam_ckpt = write_sam_checkpoint(sam_path, seed=2, device="cuda")
    det_ckpt = write_owlvit_dir(det_dir, seed=3, device="cuda")
    write_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f"segmentation: wrote SAM ViT-H {json.dumps(sam_ckpt)} and OWL-ViT {json.dumps(det_ckpt)} "
        f"in {write_s:.1f} s")

    # 1. the fusion CLI with real segmentation weights: the preset resolves to sam
    out = os.path.join(root, "out_sam")
    seg_argv = _flag(argv, "output_path", out) + ["--sam_checkpoint", sam_path, "--detector_dir", det_dir]
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    rc, text, wall = run_cli(fusion_sampling.main, seg_argv)
    launches = flash_attention.launches
    if rc != 0:
        fail(f"the CLI with --sam_checkpoint/--detector_dir returned {rc}")
    if launches != expected:
        fail(f"flash_attention launched {launches} times on the CLI's sam path, expected {expected}")
    timings = json.loads(text.split("timings: ", 1)[1].splitlines()[0])
    seg = json.loads(text.split("segmentation: ", 1)[1].splitlines()[0])
    if not timings.get("segment_s") or not timings.get("seg_load_s"):
        fail(f"the sam path's timings lack segment_s/seg_load_s: {timings}")
    if [c for c, _ in seg["top_scores"]] != SEG_CONCEPTS.split("+") or len(seg["mask_areas"]) != 2:
        fail(f"segmentation line {seg}")
    if not all(0.0 <= a <= 1.0 for a in seg["mask_areas"]):
        fail(f"mask areas {seg['mask_areas']}")
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    if len(pngs) != 1:
        fail(f"the sam path wrote {pngs}, expected one PNG")
    image_png = os.path.join(out, pngs[0])
    header, pixels = read_png(image_png)
    if (header["width"], header["height"], header["color_type"]) != (1024, 1024, 2) or pixels.min() == pixels.max():
        fail(f"the sam path's PNG: {header}, pixels {pixels.min()}..{pixels.max()}")
    fusion = dict(cli_wall_s=wall, load_s=timings["load_s"], seg_load_s=timings["seg_load_s"],
                  build_s=timings["build_s"], s_per_image=timings["sample_s"],
                  segment_s=timings["segment_s"], phases=timings["phases"], launches=launches,
                  max_memory_gib=torch.cuda.max_memory_allocated() / 2**30, **seg)
    log(f"segmentation fusion cli: {json.dumps(fusion)}")

    # 2. the segment CLI on that PNG, then --mask_dir reads its masks back,
    # both with PIL made unimportable (the files are PNGs the port reads)
    pil_installed = importlib.util.find_spec("PIL") is not None
    saved_pil = {k: sys.modules.pop(k) for k in list(sys.modules) if k == "PIL" or k.startswith("PIL.")}
    sys.modules["PIL"] = None
    try:
        masks_dir = os.path.join(root, "masks")
        rc, _, seg_wall = run_cli(segment.main, [
            "--input_path", image_png, "--text_condition", SEG_CONCEPTS, "--output_path", masks_dir,
            "--seg_preset", "sam", "--sam_checkpoint", sam_path, "--detector_dir", det_dir])
        files = _segment_files_and_mask_dir(root, argv, masks_dir, rc)
    finally:
        del sys.modules["PIL"]
        sys.modules.update(saved_pil)
    files.update(segment_cli_wall_s=seg_wall, pil_installed=pil_installed, pil_blocked=True)
    log(f"segmentation files: {json.dumps(files)}")

    # 3. the stage's layers on the card, and two full-width blocks against the CPU
    ls = LangSAM.from_pretrained(sam_path, det_dir, device="cuda")
    sam, cfg = ls.sam, ls.sam.config
    gen = torch.Generator(device="cuda").manual_seed(4)
    image = torch.rand((1024, 1024, 3), generator=gen, device="cuda")
    pixels = torch.randn((1, 1024, 1024, 3), generator=gen, device="cuda")
    det_pixels = torch.randn((1, 768, 768, 3), generator=gen, device="cuda")
    ids = torch.tensor(ls.tokenizer(["a cat"]), device="cuda")
    tokens = torch.randn((1, cfg.grid, cfg.grid, cfg.encoder_dim), generator=gen, device="cuda")
    with torch.inference_mode():
        feats = sam.encode_image(pixels)
        boxes, _ = ls.detector(det_pixels, ids)
        layers = dict(
            sam_encoder_ms=cuda_ms(lambda: sam.encode_image(pixels), 3),
            sam_decoder_8_boxes_ms=cuda_ms(lambda: sam.decode_boxes(feats, boxes), 5),
            detector_ms=cuda_ms(lambda: ls.detector(det_pixels, ids), 5),
            predict_ms=cuda_ms(lambda: ls.predict(image, "a cat"), 3),
            global_block_ms=cuda_ms(lambda: sam.image_encoder.blocks[cfg.global_attn_indexes[0]](tokens), 3),
            window_block_ms=cuda_ms(lambda: sam.image_encoder.blocks[0](tokens), 3),
        )
        flops = sam_encoder_flops(cfg)
        layers["sam_encoder_tflops"] = flops["total"] / 1e12
        layers["sam_encoder_tflop_per_s"] = flops["total"] / (layers["sam_encoder_ms"] * 1e-3) / 1e12
        blocks = {}
        x = torch.randn((1, cfg.grid, cfg.grid, cfg.encoder_dim), generator=gen, device="cuda")
        for kind, idx in (("global", cfg.global_attn_indexes[0]), ("window", 0)):
            block = sam.image_encoder.blocks[idx]
            got = block(x).cpu()
            want = copy.deepcopy(block).cpu()(x.cpu())
            err = ((got - want).abs().max() / want.abs().max()).item()
            blocks[kind] = dict(block=idx, rel_err=err, absmax=want.abs().max().item())
            if not torch.isfinite(got).all() or err > SEG_REL_TOL:
                fail(f"ViT-H {kind} block {idx} on the card vs fp32 on the CPU: {err:.3e} "
                     f"(limit {SEG_REL_TOL})")
    layers["blocks_card_vs_cpu"] = blocks
    layers["sam_encoder_flops_by_part"] = flops
    log(f"segmentation layers: {json.dumps(layers)}")
    del ls, sam, feats
    torch.cuda.empty_cache()
    dino = phase_cli_dino(root, argv, expected, sam_path)
    return dict(gpu=gpu_name_and_power(), write_s=write_s, sam_checkpoint=sam_ckpt,
                detector_checkpoint=det_ckpt, fusion=fusion, files=files, layers=layers, dino=dino)


def _rel_err(got, want) -> float:
    return ((got.float().cpu() - want).abs().max() / want.abs().max()).item()


def phase_cli_dino(root, argv, expected, sam_path) -> dict:
    """GroundingDINO in both CLIs at full width, from the SDXL directory and
    the SAM ViT-H checkpoint of ``phase_cli_segmentation``: a Swin-B
    GroundingDINO ``.pth`` of seeded random weights in the original repo's
    layout (its parameters held to ``DINO_SWINB_PARAMS``) and a synthetic
    30522-line ``vocab.txt`` are written under ``root``; the fusion CLI runs
    with ``--detector_dir`` on it and ``--detector dino``, then ``auto``,
    each to one 1024² PNG with the bf16 kernel's launches counted; the
    segment CLI writes a mask PNG per concept with ``--detector dino``.
    Then one ``DinoDetector`` call is timed with CUDA events, split into
    backbone (and level projections), text, encoder and decoder, with its
    peak memory, and one Swin-B stage-3 block, one encoder layer and one
    decoder layer from the checkpoint are held to the CPU in fp32."""
    import torch

    from tweediemix_tpu_torch.cli import fusion_sampling
    from tweediemix_tpu_torch.models.dino import DinoConfig
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention
    from tweediemix_tpu_torch.utils.image import read_png

    cfg = DinoConfig.swin_b()
    det_dir = os.path.join(root, "groundingdino")
    os.makedirs(det_dir)
    pth = os.path.join(det_dir, "groundingdino_swinb_cogcoor.pth")
    t0 = time.perf_counter()
    ckpt = write_dino_checkpoint(pth, cfg, seed=5, device="cuda")
    write_s = time.perf_counter() - t0
    if ckpt["params"] != DINO_SWINB_PARAMS:
        fail(f"GroundingDINO Swin-B holds {ckpt['params']} parameters, expected {DINO_SWINB_PARAMS}")
    torch.cuda.empty_cache()
    log(f"dino: wrote {json.dumps(ckpt)} in {write_s:.1f} s")

    # 1. the fusion CLI with GroundingDINO asked for, then found by auto
    runs = {}
    for detector in ("dino", "auto"):
        out = os.path.join(root, f"out_{detector}")
        seg_argv = _flag(argv, "output_path", out) + [
            "--sam_checkpoint", sam_path, "--detector_dir", pth, "--detector", detector]
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        rc, text, wall = run_cli(fusion_sampling.main, seg_argv)
        launches = flash_attention.launches
        if rc != 0:
            fail(f"the CLI with --detector {detector} returned {rc}")
        if launches != expected:
            fail(f"flash_attention launched {launches} times with --detector {detector}, expected {expected}")
        timings = json.loads(text.split("timings: ", 1)[1].splitlines()[0])
        seg = json.loads(text.split("segmentation: ", 1)[1].splitlines()[0])
        if [c for c, _ in seg["top_scores"]] != SEG_CONCEPTS.split("+") or len(seg["mask_areas"]) != 2:
            fail(f"--detector {detector}: segmentation line {seg}")
        if not all(0.0 <= v <= 1.0 for v in seg["mask_areas"] + [s for _, s in seg["top_scores"]]):
            fail(f"--detector {detector}: scores or mask areas outside [0, 1]: {seg}")
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        if len(pngs) != 1:
            fail(f"--detector {detector} wrote {pngs}, expected one PNG")
        header, pixels = read_png(os.path.join(out, pngs[0]))
        if ((header["width"], header["height"], header["color_type"]) != (1024, 1024, 2)
                or pixels.min() == pixels.max()):
            fail(f"--detector {detector}: PNG {header}, pixels {pixels.min()}..{pixels.max()}")
        runs[detector] = dict(cli_wall_s=wall, load_s=timings["load_s"], seg_load_s=timings["seg_load_s"],
                              build_s=timings["build_s"], s_per_image=timings["sample_s"],
                              segment_s=timings["segment_s"], launches=launches,
                              max_memory_gib=torch.cuda.max_memory_allocated() / 2**30, **seg)
        log(f"dino fusion cli --detector {detector}: {json.dumps(runs[detector])}")
    image_png = os.path.join(root, "out_dino", sorted(os.listdir(os.path.join(root, "out_dino")))[0])
    segment_cli = dino_segment_cli(os.path.join(root, "masks_dino"), image_png, sam_path, pth)
    layers, blocks = dino_layers(sam_path, pth)
    return dict(write_s=write_s, checkpoint=ckpt, fusion=runs, segment_cli=segment_cli, layers=layers,
                blocks_card_vs_cpu=blocks)


def dino_segment_cli(masks_dir, image_png, sam_path, pth) -> dict:
    """The segment CLI with ``--detector dino`` on a 1024² PNG: one 1024²
    mask PNG of 0 and 255 per concept."""
    import numpy as np

    from tweediemix_tpu_torch.cli import segment
    from tweediemix_tpu_torch.utils.image import read_png

    rc, _, wall = run_cli(segment.main, [
        "--input_path", image_png, "--text_condition", SEG_CONCEPTS, "--output_path", masks_dir,
        "--seg_preset", "sam", "--sam_checkpoint", sam_path, "--detector_dir", pth, "--detector", "dino"])
    if rc != 0:
        fail(f"the segment CLI with --detector dino returned {rc}")
    mask_areas = []
    for name in SEG_CONCEPTS.split("+"):
        header, mask = read_png(os.path.join(masks_dir, f"{name}.png"))
        if (header["width"], header["height"], header["color_type"]) != (1024, 1024, 0):
            fail(f"--detector dino {name}.png: {header}")
        if not set(np.unique(mask).tolist()) <= {0, 255}:
            fail(f"--detector dino {name}.png holds values other than 0 and 255")
        mask_areas.append(float((mask > 0).mean()))
    out = dict(wall_s=wall, mask_areas=mask_areas)
    log(f"dino segment cli: {json.dumps(out)}")
    return out


def dino_layers(sam_path, pth):
    """``LangSAM.from_pretrained(detector="dino")`` from the checkpoints;
    one ``DinoDetector`` call on a 1024² image timed with CUDA events (and
    the host clock), split into backbone, backbone with the level
    projections, text, encoder and decoder, with its peak memory; then one
    Swin-B stage-3 block (a shifted one), one encoder layer and one decoder
    layer held to fp32 on the CPU within ``SEG_REL_TOL`` of their max; one
    call under torch.profiler (device time by kernel class, idle share).
    Returns (layers, blocks)."""
    import copy

    import numpy as np
    import torch

    from tweediemix_tpu_torch.models.dino import (
        generate_special_token_masks,
        get_sine_pos_embed,
        preprocess_caption,
    )
    from tweediemix_tpu_torch.segmentation.lang_sam import LangSAM

    ls = LangSAM.from_pretrained(sam_path, pth, detector="dino", device="cuda")
    det, model, cfg = ls.dino, ls.dino.model, ls.dino.config
    del ls
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(6)
    size = cfg.swin.image_size
    image = torch.rand((1024, 1024, 3), generator=gen, device="cuda")
    pixels = torch.randn((1, size, size, 3), generator=gen, device="cuda")
    ids = np.asarray(det.tokenizer([preprocess_caption("a cat")]))
    attend, pos = generate_special_token_masks(ids)
    ids_t, attend_t, pos_t, tok_t = (torch.from_numpy(a).cuda() for a in (ids, attend, pos, ids != 0))
    blocks = {}
    with torch.inference_mode():
        weights = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det(image, "a cat")
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        text, text_pos = model.encode_text(ids_t, attend_t, pos_t)
        vision, vision_pos, shapes = model.encode_image(pixels)
        enc_vision, enc_text = model.encode(vision, text, vision_pos, text_pos, shapes, attend_t, tok_t)
        t0 = time.perf_counter()
        for _ in range(5):
            det(image, "a cat")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 5 * 1e3
        layers = dict(
            gpu=gpu_name_and_power(), caption_tokens=int(ids.shape[1]), levels=shapes,
            detector_ms=cuda_ms(lambda: det(image, "a cat"), 10), detector_wall_ms=wall_ms,
            detector_first_wall_ms=first_ms,
            backbone_ms=cuda_ms(lambda: model.backbone(pixels), 5),
            backbone_and_levels_ms=cuda_ms(lambda: model.encode_image(pixels), 5),
            text_ms=cuda_ms(lambda: model.encode_text(ids_t, attend_t, pos_t), 5),
            encoder_ms=cuda_ms(lambda: model.encode(vision, text, vision_pos, text_pos, shapes,
                                                    attend_t, tok_t), 5),
            decoder_ms=cuda_ms(lambda: model.decode(enc_vision, enc_text, shapes, tok_t), 5),
            weights_gib=weights / 2**30, peak_gib=peak / 2**30, call_gib=(peak - weights) / 2**30,
        )
        log(f"dino layers: {json.dumps(layers)}")
    layers["profile"] = profile_fn("dino detector call", lambda: det(image, "a cat"))
    with torch.inference_mode():
        n = vision.shape[1]
        refs = model.geometry(shapes, vision.device)["refs"][None, :, None, :].expand(1, n, len(shapes), 2)
        box = torch.sigmoid(torch.randn((1, cfg.num_queries, 4), generator=gen, device="cuda"))
        query_pos = model.reference_points_head(get_sine_pos_embed(box, cfg.d_model // 2))
        additive = torch.where(tok_t[:, None, None, :], 0.0, torch.finfo(torch.float32).min)
        cases = {
            "swin_stage3_block1": (model.backbone.layers_2_blocks_1,
                                   (torch.randn((1, 24, 24, 512), generator=gen, device="cuda"),)),
            "encoder_layer0": (model.encoder_layers_0, (vision, text, vision_pos, text_pos, refs, shapes,
                                                        attend_t, ~tok_t)),
            "decoder_layer0": (model.decoder_layers_0, (
                model.query_position_embeddings.weight[None], query_pos,
                box[:, :, None, :].expand(-1, -1, len(shapes), 4), enc_vision, enc_text, additive, shapes)),
        }
        for name, (layer, args) in cases.items():
            got = layer(*args)
            want = copy.deepcopy(layer).cpu()(*(a.cpu() if torch.is_tensor(a) else a for a in args))
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            errs = [_rel_err(g, w) for g, w in zip(got, want)]
            blocks[name] = dict(rel_err=max(errs), absmax=max(w.abs().max().item() for w in want))
            if not all(torch.isfinite(g).all() for g in got) or max(errs) > SEG_REL_TOL:
                fail(f"GroundingDINO {name} on the card vs fp32 on the CPU: {errs} (limit {SEG_REL_TOL})")
    log(f"dino layers card vs cpu: {json.dumps(blocks)}")
    del det, model
    torch.cuda.empty_cache()
    return layers, blocks


def phase_reference_segmentation() -> dict:
    """The tiny SAM and detector (``LangSAM.random_init``, one seed) on the
    card against the CPU, fp32: mask logits within ``SEG_REL_TOL`` of max
    |logit|, boxes and scores within it, and the boolean masks equal but
    for pixels whose CPU logit lies within that tolerance of 0; then the
    tiny GroundingDINO (``reference_dino``)."""
    import torch

    from tweediemix_tpu_torch.segmentation.lang_sam import LangSAM

    card = LangSAM.random_init(torch.Generator().manual_seed(0), device="cuda")
    cpu = LangSAM.random_init(torch.Generator().manual_seed(0), device="cpu")
    image = torch.rand((96, 80, 3), generator=torch.Generator().manual_seed(1))
    out = {}
    for text in SEG_CONCEPTS.split("+"):
        lc, bc, sc = (t.cpu() for t in card.predict_logits(image, text))
        l0, b0, s0 = cpu.predict_logits(image, text)
        scale = l0.abs().max()
        logit_err = ((lc - l0).abs().max() / scale).item()
        box_err = (bc - b0).abs().max().item()
        score_err = (sc - s0).abs().max().item()
        flipped = ((lc > 0) != (l0 > 0)) & (l0.abs() > SEG_REL_TOL * scale)
        out[text] = dict(logit_rel_err=logit_err, box_err=box_err, score_err=score_err,
                         flipped_off_edge=int(flipped.sum()), logit_absmax=scale.item())
        if max(logit_err, box_err, score_err) > SEG_REL_TOL or flipped.any():
            fail(f"tiny SAM/detector on the card vs the CPU for {text!r}: {out[text]}")
    out["dino"] = reference_dino()
    log(f"reference segmentation: {json.dumps(out)}")
    return out


def reference_dino() -> dict:
    """The tiny GroundingDino (``seeded_init_`` and a 0.05·N(0, 1) draw on
    every parameter, one seed) on the card against the CPU, fp32, on a 32²
    image and a two-phrase caption with a pad: the -inf pattern of the
    logits equal, the finite logits within ``SEG_REL_TOL`` of their max,
    the boxes within it, and the same top queries."""
    import copy

    import numpy as np
    import torch

    from tweediemix_tpu_torch.models.dino import (
        DinoConfig,
        GroundingDino,
        generate_special_token_masks,
        stable_top_k,
    )
    from tweediemix_tpu_torch.segmentation.lang_sam import seeded_init_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DinoConfig.tiny()
    gen = torch.Generator().manual_seed(5)
    cpu = seeded_init_(GroundingDino(cfg, device="cpu"), gen).eval()
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    card = copy.deepcopy(cpu).cuda()
    ids = np.array([[101, 1100, 1101, 1012, 1102, 1012, 102, 0]])
    attend, pos = generate_special_token_masks(ids)
    inputs = [torch.randn((1, 32, 32, 3), generator=gen)]
    inputs += [torch.from_numpy(a) for a in (ids, attend, pos, ids != 0)]
    with torch.inference_mode():
        logits, boxes = (t.cpu() for t in card(*(t.cuda() for t in inputs)))
        want_logits, want_boxes = cpu(*inputs)
    finite = torch.isfinite(want_logits)
    top = [stable_top_k(torch.sigmoid(torch.nan_to_num(x[0], neginf=-1e30)).max(-1).values, cfg.max_boxes)
           for x in (logits, want_logits)]
    out = dict(logit_rel_err=_rel_err(logits[finite], want_logits[finite]),
               box_err=(boxes - want_boxes).abs().max().item(), top_queries=top[1].tolist(),
               neginf=int((~finite).sum()), logit_absmax=want_logits[finite].abs().max().item())
    if (not torch.equal(torch.isneginf(logits), ~finite) or not torch.isfinite(logits[finite]).all()
            or max(out["logit_rel_err"], out["box_err"]) > SEG_REL_TOL or not torch.equal(top[0], top[1])):
        fail(f"tiny GroundingDINO on the card vs the CPU: {out}, card top {top[0].tolist()}")
    return out


def phase_w8a8_main_path() -> dict:
    """The main path in W8A8 at four seeds: int8 transformer matmuls with
    static per-site scales calibrated on the card, the int8 attention core."""
    import torch

    from tweediemix_tpu_torch.fusion.pipeline import TweedieMixPipeline
    from tweediemix_tpu_torch.fusion.sampler import FusionConfig
    from tweediemix_tpu_torch.models.unet2d import UNetConfig
    from tweediemix_tpu_torch.models.vae import VAEConfig
    from tweediemix_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_int8,
        quantize_qkv_int8_fused,
    )
    from tweediemix_tpu_torch.ops.quant import calibrate, load_static_scales, quant_sites

    n, seeds = 3, 4
    ucfg = UNetConfig.sdxl(concept_slots=n + 1, dtype=torch.bfloat16, quant="int8")
    fcfg = FusionConfig(n_timesteps=50, guidance_scale=0.8, t_cond=0.2, resampling_steps=10,
                        jumping_steps=5, height=1024, width=1024, num_concepts=n)
    expected = expected_flash_launches(ucfg, fcfg)
    t0 = time.perf_counter()
    pipe = TweedieMixPipeline.from_random_weights(ucfg, VAEConfig.sdxl(), fcfg, seed=0,
                                                  device="cuda")
    torch.cuda.synchronize()
    unet_gib = sum(t.numel() * t.element_size() for t in
                   list(pipe.unet.parameters()) + list(pipe.unet.buffers())) / 2**30
    log(f"W8A8 main path: UNet {unet_gib:.3f} GiB on the card ({len(quant_sites(pipe.unet))} "
        f"int8 sites), built in {time.perf_counter() - t0:.1f} s")

    # static scales for these weights, as tools/calibrate_quant.py makes them
    h, w = fcfg.latent_hw
    b = n + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((b, h, w, 4), generator=gen, device="cuda")
    ctx = 0.1 * torch.randn((b, 77, 2048), generator=gen, device="cuda")
    pooled = 0.1 * torch.randn((b, 1280), generator=gen, device="cuda")
    tids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]], device="cuda").expand(b, 6)
    idx = torch.arange(b, device="cuda")
    t0 = time.perf_counter()
    table = calibrate(pipe.unet, [(x, t, ctx, pooled, tids, idx) for t in (999, 501, 1)],
                      margin=1.25)
    found = load_static_scales(pipe.unet, table)
    vals = sorted(table.values())
    log(f"W8A8 calibration: {found} sites in {time.perf_counter() - t0:.2f} s, abs-max x 1.25 "
        f"min {vals[0]:.4g} median {vals[len(vals) // 2]:.4g} max {vals[-1]:.4g}")
    if found != 442:
        fail(f"calibration set {found} static scales, expected 442")

    embeds = _random_embeds(n, 77, 2048, 1280, "cuda", seed=0)
    fg = _half_masks(n, fcfg.height, fcfg.width, "cuda")
    runs = []
    os.environ["TWEEDIEMIX_FLASH_INT8"] = "1"
    try:
        for run in range(2):  # a warm call, then the timed one
            torch.cuda.reset_peak_memory_stats()
            flash_attention.launches = flash_attention_int8.launches = 0
            quantize_qkv_int8_fused.launches = 0
            t0 = time.perf_counter()
            img = pipe.sample(embeds, seed=run, fg_masks=fg, num_seeds=seeds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = flash_attention_int8.launches
            stats = dict(
                s_per_call=wall, s_per_image=wall / seeds, int8_launches=launches,
                quantize_launches=quantize_qkv_int8_fused.launches,
                bf16_launches=flash_attention.launches,
                phases={k: round(v, 4) for k, v in pipe.phase_seconds.items()},
                max_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                image_mean=img.float().mean().item(),
                latent_absmax=pipe.last_latent.abs().max().item(),
            )
            log(f"W8A8 main path {'timed' if run else 'warm'} run: {json.dumps(stats)}")
            if tuple(img.shape) != (seeds, 1024, 1024, 3):
                fail(f"W8A8 image shape {tuple(img.shape)}")
            if not torch.isfinite(pipe.last_latent).all() or not torch.isfinite(img).all():
                fail("W8A8: non-finite latent or image")
            if img.min().item() < 0.0 or img.max().item() > 1.0:
                fail("W8A8: image outside [0, 1]")
            if (launches != expected or quantize_qkv_int8_fused.launches != expected
                    or flash_attention.launches != 0):
                fail(f"W8A8 main path: int8 kernel launched {launches} times and its quantise "
                     f"{quantize_qkv_int8_fused.launches} (expected {expected} each), bf16 kernel "
                     f"{flash_attention.launches} (expected 0)")
            runs.append(stats)
        call = (embeds.concept_ctx, embeds.concept_pooled, torch.arange(b, device="cuda"))
        profile = {"w8a8_batch4_int8_core": profile_call(pipe, "w8a8_batch4_int8_core", *call)}
        os.environ["TWEEDIEMIX_FLASH_INT8"] = "0"
        profile["w8a8_batch4_bf16_core"] = profile_call(pipe, "w8a8_batch4_bf16_core", *call)
    finally:
        os.environ.pop("TWEEDIEMIX_FLASH_INT8", None)
    return dict(runs=runs, expected_launches=expected, unet_gib=unet_gib, profile=profile)


def phase_kernels_short() -> list:
    """The short-sequence kernel against its plain version on the same bf16
    inputs: q/k/v as views of one merged projection (as the model gives
    them) and contiguous, at the video path's shapes and the edge cases."""
    import torch
    import torch.nn.functional as F

    from tweediemix_tpu_torch.ops.short_attention import (
        short_seq_attention,
        short_seq_attention_reference,
    )

    results = []
    cases = [(shape, merged) for shape in SHORT_MAIN_SHAPES for merged in (True, False)]
    cases += [(shape, True) for shape in SHORT_EDGE_SHAPES] + [("negative", False)]
    for shape, merged in cases:
        gen = torch.Generator(device="cuda").manual_seed(len(results) + 3)
        if shape == "negative":  # anti-aligned q/k: scores far below zero
            n, s, heads, dh = 64, 16, 2, 32
            q = torch.full((n, s, heads * dh), 8.0, device="cuda")
            k = -8.0 * (1.0 + 0.01 * torch.randn(q.shape, generator=gen, device="cuda"))
            v = torch.randn(q.shape, generator=gen, device="cuda")
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        else:
            n, s, heads, dh = shape
            d = heads * dh
            if merged:
                qkv = torch.randn((n, s, 3 * d), generator=gen, device="cuda").to(torch.bfloat16)
                q, k, v = qkv.chunk(3, dim=-1)
            else:
                q, k, v = (torch.randn((n, s, d), generator=gen, device="cuda").to(torch.bfloat16)
                           for _ in range(3))
        out = short_seq_attention(q, k, v, heads)
        ref = short_seq_attention_reference(q.float(), k.float(), v.float(), heads)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"short_attention non-finite output at {shape}")
        err = (out.float() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        ms = cuda_ms(lambda: short_seq_attention(q, k, v, heads), 50)
        plain_ms = cuda_ms(lambda: short_seq_attention_reference(q, k, v, heads), 10)
        q4, k4, v4 = (t.view(n, s, heads, dh).transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 50)
        d = heads * dh
        nbytes = 4.0 * n * s * d * 2  # q, k, v read once, o written once, bf16
        flops = 4.0 * n * s * s * d
        t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_HBM_BYTES * 1e3
        row = dict(shape=[n, s, heads, dh] if shape != "negative" else "negative",
                   merged_qkv=merged, max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   gbytes_per_s=nbytes / ms / 1e6)
        log(f"short_attention {shape} {'merged qkv' if merged else 'contiguous'}: max_abs_err "
            f"{err:.3e} rel_err {rel:.3e} ms {ms:.4f} plain_ms {plain_ms:.4f} sdpa_ms "
            f"{library_ms:.4f} bound_ms {row['bound_ms']:.4f} ({row['bound_by']}) "
            f"{row['gbytes_per_s']:.0f} GB/s")
        if not rel <= FLASH_REL_TOL:
            fail(f"short_attention disagrees with its plain version at {shape}: "
                 f"max err / max |plain| = {rel:.3e} > {FLASH_REL_TOL}")
        results.append(row)
    return results


def video_sites_per_call(ucfg, latent_hw, frames: int, ctx_tokens: int) -> dict:
    """Attentions of one UNet3D call (any batch) that the dispatcher sends to
    the short-sequence and the bf16 flash kernels when the short knob is on
    (the caller sets it): the temporal self-attentions over ``frames``, and
    the spatial ones by their token counts (``ctx_tokens`` keys for the
    cross-attentions)."""
    from tweediemix_tpu_torch.models.unet3d import video_cross_attention_names
    from tweediemix_tpu_torch.ops.attention import uses_flash, uses_short

    hd = ucfg.attention_head_dim
    h, w = latent_hw
    n_levels = len(ucfg.block_out_channels)
    counts = dict(short=0, flash=0)

    def attend(tokens, keys, heads):
        inner = heads * hd
        if uses_short((1, tokens, inner), (1, keys, inner), heads):
            counts["short"] += 1
        elif uses_flash(tokens, keys, hd):
            counts["flash"] += 1

    for _ in range(2):  # transformer_in's two self-attentions
        attend(frames, frames, 8)
    for name in video_cross_attention_names(ucfg):
        level = n_levels - 1 if name.startswith("mid") else int(name.split("_")[2])
        if name.startswith("up"):
            level = n_levels - 1 - level
        ch = ucfg.block_out_channels[level]
        heads = max(1, ch // hd)
        tokens = (h >> level) * (w >> level)
        attend(tokens, tokens, heads)  # spatial self-attention
        attend(tokens, ctx_tokens, heads)  # spatial cross-attention
        attend(frames, frames, heads)  # the temporal transformer's two
        attend(frames, frames, heads)
    return counts


def _video_inputs(ucfg, vcfg, ctx_len, seed, device):
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    d = ucfg.cross_attention_dim
    text = 0.1 * torch.randn((1, ctx_len, d), generator=gen)
    uncond = 0.1 * torch.randn((1, ctx_len, d), generator=gen)
    image = torch.rand((1, vcfg.height, vcfg.width, 3), generator=gen) * 2 - 1
    emb = 0.1 * torch.randn((1, 1, d), generator=gen)
    return tuple(t.to(device) for t in (text, uncond, image, emb))


def phase_reference_video() -> dict:
    """A small UNet3D whose temporal self-attentions (8 frames, dh = 64)
    reach the short kernel and whose 32x32-token spatial self-attentions
    reach the flash kernel: one call on the card (bf16, kernels) against the
    same weights on the CPU (fp32, plain versions); then a 3-step trajectory,
    the card's distance from the CPU fp32 run held against the plain bf16
    path's on the CPU."""
    import torch

    from tweediemix_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from tweediemix_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention
    from tweediemix_tpu_torch.ops.short_attention import short_seq_attention
    from tweediemix_tpu_torch.video.pipeline import I2VPipeline, VideoConfig

    kw = dict(block_out_channels=(64, 128), attention_head_dim=64, cross_attention_dim=64,
              norm_num_groups=32, context_pool_size=8)
    vcfg = VideoConfig(num_frames=8, height=64, width=64, latent_factor=2, n_timesteps=3,
                       injection_timestep=0.34)
    h, w = vcfg.latent_hw
    torch.manual_seed(6)
    cpu = UNet3DConditionModel(UNet3DConfig.tiny(**kw), device="cpu")
    gpu = UNet3DConditionModel(UNet3DConfig.tiny(dtype=torch.bfloat16, **kw), device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    cpu16 = UNet3DConditionModel(UNet3DConfig.tiny(dtype=torch.bfloat16, **kw), device="cpu")
    cpu16.load_state_dict(cpu.state_dict())
    ctx_len = 9
    os.environ["TWEEDIEMIX_SHORT_ATTENTION"] = "1"
    sites = video_sites_per_call(gpu.config, (h, w), vcfg.num_frames, ctx_len + 4 + 4)
    gen = torch.Generator(device="cpu").manual_seed(7)
    b, f = 2, vcfg.num_frames
    x = torch.randn((b, f, h, w, 4), generator=gen)
    ctx = 0.2 * torch.randn((b, ctx_len, 64), generator=gen)
    il = 0.3 * torch.randn((b, f, h, w, 4), generator=gen)
    emb = 0.2 * torch.randn((b, 1, 64), generator=gen)
    fps = torch.full((b,), 8.0)
    args = (x, 501, ctx, il, emb, fps, 1.0, 1.0, 0.7)
    out = {}
    try:
        with torch.inference_mode():
            want = cpu(*args)
            flash_attention.launches = short_seq_attention.launches = 0
            got = gpu(*(a.cuda() if torch.is_tensor(a) else a for a in args)).cpu()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        launches = dict(short=short_seq_attention.launches, flash=flash_attention.launches)
        log(f"reference: small UNet3D eps, card bf16 vs CPU fp32: max err / max |eps| = "
            f"{rel:.3e}; launches {launches}, expected {sites}")
        if sites["short"] == 0 or sites["flash"] == 0 or launches != sites:
            fail(f"small UNet3D: kernel launches {launches}, expected {sites}")
        if not (torch.isfinite(got).all() and rel <= EPS_REL_TOL):
            fail(f"small UNet3D on the card disagrees with the CPU: rel {rel:.3e}")
        out["unet3d_rel"] = rel

        torch.manual_seed(8)
        vae = AutoencoderKL(VAEConfig.tiny(scaling_factor=0.18215), device="cpu")
        text, uncond, image, emb1 = _video_inputs(cpu.config, vcfg, ctx_len, 9, "cpu")
        x0 = torch.randn((1, f, h, w, 4), generator=gen)
        noise = torch.randn((1, h, w, 4), generator=gen)
        lat = {}
        for name, unet, device in (("cpu", cpu, "cpu"), ("cpu16", cpu16, "cpu"),
                                   ("card", gpu, "cuda")):
            pipe = I2VPipeline(vcfg, unet, vae, device=device)
            pipe.generate(text, uncond, image, emb1, x_init=x0, posterior_noise=noise)
            lat[name] = pipe.last_latent.float().cpu()
        scale = lat["cpu"].abs().max()
        rel_card = ((lat["card"] - lat["cpu"]).abs().max() / scale).item()
        rel_plain = ((lat["cpu16"] - lat["cpu"]).abs().max() / scale).item()
        log(f"reference: 3-step video trajectory (CFG 9, injection on step 1), latent max err / "
            f"max against CPU fp32: card bf16 (kernels) {rel_card:.3e}, CPU bf16 (plain) "
            f"{rel_plain:.3e}")
        if not (torch.isfinite(lat["card"]).all() and rel_card <= VIDEO_RATIO_TOL * rel_plain):
            fail(f"3-step video trajectory on the card is {rel_card:.3e} from fp32, more than "
                 f"{VIDEO_RATIO_TOL} x the plain bf16 path's {rel_plain:.3e}")
        out.update(trajectory_rel_card=rel_card, trajectory_rel_plain_bf16=rel_plain)
    finally:
        os.environ.pop("TWEEDIEMIX_SHORT_ATTENTION", None)
    return out


def phase_video_main_path() -> dict:
    """I2VGen-XL image-to-video at full width: one warm and one timed clip
    with the short-attention knob on, then a batch-2 UNet call profiled
    with the knob on and off."""
    import torch

    from tweediemix_tpu_torch.models.unet3d import UNet3DConfig, precompute_video_cache
    from tweediemix_tpu_torch.models.vae import VAEConfig
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention, flash_attention_int8
    from tweediemix_tpu_torch.ops.short_attention import short_seq_attention
    from tweediemix_tpu_torch.video.pipeline import I2VPipeline, VideoConfig

    ucfg = UNet3DConfig.i2vgen(dtype=torch.bfloat16)
    vcfg = VideoConfig()
    ctx_len = 77
    os.environ["TWEEDIEMIX_SHORT_ATTENTION"] = "1"
    sites = video_sites_per_call(ucfg, vcfg.latent_hw, vcfg.num_frames, ctx_len + 64 + 4)
    expected = {k: v * vcfg.n_timesteps for k, v in sites.items()}
    if expected != dict(short=1700, flash=500):
        fail(f"expected 1700 short and 500 flash launches per clip, the config gives {expected}")

    t0 = time.perf_counter()
    pipe = I2VPipeline.from_random_weights(ucfg, VAEConfig(scaling_factor=0.18215), vcfg,
                                           seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    log(f"video path: UNet3D {n_params / 1e9:.4f} B params bf16, built in "
        f"{time.perf_counter() - t0:.1f} s; {vcfg.n_timesteps} UNet calls of 2 rows x "
        f"{vcfg.num_frames} frames per clip")
    text, uncond, image, emb = _video_inputs(ucfg, vcfg, ctx_len, 0, "cuda")
    runs = []
    try:
        for run in range(2):  # a warm clip, then the timed one
            torch.cuda.reset_peak_memory_stats()
            flash_attention.launches = flash_attention_int8.launches = 0
            short_seq_attention.launches = 0
            t0 = time.perf_counter()
            video = pipe.generate(text, uncond, image, emb, seed=run)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(short=short_seq_attention.launches, flash=flash_attention.launches)
            stats = dict(
                s_per_clip=wall, launches=launches, int8_launches=flash_attention_int8.launches,
                phases={k: round(v, 4) for k, v in pipe.phase_seconds.items()},
                max_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                video_mean=video.float().mean().item(),
                latent_absmax=pipe.last_latent.abs().max().item(),
            )
            log(f"video path {'timed' if run else 'warm'} clip: {json.dumps(stats)}")
            if tuple(video.shape) != (vcfg.num_frames, vcfg.height, vcfg.width, 3):
                fail(f"video shape {tuple(video.shape)}")
            if not torch.isfinite(pipe.last_latent).all() or not torch.isfinite(video).all():
                fail("video path: non-finite latent or frames")
            if video.min().item() < 0.0 or video.max().item() > 1.0:
                fail("video path: frames outside [0, 1]")
            if launches != expected or flash_attention_int8.launches != 0:
                fail(f"video path launches {launches} (int8 {flash_attention_int8.launches}), "
                     f"expected {expected} and 0 int8")
            runs.append(stats)

        # one batch-2 UNet call of the loop (cache on), knob on and off
        h, w = vcfg.latent_hw
        ctx2 = torch.cat([uncond, text])
        il2 = 0.3 * torch.randn((2, vcfg.num_frames, h, w, 4), device="cuda")
        emb2 = torch.cat([torch.zeros_like(emb), emb])
        fps2 = torch.full((2,), float(vcfg.fps), device="cuda")
        x2 = torch.randn((1, vcfg.num_frames, h, w, 4), device="cuda").repeat(2, 1, 1, 1, 1)
        with torch.inference_mode():
            cctx, cil, kv = precompute_video_cache(pipe.unet, ctx2, il2, emb2, fps2)

        def call():
            pipe.unet(x2, 501, ctx2, il2, emb2, fps2, False, False, vcfg.interp_ratio,
                      cached_ctx=cctx, cached_il=cil, cross_kv=kv)

        profile = {"video_batch2_short_on": profile_fn("video_batch2_short_on", call)}
        os.environ["TWEEDIEMIX_SHORT_ATTENTION"] = "0"
        profile["video_batch2_short_off"] = profile_fn("video_batch2_short_off", call)
    finally:
        os.environ.pop("TWEEDIEMIX_SHORT_ATTENTION", None)
    return dict(runs=runs, expected_launches=expected, unet_params=n_params, profile=profile)


def phase_reference_video_w8a8() -> dict:
    """The small UNet3D of ``phase_reference_video`` under ``quant="int8"``
    and ``"int8_conv"`` with both knobs on (the short kernel on the frame
    axis, the int8 core at the 1024-token spatial self-attentions): the card
    (bf16) against the same int8 weights on the CPU (fp32), held against the
    plain bf16 W8A8 path's distance from the same CPU fp32 run."""
    import torch

    from tweediemix_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention, flash_attention_int8
    from tweediemix_tpu_torch.ops.short_attention import short_seq_attention

    kw = dict(block_out_channels=(64, 128), attention_head_dim=64, cross_attention_dim=64,
              norm_num_groups=32, context_pool_size=8)
    b, f, h, w, ctx_len = 2, 8, 32, 32, 9
    gen = torch.Generator(device="cpu").manual_seed(10)
    args = (torch.randn((b, f, h, w, 4), generator=gen), 501,
            0.2 * torch.randn((b, ctx_len, 64), generator=gen),
            0.3 * torch.randn((b, f, h, w, 4), generator=gen),
            0.2 * torch.randn((b, 1, 64), generator=gen), torch.full((b,), 8.0), 1.0, 1.0, 0.7)
    out = {}
    os.environ.update(TWEEDIEMIX_SHORT_ATTENTION="1", TWEEDIEMIX_FLASH_INT8="1")
    try:
        for quant in ("int8", "int8_conv"):
            torch.manual_seed(11)
            cpu = UNet3DConditionModel(UNet3DConfig.tiny(quant=quant, **kw), device="cpu")
            cpu16 = UNet3DConditionModel(UNet3DConfig.tiny(quant=quant, dtype=torch.bfloat16, **kw),
                                         device="cpu")
            gpu = UNet3DConditionModel(UNet3DConfig.tiny(quant=quant, dtype=torch.bfloat16, **kw),
                                       device="cuda")
            cpu16.load_state_dict(cpu.state_dict())
            gpu.load_state_dict(cpu.state_dict())
            sites = video_sites_per_call(gpu.config, (h, w), f, ctx_len + 4 + 4)
            with torch.inference_mode():
                want = cpu(*args)
                plain16 = cpu16(*args)
                flash_attention.launches = flash_attention_int8.launches = 0
                short_seq_attention.launches = 0
                got = gpu(*(a.cuda() if torch.is_tensor(a) else a for a in args)).cpu()
            launches = dict(short=short_seq_attention.launches, flash=flash_attention_int8.launches)
            scale = want.abs().max()
            rel_card = ((got - want).abs().max() / scale).item()
            rel_plain = ((plain16 - want).abs().max() / scale).item()
            log(f"reference: small W8A8 UNet3D ({quant}, both knobs) eps, max err / max |eps| "
                f"against CPU fp32: card bf16 (kernels) {rel_card:.3e}, CPU bf16 (plain) "
                f"{rel_plain:.3e}; short/int8 launches {launches}, bf16 flash "
                f"{flash_attention.launches}, expected {sites}")
            if not (torch.isfinite(got).all() and rel_card <= W8A8_RATIO_TOL * rel_plain):
                fail(f"small W8A8 UNet3D ({quant}) on the card is {rel_card:.3e} from the CPU, "
                     f"more than {W8A8_RATIO_TOL} x the plain bf16 path's {rel_plain:.3e}")
            if sites["short"] == 0 or sites["flash"] == 0 or launches != sites or flash_attention.launches:
                fail(f"small W8A8 UNet3D ({quant}): launches {launches} and bf16 flash "
                     f"{flash_attention.launches}, expected {sites} and 0")
            out[quant] = dict(rel_card=rel_card, rel_plain_bf16=rel_plain, launches=launches)
    finally:
        os.environ.pop("TWEEDIEMIX_SHORT_ATTENTION", None)
        os.environ.pop("TWEEDIEMIX_FLASH_INT8", None)
    return out


# I2VGen-XL's diffusers folders (ali-vilab/i2vgen-xl): the image encoder
# (OpenCLIP ViT-H/14 with its projection) and the VAE hold the published
# counts; the UNet and the text tower hold the counts of the reference
# package's configs (UNet3DConfig.i2vgen, CLIPTextConfig.i2vgen_text_encoder)
I2VGEN_PARAMS = {"unet": 1_420_469_224, "text_encoder": 352_984_064,
                 "image_encoder": 632_076_800, "vae": 83_653_863}
CLI_VIDEO_PROMPT = "a cat and a dog running in the mountains"


def phase_cli_video(png: str) -> dict:
    """The video CLI at full width, the reference's second stage: a
    diffusers-layout I2VGen-XL directory of seeded random weights (fp16
    variant files, the VAE in fp32, synthetic tokenizers) is written under
    ``build/``; ``tweediemix_tpu_torch.cli.run_video.main`` turns the fusion
    CLI's 1024² PNG into a 16-frame 512² GIF at the reference's defaults
    with the short-attention knob on, then again with ``--quant int8`` and
    the int8 attention core on; each run's launches are counted and its GIF
    read back by the port's decoder; the directory is deleted."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tweediemix_tpu_torch.cli import run_video
    from tweediemix_tpu_torch.models.clip import (
        CLIPTextConfig,
        CLIPTextModel,
        CLIPVisionConfig,
        CLIPVisionModel,
    )
    from tweediemix_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from tweediemix_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from tweediemix_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_int8,
        quantize_qkv_int8_fused,
    )
    from tweediemix_tpu_torch.ops.short_attention import short_seq_attention
    from tweediemix_tpu_torch.utils.image import read_gif
    from tweediemix_tpu_torch.video.pipeline import VideoConfig

    vcfg = VideoConfig()
    ucfg = UNet3DConfig.i2vgen()
    configs = {"unet": (UNet3DConditionModel, ucfg),
               "text_encoder": (CLIPTextModel, CLIPTextConfig.i2vgen_text_encoder()),
               "image_encoder": (CLIPVisionModel, CLIPVisionConfig.vit_h()),
               "vae": (AutoencoderKL, VAEConfig(scaling_factor=0.18215))}
    os.environ["TWEEDIEMIX_SHORT_ATTENTION"] = "1"
    sites = video_sites_per_call(ucfg, vcfg.latent_hw, vcfg.num_frames, 77 + 64 + 4)
    expected = {k: v * vcfg.n_timesteps for k, v in sites.items()}
    if expected != dict(short=1700, flash=500):
        fail(f"expected 1700 short and 500 flash launches per clip, the config gives {expected}")
    root = tempfile.mkdtemp(prefix="cli_i2vgen_", dir=os.path.join(REPO, "build"))
    try:
        t0 = time.perf_counter()
        ckpt = write_checkpoint_dir(root, configs, seed=2, device="cuda")
        written = ckpt["bytes"] + write_tokenizers(root)
        write_s = time.perf_counter() - t0
        log(f"cli video: wrote {written / 1e9:.3f} GB in {write_s:.1f} s: {json.dumps(ckpt['params'])}")
        if ckpt["params"] != I2VGEN_PARAMS:
            fail(f"checkpoint parameters {ckpt['params']} differ from I2VGen-XL's {I2VGEN_PARAMS}")
        torch.cuda.empty_cache()
        runs, gifs = {}, {}
        for label, extra, int8_core in (("bf16", [], False), ("w8a8", ["--quant", "int8"], True)):
            out = os.path.join(root, f"clip_{label}.gif")
            argv = ["--model_dir", root, "--image", png, "--prompt", CLI_VIDEO_PROMPT,
                    "--output", out, "--seed", "0", *extra]
            os.environ["TWEEDIEMIX_FLASH_INT8"] = "1" if int8_core else "0"
            torch.cuda.reset_peak_memory_stats()
            flash_attention.launches = flash_attention_int8.launches = 0
            quantize_qkv_int8_fused.launches = short_seq_attention.launches = 0
            rc, text, wall = run_cli(run_video.main, argv)
            launches = dict(short=short_seq_attention.launches, flash=flash_attention.launches,
                            int8=flash_attention_int8.launches,
                            int8_quantize=quantize_qkv_int8_fused.launches)
            if rc != 0:
                fail(f"the video CLI ({label}) returned {rc}")
            want = (dict(short=1700, flash=0, int8=500, int8_quantize=500) if int8_core
                    else dict(short=1700, flash=500, int8=0, int8_quantize=0))
            if launches != want:
                fail(f"video CLI ({label}) launches {launches}, expected {want}")
            timings = json.loads(text.split("timings: ", 1)[1].splitlines()[0])
            header, frames = read_gif(out)
            if (frames.shape != (vcfg.num_frames, vcfg.height, vcfg.width, 3)
                    or header["durations_ms"] != [120] * vcfg.num_frames or header["loop"] != 0):
                fail(f"video CLI ({label}) GIF: {frames.shape}, {header}")
            if frames.min() == frames.max():
                fail(f"video CLI ({label}): every pixel of the GIF is equal")
            runs[label] = dict(
                gpu=gpu_name_and_power(), wall_s=wall, load_s=timings["load_s"],
                build_s=timings["build_s"], encode_s=timings["encode_s"],
                s_per_clip=timings["generate_s"], write_s=timings["write_s"],
                phases={k: round(v, 4) for k, v in timings["phases"].items()},
                max_memory_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
                gif_bytes=os.path.getsize(out), frame_mean=float(frames.mean()))
            gifs[label] = frames.astype(np.int64)
        stats = dict(bytes_written=written, write_s=write_s, params=ckpt["params"], runs=runs,
                     w8a8_vs_bf16_mean_abs=float(np.abs(gifs["bf16"] - gifs["w8a8"]).mean()))
        log(f"cli video path: {json.dumps(stats)}")
        return stats
    finally:
        os.environ.pop("TWEEDIEMIX_SHORT_ATTENTION", None)
        os.environ.pop("TWEEDIEMIX_FLASH_INT8", None)
        shutil.rmtree(root)


# ---------------------------------------------------------------------------
# training: the flash kernel with a gradient, a small train step, the CLI

# SDXL's level-1 self-attention at 512² (64x64 latents: 32x32 tokens), batch
# 2 (instance + prior) x 10 heads: the training CLI's flash shape
TRAIN_FLASH_SHAPE = (20, 1024, 1024, 64)
TRAIN_REL_TOL = 1e-2  # dq/dk/dv against autograd of the fp32 plain version, of max |plain|
# a small train step, bf16 on the card against fp32 on the CPU: the loss and
# each gradient within 3x the plain bf16 path's distance from fp32
TRAIN_RATIO_TOL = 3.0
TRAIN_STEPS, TRAIN_SAVE_STEPS, TRAIN_TE_STEPS = 10, 5, 3
TRAIN_CLASS_IMAGES = 2
TRAIN_FUSION = dict(n_timesteps=4, t_cond=0.5, resampling_steps=0, jumping_steps=1)
TRAIN_PROFILE_STEP = 6  # the micro step run under torch.profiler


def phase_kernel_grad() -> dict:
    """The bf16 flash kernel's forward and ``FlashAttention``'s math
    backward at the training shape: dq/dk/dv against autograd of the plain
    version in fp32, with the forward's, the backward's, the plain
    version's and SDPA's forward+backward times and the backward's bound."""
    import torch
    import torch.nn.functional as F

    from tweediemix_tpu_torch.ops.attention import FlashAttention, attention, math_attention
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    bh, s, _, dh = TRAIN_FLASH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, g = (torch.randn((bh, s, dh), generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    flash_attention.launches = 0
    out = attention(q, k, v)
    if flash_attention.launches != 1 or type(out.grad_fn).__name__ != "FlashAttentionBackward":
        fail(f"a flash site with a gradient took {out.grad_fn} and {flash_attention.launches} launches")
    grads = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
    ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = flash_attention_reference(*ref_in)
    ref_grads = torch.autograd.grad(ref, ref_in, g.float())
    errs = {}
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        if not torch.isfinite(got).all():
            fail(f"non-finite {name}")
        errs[name] = ((got.float() - want).abs().max() / want.abs().max()).item()
    fwd_err = ((out.float() - ref).abs().max() / ref.abs().max()).item()

    scale = dh**-0.5
    qd, kd, vd = (t.detach() for t in (q, k, v))
    fwd_ms = cuda_ms(lambda: flash_attention(qd, kd, vd, scale), 50)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True), 20)
    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(FlashAttention.apply(q, k, v, scale, False),
                                                     (q, k, v), g), 20)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(math_attention(q, k, v, scale), (q, k, v), g), 10)
    q4, k4, v4 = (t.detach()[None].requires_grad_() for t in (q, k, v))
    library_ms = cuda_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(q4, k4, v4),
                                                     (q4, k4, v4), g[None]), 20)
    # the backward recomputes q·kᵀ and runs four more products (dP, dV, dQ,
    # dK): 10·S²·dh flops per row; it reads q, k, v and dO, writes dq, dk, dv
    flops = 10.0 * bh * s * s * dh
    nbytes = 2.0 * 7 * bh * s * dh
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_HBM_BYTES * 1e3
    row = dict(shape=list(TRAIN_FLASH_SHAPE), fwd_rel_err=fwd_err, rel_err=max(errs.values()),
               grad_rel_err=errs, max_abs_err=max((a.float() - b).abs().max().item()
                                                  for a, b in zip(grads, ref_grads)),
               fwd_ms=fwd_ms, ms=bwd_ms, fwd_bwd_ms=fwd_bwd_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"flash_attention with a gradient {TRAIN_FLASH_SHAPE}: {json.dumps(row)}")
    if not max(errs.values()) <= TRAIN_REL_TOL:
        fail(f"FlashAttention's gradients disagree with the plain version's: {errs} "
             f"(limit {TRAIN_REL_TOL} of max)")
    return row


def _train_models(device, dtype, seed):
    """The small training config: a tiny UNet whose level-1 self-attention
    reaches the kernel at 64x64 latents (1024 tokens, dh 64), remat and the
    detach on, and the tiny towers."""
    import torch

    from tweediemix_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from tweediemix_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig

    torch.manual_seed(seed)  # drawn in fp32 on the CPU, then cast: one set of weights
    ucfg = UNetConfig.tiny(block_out_channels=(64, 128), num_attention_heads=(1, 2),
                           cross_attention_dim=64, pooled_projection_dim=32,
                           detach_first_token_kv=True, remat=True, dtype=dtype)
    models = {"unet": UNet2DConditionModel(ucfg, device="cpu"),
              "te1": CLIPTextModel(CLIPTextConfig.tiny(dtype=dtype), device="cpu"),
              "te2": CLIPTextModel(CLIPTextConfig.tiny(projection_dim=32, dtype=dtype),
                                   device="cpu")}
    return {k: m.to(device) for k, m in models.items()}


def phase_reference_train() -> dict:
    """One train step (crossattn_kv with a modifier token, prior
    preservation, remat) of the small config on the card in bf16 through
    the kernel, against the same weights, batch, t and noise on the CPU in
    fp32 and in bf16 (plain versions): the loss and every gradient within
    ``TRAIN_RATIO_TOL`` x the plain bf16 path's distance from fp32, and the
    kernel launched twice per self-attention site (remat)."""
    import torch

    from tweediemix_tpu_torch.ops.flash_attention import flash_attention
    from tweediemix_tpu_torch.schedulers.ddim import training_alphas_cumprod
    from tweediemix_tpu_torch.training.custom_diffusion import TrainConfig
    from tweediemix_tpu_torch.training.trainer import (
        FullTrainState,
        embedding_row_mask,
        full_trainable_mask,
        make_full_optimizer,
        make_full_train_step,
        promote_trainable_to_fp32,
    )

    gen = torch.Generator().manual_seed(5)
    hw = 64
    mask = torch.ones(2, hw, hw, 1)
    mask[0, :10] = 0.0
    ids = torch.full((2, 77), 999, dtype=torch.long)
    ids[:, 0] = 998
    ids[:, 1:5] = torch.tensor([[3, 7, 40, 41], [3, 40, 41, 42]])  # row 0 holds the modifier 7
    batch = dict(latents=torch.randn((2, hw, hw, 4), generator=gen), mask=mask, ids_one=ids,
                 ids_two=ids, is_prior=torch.tensor([0.0, 1.0]))
    t = torch.tensor([250, 700])
    noise = torch.randn((2, hw, hw, 4), generator=gen)
    cfg = TrainConfig(learning_rate=1e-4)
    tids = torch.tensor([[512.0, 512, 0, 0, 512, 512]])

    def one_step(device, dtype):
        models = _train_models(device, dtype, seed=3)
        params = promote_trainable_to_fp32(models, full_trainable_mask(models, "crossattn_kv", True))
        state = FullTrainState(params, make_full_optimizer(cfg, params))
        rm = embedding_row_mask(1000, [7], device)
        step = make_full_train_step(models["unet"], models["te1"], models["te2"], cfg,
                                    training_alphas_cumprod().to(device), rm, rm, tids.to(device))
        flash_attention.launches = 0
        metrics = step(state, {k: v.to(device) for k, v in batch.items()},
                       timesteps=t.to(device), noise=noise.to(device))
        launches = flash_attention.launches
        return (metrics["loss"].float().item(),
                {k: g.float().cpu() for k, g in state.grads.items()}, launches, models["unet"].config)

    loss32, grads32, _, _ = one_step("cpu", torch.float32)
    loss16, grads16, _, _ = one_step("cpu", torch.bfloat16)
    loss_card, grads_card, launches, ucfg = one_step("cuda", torch.bfloat16)
    sites = flash_sites_per_call(ucfg, (hw, hw))

    def dist(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()

    rows = {k: dict(card=dist(grads_card[k], grads32[k]), plain=dist(grads16[k], grads32[k]))
            for k in grads32}
    loss_card_err, loss_plain_err = abs(loss_card - loss32) / loss32, abs(loss16 - loss32) / loss32
    worst = max(rows.items(), key=lambda kv: kv[1]["card"] / max(kv[1]["plain"], 1e-30))
    stats = dict(loss=dict(cpu_fp32=loss32, cpu_bf16=loss16, card_bf16=loss_card),
                 loss_rel_err=dict(card=loss_card_err, plain=loss_plain_err),
                 grads=len(rows), worst_grad=dict(name=worst[0], **worst[1]), launches=launches,
                 sites_per_call=sites)
    log(f"reference train step, card bf16 vs CPU fp32 (and the plain bf16 path): {json.dumps(stats)}")
    if sites == 0 or launches != 2 * sites:
        fail(f"the small train step launched the kernel {launches} times, expected {2 * sites}")
    if not (math.isfinite(loss_card) and loss_card_err <= TRAIN_RATIO_TOL * max(loss_plain_err, 1e-6)):
        fail(f"train-step loss on the card {loss_card_err:.3e} from fp32, plain bf16 {loss_plain_err:.3e}")
    for name, r in rows.items():
        if not r["card"] <= TRAIN_RATIO_TOL * max(r["plain"], 1e-6):
            fail(f"gradient {name} on the card is {r['card']:.3e} from fp32, more than "
                 f"{TRAIN_RATIO_TOL} x the plain bf16 path's {r['plain']:.3e}")
    return stats


def _train_stdout(out: str) -> dict:
    """The training CLI's losses and its timings line."""
    losses = [float(line.rsplit("loss ", 1)[1]) for line in out.splitlines()
              if line.startswith("step ") and ": loss " in line]
    timings = json.loads(out.split("timings: ", 1)[1].splitlines()[0])
    return dict(losses=losses, timings=timings)


def phase_cli_train(root, fusion_argv, deltas) -> dict:
    """The training CLI at full width from ``phase_cli``'s SDXL directory:
    instance PNGs written by the port, class images generated into an empty
    class directory, ``--with_prior_preservation --modifier_token <new1>
    --gradient_checkpointing``, ``TRAIN_STEPS`` steps saving every
    ``TRAIN_SAVE_STEPS``; then ``TRAIN_TE_STEPS`` steps with
    ``--train_text_encoder --use_8bit_adam``; each run's kernel launches
    counted, its trainable leaves moved and its frozen ones bit-equal; then
    the fusion CLI samples a short run with the trained delta as the first
    concept."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tweediemix_tpu_torch.cli import fusion_sampling, train
    from tweediemix_tpu_torch.concepts.delta import is_cross_kv, load_reference_delta
    from tweediemix_tpu_torch.fusion.sampler import FusionConfig
    from tweediemix_tpu_torch.models.convert import checkpoint_shapes
    from tweediemix_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention
    from tweediemix_tpu_torch.training import trainer
    from tweediemix_tpu_torch.utils.image import read_png, write_png

    inst, cls = os.path.join(root, "train_instance"), os.path.join(root, "train_class")
    os.makedirs(inst)
    rng = np.random.default_rng(7)
    for i, (h, w) in enumerate([(640, 512), (512, 768), (600, 600)]):
        write_png(os.path.join(inst, f"{i}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    ucfg = UNetConfig.sdxl()
    sites = flash_sites_per_call(ucfg, (64, 64))  # 512² → 64x64 latents
    cross_kv = sorted(n for n in checkpoint_shapes(UNet2DConditionModel(ucfg, device="meta"))
                      if is_cross_kv(n))
    base = ["--model_dir", root, "--instance_data_dir", inst,
            "--instance_prompt", "photo of a <new1> cat", "--class_data_dir", cls,
            "--class_prompt", "photo of a cat", "--with_prior_preservation",
            "--num_class_images", str(TRAIN_CLASS_IMAGES), "--sample_batch_size",
            str(TRAIN_CLASS_IMAGES), "--modifier_token", "<new1>", "--gradient_checkpointing",
            "--seed", "0"]
    make_step = trainer.make_full_train_step
    runs = {}
    try:
        for label, steps, extra in (
                ("cd", TRAIN_STEPS, ["--save_steps", str(TRAIN_SAVE_STEPS)]),
                ("te_8bit", TRAIN_TE_STEPS, ["--train_text_encoder", "--use_8bit_adam"])):
            out = os.path.join(root, f"train_{label}")
            kept = {}

            def keep(unet, te1, te2, *args, **kw):
                # every leaf's value before training, on the host (so the
                # CLI's peak memory is its own), and one step profiled
                named = {f"{k}/{n}": p for k, m in (("unet", unet), ("te1", te1), ("te2", te2))
                         for n, p in m.named_parameters()}
                kept["params"] = named
                kept["before"] = {n: p.detach().to("cpu", copy=True) for n, p in named.items()}
                step = make_step(unet, te1, te2, *args, **kw)
                calls = []

                def profiled(*a, **k):
                    calls.append(1)
                    if len(calls) != TRAIN_PROFILE_STEP:
                        return step(*a, **k)
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        out = step(*a, **k)
                        torch.cuda.synchronize()
                    kept["profile"] = prof
                    return out

                return profiled

            trainer.make_full_train_step = keep
            torch.cuda.reset_peak_memory_stats()
            flash_attention.launches = 0
            argv = base + ["--max_train_steps", str(steps), "--output_dir", out] + extra
            rc, stdout, wall = run_cli(train.main, argv)
            launches = flash_attention.launches
            trainer.make_full_train_step = make_step
            if rc != 0:
                fail(f"the training CLI returned {rc}")
            parsed = _train_stdout(stdout)
            generated = TRAIN_CLASS_IMAGES if label == "cd" else 0
            class_launches = 25 * sites * math.ceil(generated / TRAIN_CLASS_IMAGES)
            per_step = (launches - class_launches) / steps
            # every trainable UNet leaf and both token tables must move (a
            # tower leaf the loss does not reach, such as tower 1's last
            # layer, moves by its weight decay only, and a zero bias not at
            # all); every frozen leaf must stay bit-equal
            moved = frozen_changed = must_move = 0
            for n, p in kept["params"].items():
                changed = not torch.equal(p.detach().cpu(), kept["before"][n])
                if not p.requires_grad:
                    frozen_changed += changed
                elif n.startswith("unet/") or n.endswith(trainer.TOKEN_TABLE):
                    must_move += 1
                    moved += changed
            trainable = sum(p.requires_grad for p in kept["params"].values())
            delta_path = os.path.join(out, f"delta-{steps}.bin")
            st = load_reference_delta(delta_path)
            stats = dict(gpu=gpu_name_and_power(), wall_s=wall, **parsed["timings"],
                         losses=parsed["losses"], launches=launches, class_launches=class_launches,
                         launches_per_step=per_step,
                         max_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                         trainable=trainable, must_move=must_move, moved=moved,
                         frozen_changed=frozen_changed,
                         delta_bytes=os.path.getsize(delta_path), files=sorted(os.listdir(out)))
            log(f"cli train {label}: {json.dumps(stats)}")
            if "profile" in kept:
                stats["profile"] = device_breakdown(kept["profile"], parsed["timings"]["step_s"] * 1e3)
                log(f"profile train step {label} (step {TRAIN_PROFILE_STEP}, idle against the "
                    f"median s/step): {json.dumps(stats['profile'])}")
            del kept
            torch.cuda.empty_cache()
            if per_step != 2 * sites or launches != class_launches + 2 * sites * steps:
                fail(f"the training CLI launched the kernel {launches} times ({per_step} per step), "
                     f"expected {class_launches} + {2 * sites} x {steps}")
            if not parsed["losses"] or not all(math.isfinite(x) for x in parsed["losses"]):
                fail(f"training losses {parsed['losses']}")
            if frozen_changed or moved != must_move:
                fail(f"{moved} of {must_move} UNet leaves and token tables moved, "
                     f"{frozen_changed} frozen leaves changed")
            if sorted(st["unet"]) != cross_kv or list(st["modifier_token"]) != ["<new1>"]:
                fail(f"delta keys: {len(st['unet'])} UNet entries, tokens {list(st['modifier_token'])}")
            if ("text_encoder" in st) != (label == "te_8bit"):
                fail(f"delta {delta_path} has keys {sorted(st)}")
            if label == "cd":
                want_files = sorted([f"delta-{TRAIN_SAVE_STEPS}.bin", f"delta-{steps}.bin", "resume"])
                if stats["files"] != want_files or sorted(os.listdir(cls)) != [
                        f"{i:05d}.png" for i in range(TRAIN_CLASS_IMAGES)]:
                    fail(f"training outputs {stats['files']}, class images {os.listdir(cls)}")
                ihdr, _ = read_png(os.path.join(cls, "00000.png"))
                if (ihdr["width"], ihdr["height"]) != (512, 512):
                    fail(f"class image {ihdr}")
            runs[label] = stats

        # the trained delta as the first concept of a short fusion sample
        trained = os.path.join(root, "train_cd", f"delta-{TRAIN_STEPS}.bin")
        argv = _flag(fusion_argv, "personal_checkpoint", "+".join([trained] + deltas[1:]))
        tokens = argv[argv.index("--modifier_token") + 1].split("+")
        argv = _flag(argv, "modifier_token", "+".join(["<new1>"] + tokens[1:]))
        argv = _flag(argv, "output_path", os.path.join(root, "train_sample"))
        for flag, value in TRAIN_FUSION.items():
            argv = _flag(argv, flag, value)
        fcfg = FusionConfig(**dict(CLI_FUSION, **TRAIN_FUSION))
        expected = expected_flash_launches(UNetConfig.sdxl(concept_slots=4), fcfg)
        flash_attention.launches = 0
        rc, stdout, wall = run_cli(fusion_sampling.main, argv)
        if rc != 0 or flash_attention.launches != expected:
            fail(f"fusion CLI with the trained delta: rc {rc}, launches {flash_attention.launches} "
                 f"(expected {expected})")
        pngs = [f for f in os.listdir(os.path.join(root, "train_sample")) if f.endswith(".png")]
        if len(pngs) != 1:
            fail(f"fusion CLI with the trained delta wrote {pngs}")
        _, pixels = read_png(os.path.join(root, "train_sample", pngs[0]))
        if pixels.min() == pixels.max():
            fail("every pixel of the trained-delta sample is equal")
        runs["sample"] = dict(wall_s=wall, launches=flash_attention.launches,
                              timings=json.loads(stdout.split("timings: ", 1)[1].splitlines()[0]))
        log(f"cli train sample: {json.dumps(runs['sample'])}")
        return runs
    finally:
        trainer.make_full_train_step = make_step


KERNEL_CLASSES = (  # (class, substrings of the CUDA kernel name), first match wins
    ("short_attention", ("short_attn_kernel",)),
    ("flash_attention_int8", ("flash_int8_wgmma_kernel", "absmax_kernel", "quantize_kernel<")),
    ("flash_attention", ("flash_fwd_kernel",)),
    ("layout", ("nchwToNhwc", "nhwcToNchw")),
    ("convolution", ("fprop", "conv", "dgrad", "winograd")),
    ("gemm_int8", ("s8s8", "i8i8", "imma", "_s8_", "_i8_", "int8")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "Kernel2")),
    ("norm", ("norm", "moments")),  # GroupNorm's statistics: RowwiseMomentsCUDAKernel
    ("softmax", ("softmax",)),
    ("elementwise/copy", ("elementwise", "vectorized", "copy", "cat", "fill", "reduce", "index")),
)


def _kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k.lower() in low for k in keys):
            return cls
    return "other"


def profile_call(pipe, label, ctx, pooled, idx) -> dict:
    """One fusion UNet call (cross-K/V cache on), profiled by ``profile_fn``."""
    import torch

    h, w = pipe.fusion_config.latent_hw
    x = torch.randn((idx.shape[0], h, w, 4), device="cuda")
    with torch.inference_mode():
        kv = pipe._kv_builder(ctx, idx)
        return profile_fn(label, lambda: pipe._unet_fn(x, 501, ctx, pooled, idx, cross_kv=kv))


def profile_fn(label, call) -> dict:
    """``call()`` under torch.profiler: device time by kernel class and the
    top kernels; the device's idle share is taken against the mean wall time
    of the same call run without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        call()
        torch.cuda.synchronize()
        # wall time without the profiler, whose host overhead inflates it
        t0 = time.perf_counter()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    out = dict(wall_ms=wall_ms, profiled_wall_ms=profiled_wall_ms, **device_breakdown(prof, wall_ms))
    log(f"profile {label}: {json.dumps(out)}")
    return out


def device_breakdown(prof, wall_ms: float) -> dict:
    """A finished torch.profiler run's device time by kernel class, its top
    kernels, and the device's idle share against ``wall_ms``."""
    from torch.autograd import DeviceType

    by_name, by_class = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us / 1e3)
        cls = _kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
    busy_ms = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1][1])[:12]
    return dict(
        device_busy_ms=busy_ms,
        device_idle_share=(1.0 - busy_ms / wall_ms) if busy_ms else None,
        by_class_ms={k: round(v, 3) for k, v in sorted(by_class.items(), key=lambda i: -i[1])},
        top_kernels=[dict(name=n[:110], count=c, ms=round(t, 3)) for n, (c, t) in top],
    )


def main() -> None:
    if not os.path.isdir(os.path.join(REPO, "tweediemix_tpu_torch")):
        fail("the tweediemix_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke.py needs a CUDA card")

    phase_build()
    kernel_rows = phase_kernels()
    grad_row = phase_kernel_grad()
    int8_rows = phase_kernels_int8()
    phase_reference()
    reference_train = phase_reference_train()
    reference_w8a8 = phase_reference_w8a8()
    short_rows = phase_kernels_short()
    reference_video = phase_reference_video()
    reference_video_w8a8 = phase_reference_video_w8a8()
    reference_segmentation = phase_reference_segmentation()
    main_path = phase_main_path()
    torch.cuda.empty_cache()
    fused_png = os.path.join(REPO, "build", "cli_fused.png")
    cli = phase_cli(keep_png=fused_png)
    torch.cuda.empty_cache()
    w8a8 = phase_w8a8_main_path()
    torch.cuda.empty_cache()
    video = phase_video_main_path()
    torch.cuda.empty_cache()
    cli_video = phase_cli_video(fused_png)
    os.remove(fused_png)
    cli_runs = cli_video["runs"]

    def entry(name, source, replaces, launches, rows, **extra):
        head = rows[0]  # the first main-path shape
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
                    rel_err=max(r["rel_err"] for r in rows), ms=head["ms"],
                    plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                    bound_by=head["bound_by"], library_ms=head["library_ms"],
                    shape=head["shape"], **extra, shapes=rows)

    kernels = [
        entry("flash_attention", "tweediemix_tpu_torch/csrc/flash_attention.cu",
              "tweediemix_tpu/ops/flash_attention.py:37", main_path["runs"][0]["launches"],
              kernel_rows, video_launches=video["runs"][-1]["launches"]["flash"],
              cli_launches=cli["launches"], cli_sam_launches=cli["segmentation"]["fusion"]["launches"],
              cli_dino_launches={k: v["launches"] for k, v in cli["segmentation"]["dino"]["fusion"].items()},
              cli_video_launches=cli_runs["bf16"]["launches"]["flash"],
              train_launches=cli["train"]["cd"]["launches_per_step"],
              train_te_launches=cli["train"]["te_8bit"]["launches_per_step"],
              backward=dict(shape=grad_row["shape"], ms=grad_row["ms"],
                            plain_ms=grad_row["plain_ms"], bound_ms=grad_row["bound_ms"],
                            bound_by=grad_row["bound_by"], library_ms=grad_row["library_ms"],
                            max_abs_err=grad_row["max_abs_err"], fwd_ms=grad_row["fwd_ms"],
                            fwd_bwd_ms=grad_row["fwd_bwd_ms"])),
        entry("flash_attention_int8", "tweediemix_tpu_torch/csrc/flash_attention_int8.cu",
              "tweediemix_tpu/ops/flash_attention.py:113", w8a8["runs"][-1]["int8_launches"],
              int8_rows, wrapper_ms=int8_rows[0]["wrapper_ms"],
              sdpa_bf16_ms=int8_rows[0]["sdpa_bf16_ms"],
              host_us_per_call=int8_rows[0]["host_us_per_call"],
              cli_video_launches=cli_runs["w8a8"]["launches"]["int8"],
              quantize=dict(launches=w8a8["runs"][-1]["quantize_launches"],
                            ms=int8_rows[0]["quant_ms"], plain_ms=int8_rows[0]["quant_plain_ms"],
                            bound_ms=int8_rows[0]["quant_bound_ms"], bound_by="bytes",
                            max_abs_err=max(r["quant_max_abs_err"] for r in int8_rows),
                            library_ms=None)),
        entry("short_attention", "tweediemix_tpu_torch/csrc/short_attention.cu",
              "tweediemix_tpu/ops/short_attention.py:51", video["runs"][-1]["launches"]["short"],
              short_rows, cli_video_launches=cli_runs["bf16"]["launches"]["short"],
              cli_video_w8a8_launches=cli_runs["w8a8"]["launches"]["short"]),
    ]
    log(json.dumps(dict(main_path=main_path, cli_path=cli, reference_w8a8=reference_w8a8,
                        reference_train=reference_train, kernel_grad=grad_row,
                        reference_segmentation=reference_segmentation,
                        w8a8_main_path=w8a8, reference_video=reference_video,
                        reference_video_w8a8=reference_video_w8a8, video_path=video,
                        cli_video_path=cli_video)))
    log(json.dumps(dict(kernels=kernels)))
    log(gpu_name_and_power())
    log(json.dumps(dict(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                                             count=torch.cuda.device_count()))))


if __name__ == "__main__":
    main()
