#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
the ``tweediemix_tpu_torch`` package beside this file; it imports nothing of
JAX or of the JAX package. Phases:

1. the card's name and power limit, torch/CUDA versions, the kernels'
   build (one nvcc per source, sm_90a, all started together) and its time;
2. kernels: each hand-written kernel against its plain PyTorch version on
   the same inputs at the main paths' shapes and the edge cases (for the
   bf16 kernel also S = 256 and S = 200, the lengths
   ``TWEEDIEMIX_FLASH_MIN_S`` can send it), with its
   time, the plain version's, one PyTorch library call's (a yardstick only)
   and the bound (for the bf16 kernel also the softmax's exp2 floor and the
   wrapper's host cost per call); the int8 kernel also against exact fp32
   attention, with its exp2 and issue floors, and its two fused quantise
   passes bitwise against their plain versions, timed against their byte
   bound; the W8A8 linear's two launches (quantise, int8 GEMM with its
   epilogue) bitwise against their plain version at the 16 SDXL site shapes
   and the 22 of an I2VGen-XL loop call, static and dynamic, timed on the
   device alone beside their bound, the plain version and ``torch._int_mm``; the bf16 kernel with a gradient at the training shape
   (``FlashAttention``: the kernel forward, the math backward), dq/dk/dv
   against autograd of the fp32 plain version, with the backward's time,
   bound and SDPA's forward+backward; the GroupNorm kernel (optional SiLU)
   at every GroupNorm shape of the SDXL call (2 and 4 rows) and the
   I2VGen-XL loop call, found by a forward on the ``meta`` device (46 and
   166 calls), held to the exact fp64 result within 1.05 times PyTorch's
   bf16 error, timed on the device alone beside its bytes bound and the
   plain version (``F.group_norm`` + ``F.silu``), with sums per UNet call;
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
   launch count checked on each run, then once more under torch.profiler,
   where the flash-kernel events of the trace (the UNet calls are CUDA
   graph replays) and the counter must both read 5250, the GroupNorm
   kernel's 3450 (46 a call); then two seeds unsharded and over a
   2-entry mesh on ``cuda:0`` (``parallel/mesh.py``: every UNet call's rows
   split in two, so twice the launches), the latents held to each other;
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
   ``DinoDetector`` call is timed by stage, and a Swin-B block, an
   encoder layer and a decoder layer are held to fp32 on the CPU; then,
   from the same directory, the training CLI (``phase_cli_train``): instance PNGs, class images sampled into an empty
   directory, 10 steps at 512² with prior preservation, a modifier token and
   remat (saving at 5), then 3 steps with ``--train_text_encoder
   --use_8bit_adam``, each run's launches per step counted, its trainable
   leaves moved and frozen ones bit-equal, then the
   first run's flags up to its first save as one ``--multihost`` rank
   (NCCL at world size 1: every gradient ``all_reduce`` through NCCL), its
   delta held to the plain run's, and the trained delta sampled by the
   fusion CLI; then the warm server
   (``cli/serve.main`` in process, ``phase_cli_serve``): five JSONL lines
   (the one-shot CLI's seed, whose PNG must equal the one-shot CLI's pixel
   for pixel, a malformed request answered with an error line, a warm
   request at a new seed, a "||" pair at two seeds, an empty line), each
   request's latency, warm flag and flash launches; the fusion CLI with
   ``--profile`` cut to 4 steps (``phase_cli_profile``: phase timings, a
   Chrome trace whose flash-kernel events, counted by kernel name, equal
   the expected launches, and spans on the trace's clock); CLIP-T and
   CLIP-I of the served PNGs against the training images from a CLIP
   ViT-L/14-width directory of random weights (``phase_cli_evaluate``: the
   evaluate CLI, then the card's fp32 scores held to the CPU's); the
   demo's predict function on the SAM and OWL-ViT checkpoints
   (``phase_app``: its overlay equal to ``draw_image`` over
   ``LangSAM.predict``); the directory is deleted (the fusion PNG is kept
   for phase 7);
5. W8A8 main path: the same sample with ``quant="int8"`` at four seeds,
   static per-site activation scales calibrated on the card for these
   weights by ``tools/calibrate_quant.py::calibrate_unet`` (timesteps
   999/501/1 at batch 4, margin 1.25) and the int8
   attention core on (``TWEEDIEMIX_FLASH_INT8=1``): one warm and one timed
   call, the int8 kernel's and its quantise passes' launch counts checked
   and the bf16 kernel's held at 0, the W8A8 linear kernels' at 442 a UNet
   call, and the same counts (with the GroupNorm kernel's 3450) from the
   kernel events of a third, traced call and from the counters over it;
   no synchronising operation in a
   replayed UNet call;
6. video: the short-sequence (frame-axis) kernel against its plain version
   at the video path's five shapes (as views of a merged qkv and
   contiguous) and its edge cases (each with a sentinel around the
   output), timed on the device alone (a CUDA graph of
   launches, warm and with the L2 flushed) and by the wrapper's host
   microseconds per call; a small UNet3D and a 3-step video
   trajectory on the card (bf16, both kernels) against the CPU (fp32, plain
   versions); the I2VGen-XL image-to-video path at full width
   (``UNet3DConfig.i2vgen()`` in bf16 with seeded random weights, fp32 VAE,
   50 DDIM steps, CFG 9, 16 frames at 512², the short-attention knob on)
   through ``I2VPipeline.generate``, one warm and one timed clip with both
   kernels' launch counts checked and the GroupNorm kernel's (8300, 166 a
   call, each reading x once); two clips unsharded and over the 2-entry
   mesh (one clip per shard), the loop cut to 10 steps, launches counted
   and the latents held to each other;
7. the video CLI: a full-width I2VGen-XL directory of seeded random weights
   in the diffusers layout (its parameter counts held, fp16 variant files,
   the VAE in fp32) is written under ``build/`` and
   ``tweediemix_tpu_torch.cli.run_video.main`` turns phase 4's PNG into a
   16-frame 512² GIF at the reference's defaults, in bf16 and with
   ``--quant int8`` and the int8 core on: each run's launches of all three
   attention kernels and of the W8A8 linear (264 a UNet call under
   ``--quant``, 0 in bf16) are counted and its GIF read back by the port's
   decoder.

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
# A UNet call over a 2-entry mesh on one card (its rows split in two, the
# halves run one after the other) against the whole call on the same rows:
# only the GEMMs' and convolutions' row counts differ, which changes bf16
# rounding, so the two are held within the card-vs-CPU limit of one UNet
# call's eps (EPS_REL_TOL); the meshed call must equal its halves run
# directly bit for bit. A whole trajectory
# amplifies such bf16 differences step by step (resampling's cancellation,
# CFG 9), so the meshed sample is held against the unsharded one within
# RESAMPLE_RATIO_TOL (fusion) or VIDEO_RATIO_TOL (video) times the distance
# that rounding the initial latent to bf16 alone puts between two unsharded
# samples.
MESH_REL_TOL = EPS_REL_TOL
MESH_VIDEO_STEPS = 10  # the meshed video comparison's loop, cut from 50 for time
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
# below 1024 tokens, where TWEEDIEMIX_FLASH_MIN_S sends self-attention to the
# kernel: the video UNet's 256-token level (32 frames x 20 heads) and an S
# that is not a multiple of the kernel's 128-row query tile
S256_SHAPES = [(640, 256, 256, 64), (80, 200, 200, 64)]
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
# edge cases: S from 1 to 32, dh 32 and 128, fewer bands than SMs (3 rows);
# on an H100 tile_plan gives the last three tiles of 2, 4 and 2 pixel rows
# that N does not fill, the third at S past 16
SHORT_EDGE_SHAPES = [(300, 1, 4, 64), (300, 7, 4, 64), (300, 12, 5, 64), (300, 17, 5, 64),
                     (300, 32, 5, 64), (257, 16, 4, 32), (257, 16, 2, 128), (100, 32, 3, 128),
                     (257, 7, 5, 32), (3, 16, 2, 64), (2049, 16, 5, 64), (4097, 7, 5, 32),
                     (1699, 17, 5, 32)]
SHORT_CANARY = 4096  # bf16 elements of a sentinel before and after each case's output
# (M, K, N) of the SDXL W8A8 linear sites at 2 and 4 latent rows (the
# fusion's batch-2 and batch-4 calls): six a transformer block and
# proj_in/proj_out, 4096 tokens a row at 640 channels, 1024 at 1280
W8A8_LINEAR_SHAPES = [(rows * tokens, k, n) for rows in (2, 4)
                      for tokens, pairs in ((4096, ((640, 1920), (640, 640), (640, 5120),
                                                    (2560, 640))),
                                            (1024, ((1280, 3840), (1280, 1280), (1280, 10240),
                                                    (5120, 1280))))
                      for k, n in pairs]
W8A8_SITES = 442  # W8A8 linear sites per SDXL UNet call
VIDEO_W8A8_SITES = 264  # W8A8 linear sites per I2VGen-XL loop call (video_w8a8_shapes)
GN_SITES_SDXL = 46  # GroupNorm (ops/group_norm.py) calls per SDXL UNet call, 35 with SiLU
GN_SITES_VIDEO = 166  # per I2VGen-XL loop call, 133 with SiLU, 105 of them temporal
# the GroupNorm kernel at the exact (fp64) result on the same bf16 inputs: its
# max abs error at most this times PyTorch's bf16 F.group_norm (+ F.silu)
GN_ERR_RATIO_TOL = 1.05
KERNELS = ("flash_attention", "flash_attention_int8", "short_attention", "w8a8_linear",
           "group_norm")


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
        ptxas = cuda_build.build_dir() / f"{name}.ptxas.txt"
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
    from tweediemix_tpu_torch.utils.profiling import host_us_per_call

    results = []
    for bh, sq, sk, dh in MAIN_SHAPES + EDGE_SHAPES + VIDEO_FLASH_SHAPES + S256_SHAPES:
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
    from tweediemix_tpu_torch.utils.profiling import host_us_per_call

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


def phase_kernels_w8a8() -> tuple:
    """The two W8A8 linear launches (``csrc/w8a8_linear.cu``) against the
    plain version at the 16 SDXL site shapes and the I2VGen-XL loop call's
    22 (``video_w8a8_shapes``): x_q, the row scales and y bitwise, with a
    static and a dynamic scale and a bias; timed beside their bound, the
    plain version (``torch._int_mm`` plus the eager chain, what every site
    ran before, and so also the library yardstick ``library_ms``) and
    ``torch._int_mm`` alone on the same int8 operands, and the wrapper's host
    cost per call. Returns the SDXL rows and the video rows."""
    import torch

    from tweediemix_tpu_torch.models.unet3d import UNet3DConfig
    from tweediemix_tpu_torch.ops import quant
    from tweediemix_tpu_torch.utils.profiling import graph_ms, host_us_per_call
    from tweediemix_tpu_torch.video.pipeline import VideoConfig

    vcfg = VideoConfig()
    video_sites = video_w8a8_shapes(UNet3DConfig.i2vgen(), vcfg.latent_hw, vcfg.num_frames)
    if sum(video_sites.values()) != VIDEO_W8A8_SITES:
        fail(f"the I2VGen-XL loop call has {sum(video_sites.values())} W8A8 linear sites, "
             f"expected {VIDEO_W8A8_SITES}")
    sdxl, video = [], []
    for (m, k, n), rows in [(shape, sdxl) for shape in W8A8_LINEAR_SHAPES] + \
            [(shape, video) for shape in sorted(video_sites)]:
        gen = torch.Generator(device="cuda").manual_seed(m + k + n)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        wq, ws = quant.quantize_weight_int8(torch.randn((n, k), generator=gen, device="cuda")
                                            * k ** -0.5)
        bias = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
        amax = 0.5 * x.abs().max().item()
        xq_bytes = quant.w8a8_work_bytes(m, k, False)
        work = torch.empty(quant.w8a8_work_bytes(m, k, True), dtype=torch.uint8, device="cuda")
        for static in (amax, 0.0):
            y = quant.w8a8_matmul_cuda(x, wq, ws, static, bias, work=work)
            xq = work[: m * k].view(torch.int8).view(m, k)
            want_q, want_s = quant.quantize_activation_int8(x, static)
            want = quant.w8a8_matmul_reference(x, wq, ws, static, bias)
            torch.cuda.synchronize()
            if not (torch.equal(xq, want_q) and torch.equal(y, want)
                    and (static or torch.equal(work[xq_bytes:].view(torch.float32),
                                               want_s[:, 0]))):
                fail(f"w8a8_linear differs from its plain version at {(m, k, n)} "
                     f"({'static' if static else 'dynamic'} scale): "
                     f"{(y != want).sum().item()} outputs differ")
        err = (y.float() - want.float()).abs().max().item()
        # device time alone: a CUDA graph of launches (the plain version's static
        # scale is a host-to-device copy, which no graph takes: CUDA events)
        ms = graph_ms(lambda: quant.w8a8_matmul_cuda(x, wq, ws, amax, bias), 20)
        dynamic_ms = graph_ms(lambda: quant.w8a8_matmul_cuda(x, wq, ws, 0.0, bias), 20)
        stream_ms = cuda_ms(lambda: quant.w8a8_matmul_cuda(x, wq, ws, amax, bias), 20)
        plain_ms = cuda_ms(lambda: quant.w8a8_matmul_reference(x, wq, ws, amax, bias), 20)
        wt = wq.t()
        int_mm_ms = graph_ms(lambda: torch._int_mm(want_q, wt), 20)
        ops = 2.0 * m * n * k
        nbytes = 2.0 * m * k + 2.0 * m * n + 1.0 * n * k  # bf16 x and y, the int8 weight
        t_ops, t_bytes = ops / H100_INT8_OPS * 1e3, nbytes / H100_HBM_BYTES * 1e3
        row = dict(shape=[m, k, n], max_abs_err=err, rel_err=0.0, ms=ms, dynamic_ms=dynamic_ms,
                   stream_ms=stream_ms, plain_ms=plain_ms,
                   # the plain version is torch._int_mm plus the eager chain: the library yardstick
                   library_ms=plain_ms, int_mm_ms=int_mm_ms, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes", tops=ops / ms / 1e9)
        row["share_of_bound"] = row["bound_ms"] / ms
        if rows is video:
            row["sites_per_call"] = video_sites[(m, k, n)]
        log(f"w8a8_linear {(m, k, n)}: bitwise equal (static, dynamic); ms {ms:.4f} (dynamic "
            f"{dynamic_ms:.4f}, back to back {stream_ms:.4f}) plain_ms {plain_ms:.4f} int_mm_ms "
            f"{int_mm_ms:.4f} bound_ms "
            f"{row['bound_ms']:.4f} ({row['bound_by']}) {row['share_of_bound']:.1%} of bound, "
            f"{row['tops']:.1f} TOP/s")
        rows.append(row)
        del x, wq, ws, bias, y, xq, work, want_q, want_s, want, wt
        torch.cuda.empty_cache()
    x = torch.randn((16, 640), device="cuda").to(torch.bfloat16)
    wq = torch.zeros((640, 640), dtype=torch.int8, device="cuda")
    ws = torch.ones(640, device="cuda")
    sdxl[0]["host_us_per_call"] = host_us_per_call(lambda: quant.w8a8_matmul(x, wq, ws, 1.0))
    log(f"w8a8_linear host cost per call while the device is busy (median of 5 x 200 calls): "
        f"{sdxl[0]['host_us_per_call']:.2f} us")
    for label, rows in (("the 16 SDXL shapes", sdxl), ("the 22 video shapes", video)):
        log(f"w8a8_linear at {label}: {sum(r['ms'] for r in rows):.3f} ms, plain "
            f"{sum(r['plain_ms'] for r in rows):.3f} ms, bound "
            f"{sum(r['bound_ms'] for r in rows):.3f} ms")
    per_call = {k: sum(r[k] * r["sites_per_call"] for r in video) for k in ("ms", "bound_ms")}
    log(f"w8a8_linear over one I2VGen-XL loop call's {VIDEO_W8A8_SITES} sites: "
        f"{per_call['ms']:.3f} ms, bound {per_call['bound_ms']:.3f} ms")
    return sdxl, video


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
    from tweediemix_tpu_torch.ops.group_norm import group_norm

    n = 3  # cat + dog + background
    ucfg = UNetConfig.sdxl(concept_slots=n + 1, dtype=torch.bfloat16)
    vcfg = VAEConfig.sdxl()
    fcfg = FusionConfig(n_timesteps=50, guidance_scale=0.8, t_cond=0.2, resampling_steps=10,
                        jumping_steps=5, height=1024, width=1024, num_concepts=n)
    expected = expected_flash_launches(ucfg, fcfg)
    if expected != 5250:
        fail(f"expected 5250 flash launches for this config, the config gives {expected}")
    gn_expected = GN_SITES_SDXL * fcfg.unet_calls()  # 3450

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
        flash_attention.launches = group_norm.launches = 0
        gn_paths = dict(group_norm.paths)
        t0 = time.perf_counter()
        img = pipe.sample(embeds, seed=run, fg_masks=fg, num_seeds=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention.launches
        latent = pipe.last_latent
        stats = dict(
            s_per_image=wall, launches=launches, group_norm_launches=group_norm.launches,
            group_norm_paths={k: v - gn_paths[k] for k, v in group_norm.paths.items()},
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
        if group_norm.launches != gn_expected:
            fail(f"group_norm launched {group_norm.launches} times on the main path, expected "
                 f"{gn_expected}")
        runs.append(stats)
    # the launches on the card, from a trace of one more image: its UNet calls are replays
    flash_attention.launches = group_norm.launches = 0
    traced = traced_launches(lambda: pipe.sample(embeds, seed=2, fg_masks=fg, num_seeds=1),
                             ("flash_fwd_kernel", "group_norm_kernel"))
    traced["counter"] = flash_attention.launches
    traced["group_norm_counter"] = group_norm.launches
    log(f"main path traced image: {json.dumps(traced)}")
    if traced["kernels"]["flash_fwd_kernel"] != expected or traced["counter"] != expected:
        fail(f"main path traced image: {traced['kernels']['flash_fwd_kernel']} flash-kernel events "
             f"in the trace, the counter {traced['counter']}; expected {expected}")
    if traced["kernels"]["group_norm_kernel"] != gn_expected or group_norm.launches != gn_expected:
        fail(f"main path traced image: {traced['kernels']['group_norm_kernel']} group-norm events "
             f"in the trace, the counter {group_norm.launches}; expected {gn_expected}")
    mesh = mesh_fusion(pipe, embeds, fg, expected)
    # the fp32 decode alone: its mid-block attention holds a 16384 x 16384
    # fp32 score matrix (1 GiB) and its softmax
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pipe.decode_final(pipe.last_latent)
    torch.cuda.synchronize()
    decode_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"decode peak above the resident weights and latent: {decode_gib:.3f} GiB")
    return dict(runs=runs, expected_launches=expected, decode_peak_gib=decode_gib, mesh=mesh,
                traced=traced)


def two_entry_mesh():
    """``parallel/mesh.py``'s 2-way mesh on the one card: both entries are
    ``cuda:0``, so both halves of every split run on it, one after the
    other, through one UNet replica."""
    from tweediemix_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"dp": 2}, devices=["cuda:0", "cuda:0"])
    if mesh.size != 2 or mesh.group is not None:
        fail(f"the 2-entry mesh is {mesh}")
    return mesh


def _mesh_rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def mesh_fusion(pipe, embeds, fg, expected) -> dict:
    """Over ``two_entry_mesh()``: one fused UNet call of two seeds (8 rows)
    equal to its two 4-row halves called directly, and within
    ``MESH_REL_TOL`` of the whole call; then two seeds sampled
    unsharded and meshed, with the flash launches (each meshed UNet call is
    two calls, so twice the unsharded count), seconds and peak memory, and
    the meshed latent held to the unsharded one against the distance a bf16
    rounding of the initial latent makes (``MESH_REL_TOL``'s comment)."""
    import torch

    from tweediemix_tpu_torch.ops.flash_attention import flash_attention

    mesh = two_entry_mesh()
    n = pipe.fusion_config.num_concepts
    h, w = pipe.fusion_config.latent_hw
    dev = pipe.device
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2 * (n + 1), h, w, 4), generator=gen, device=dev)
    rows = (embeds.concept_ctx.repeat_interleave(2, 0), embeds.concept_pooled.repeat_interleave(2, 0),
            torch.arange(n + 1, device=dev).repeat_interleave(2))
    with torch.inference_mode():
        whole = pipe._unet_fn(x, 501, *rows)
        split = pipe.sampler_for(mesh).unet_fn(x, 501, *rows)
        halves = torch.cat([pipe._unet_fn(x[i:i + n + 1], 501, *(a[i:i + n + 1] for a in rows))
                            for i in (0, n + 1)])
    out = dict(call_rel_err=_mesh_rel(split, whole), call_equals_halves=torch.equal(split, halves))
    latents = {}
    x_init = pipe.sampler.init_latent(0, 2, dev)
    for label, mesh_devices, factor, start in (
            ("unsharded", 1, 1, x_init), ("mesh2", mesh, 2, x_init),
            ("unsharded_bf16_init", 1, 1, x_init.bfloat16().float())):
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        img = pipe.sample(embeds, fg_masks=fg, num_seeds=2, x_init=start, mesh_devices=mesh_devices)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        latents[label] = pipe.last_latent
        out[label] = dict(s_two_seeds=wall, launches=flash_attention.launches,
                          expected_launches=factor * expected,
                          phases={k: round(v, 4) for k, v in pipe.phase_seconds.items()},
                          max_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        if tuple(img.shape) != (2, 1024, 1024, 3) or not torch.isfinite(img).all():
            fail(f"{label} two-seed sample: shape {tuple(img.shape)} or non-finite values")
        if flash_attention.launches != factor * expected:
            fail(f"{label} two-seed sample launched the flash kernel {flash_attention.launches} "
                 f"times, expected {factor * expected}")
    out["rel_err"] = _mesh_rel(latents["mesh2"], latents["unsharded"])
    out["bf16_init_rel_err"] = _mesh_rel(latents["unsharded_bf16_init"], latents["unsharded"])
    out["latent_absmax"] = latents["unsharded"].abs().max().item()
    out["gpu"] = gpu_name_and_power()
    log(f"main path over a 2-entry mesh on cuda:0: {json.dumps(out)}")
    if not out["call_equals_halves"]:
        fail("a meshed UNet call differs from its halves called directly")
    if out["call_rel_err"] > MESH_REL_TOL:
        fail(f"a meshed UNet call is {out['call_rel_err']:.3e} of max |eps| from the whole "
             f"call (limit {MESH_REL_TOL})")
    if out["rel_err"] > RESAMPLE_RATIO_TOL * out["bf16_init_rel_err"]:
        fail(f"the meshed two-seed latent is {out['rel_err']:.3e} of max |latent| from the "
             f"unsharded one, more than {RESAMPLE_RATIO_TOL} x the {out['bf16_init_rel_err']:.3e} "
             "a bf16 initial latent makes")
    return out


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


def write_tokenizers(root, vocab_size=49408,
                     folders=(("tokenizer", "<|endoftext|>"), ("tokenizer_2", "!"))) -> int:
    """``tokenizer/`` and ``tokenizer_2/`` with a synthetic CLIP vocabulary
    of ``vocab_size`` entries (the 256 bytes, each with ``</w>``, a few
    merges, filler, then ``<|startoftext|>`` and ``<|endoftext|>`` last);
    the second pads with "!", as SDXL's does (``folders``: (folder, pad
    token) pairs; "" is ``root`` itself). Returns the bytes written."""
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
    for folder, pad in folders:
        os.makedirs(os.path.join(root, folder), exist_ok=not folder)
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
        torch.cuda.empty_cache()
        stats["serve"] = phase_cli_serve(root, argv, expected, os.path.join(out, pngs[0]), stats)
        torch.cuda.empty_cache()
        stats["profile"] = phase_cli_profile(root, argv)
        torch.cuda.empty_cache()
        stats["evaluate"] = phase_cli_evaluate(root, stats["serve"]["dir"],
                                               os.path.join(root, "train_instance"))
        torch.cuda.empty_cache()
        stats["app"] = phase_app(os.path.join(root, "sam_vit_h.pth"),
                                 os.path.join(root, "owlvit-base-patch32"), keep_png)
        return stats
    finally:
        fusion_sampling.build_pipeline = build_pipeline
        shutil.rmtree(root)


def _arg(argv, name):
    return argv[argv.index(f"--{name}") + 1]


def phase_cli_serve(root, argv, expected, one_shot_png, one_shot) -> dict:
    """The warm server (``cli/serve.py``) in process on ``phase_cli``'s SDXL
    directory with its flags: ``a`` at the one-shot CLI's seed (its PNG must
    be the one-shot CLI's ``one_shot_png``, pixel for pixel), ``bad`` with
    two concepts for three (an error line), ``b`` at a new seed (warm), ``c``
    a "||" pair at num_seeds 2 (a new geometry, not warm), then an empty
    line. Each request's flash launches are counted between the lines."""
    import contextlib
    import io

    import numpy as np
    import torch

    from tweediemix_tpu_torch.cli import serve
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention
    from tweediemix_tpu_torch.utils.image import read_png

    served = os.path.join(root, "served")
    prompt, prompt_orig = _arg(argv, "prompt"), _arg(argv, "prompt_orig")
    seed = int(_arg(argv, "seed"))
    reqs = [
        {"id": "a", "seed": seed, "output_path": served},
        {"id": "bad", "prompt": "+".join(prompt.split("+")[:2]), "output_path": served},
        {"id": "b", "seed": seed + 1, "output_path": served},
        {"id": "c", "seed": seed + 2, "num_seeds": 2, "output_path": served,
         "prompt": prompt + "||" + prompt.replace("running", "sitting"),
         "prompt_orig": prompt_orig + "||" + prompt_orig.replace("running", "sitting")},
    ]
    before = []

    def lines():  # the launch count before each line: the previous request's are the difference
        for req in reqs + [None]:
            before.append(flash_attention.launches)
            yield "\n" if req is None else json.dumps(req) + "\n"

    stdout, stderr = io.StringIO(), io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(stderr):
        rc = serve.main(argv, stdin=lines(), stdout=stdout, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(stderr.getvalue().strip())
    log(stdout.getvalue().strip())
    if rc != 0:
        fail(f"the server returned {rc}")
    resp = [json.loads(line) for line in stdout.getvalue().splitlines()]
    launches = [b - a for a, b in zip(before, before[1:])]
    if [r.get("id") for r in resp] != ["a", "bad", "b", "c"]:
        fail(f"the server answered {resp}")
    status = [r["status"] for r in resp]
    warm = [r.get("warm") for r in resp]
    if status != ["ok", "error", "ok", "ok"] or warm != [False, None, True, False]:
        fail(f"server status {status}, warm {warm}: expected ok/error/ok/ok, false/-/true/false")
    if launches != [expected, 0, expected, expected]:
        fail(f"server flash launches per request {launches}, expected {expected} per ok request")
    if [len(r["files"]) for r in resp if r["status"] == "ok"] != [1, 1, 2]:
        fail(f"server files {[r.get('files') for r in resp]}")
    header, a_pixels = read_png(resp[0]["files"][0])
    _, one_shot_pixels = read_png(one_shot_png)
    a_equal = bool(np.array_equal(a_pixels, one_shot_pixels))
    for r in resp[2:]:
        for f in r["files"]:
            h, px = read_png(f)
            if h != header or px.min() == px.max():
                fail(f"served PNG {f}: {h}, pixels {px.min()}..{px.max()}")
    timings = json.loads(stderr.getvalue().split("timings: ", 1)[1].splitlines()[0])
    stats = dict(
        gpu=gpu_name_and_power(), dir=served, wall_s=wall, load_s=timings["load_s"],
        build_s=timings["build_s"], latency_s=[r.get("latency_s") for r in resp], warm=warm,
        launches=launches, max_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        a_equals_one_shot_png=a_equal,
        a_max_pixel_diff=int(np.abs(a_pixels.astype(int) - one_shot_pixels.astype(int)).max()),
        one_shot_load_build_sample_s=one_shot["load_s"] + one_shot["build_s"] + one_shot["s_per_image"],
        one_shot_cli_wall_s=one_shot["cli_wall_s"], error=resp[1]["error"])
    log(f"cli serve: {json.dumps(stats)}")
    if not a_equal:
        fail("the server's PNG for the one-shot CLI's seed differs from the one-shot CLI's")
    return stats


def phase_cli_profile(root, argv) -> dict:
    """The fusion CLI with ``--profile`` on ``phase_cli``'s SDXL directory,
    cut to ``MASK_DIR_FUSION``'s 4 steps without resampling (t_cond 0.5 and
    one jumping step, so that the 4-step schedule is valid; a 50-step trace
    is hundreds of MB):
    ``phase_timings.json`` holds ``sample_1_seeds``, the Chrome trace holds
    one flash-kernel event per expected launch, counted by the kernel's
    name (``models/unet_graph.py::kernel_launches``). ``spans.json`` holds
    one ``request`` span and a ``unet`` span per sampler step, on the trace's
    clock (``span_kernel_leads``)."""
    import torch

    from tweediemix_tpu_torch.cli import fusion_sampling
    from tweediemix_tpu_torch.fusion.sampler import FusionConfig
    from tweediemix_tpu_torch.models.unet2d import UNetConfig
    from tweediemix_tpu_torch.models.unet_graph import kernel_launches
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention
    from tweediemix_tpu_torch.utils.profiling import SPANS_FILE, TRACE_FILE

    cut = MASK_DIR_FUSION
    fcfg = FusionConfig(**dict(CLI_FUSION, **cut))
    expected = expected_flash_launches(UNetConfig.sdxl(concept_slots=4, dtype=torch.bfloat16), fcfg)
    prof_dir = os.path.join(root, "profile")
    pargv = _flag(argv, "output_path", os.path.join(root, "out_profile")) + ["--profile", prof_dir]
    for flag, value in cut.items():
        pargv = _flag(pargv, flag, value)
    flash_attention.launches = 0
    rc, text, wall = run_cli(fusion_sampling.main, pargv)
    launches = flash_attention.launches
    if rc != 0 or launches != expected:
        fail(f"the fusion CLI with --profile returned {rc} with {launches} flash launches "
             f"(expected {expected})")
    with open(os.path.join(prof_dir, "phase_timings.json")) as f:
        phases = json.load(f)
    trace_path = os.path.join(prof_dir, TRACE_FILE)
    if "sample_1_seeds" not in phases or not os.path.exists(trace_path):
        fail(f"--profile wrote {sorted(os.listdir(prof_dir))}, phases {phases}")
    with open(trace_path) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel" and e.get("ph") == "X"]
    named = kernel_launches(kernels, "flash_fwd_kernel")
    with open(os.path.join(prof_dir, SPANS_FILE)) as f:
        kept = json.load(f)
    clock = span_kernel_leads(trace_path, kept)
    names = [s["name"] for s in kept["spans"]]
    stats = dict(gpu=gpu_name_and_power(), cli_wall_s=wall, phases=phases,
                 timings=json.loads(text.split("timings: ", 1)[1].splitlines()[0]),
                 trace_bytes=os.path.getsize(trace_path), kernel_events=len(kernels),
                 expected_launches=expected, launches=launches, trace_flash_events=named,
                 spans=len(names), unet_spans=names.count("unet"),
                 step_spans=names.count("fusion.step"), syncs_per_step=[
                     s["syncs"] for s in kept["spans"] if s["name"] == "fusion.step"],
                 clock=clock)
    log(f"cli profile: {json.dumps(stats)}")
    if named != expected:
        fail(f"the trace holds {named} flash-kernel events; expected {expected}")
    if names.count("request") != 1 or not names.count("unet") or (
            names.count("unet") != names.count("fusion.step")):
        fail(f"spans.json holds {names.count('request')} request spans, "
             f"{names.count('unet')} unet spans and {names.count('fusion.step')} steps")
    # the spans share the trace's host clock: each opens before its range and
    # closes after it, and holds the launches the range holds, no more; and
    # its kernels start no earlier than its start, but for the skew between
    # the profiler's device and host timelines measured in the same trace
    if (clock["spans"] != clock["ranges"] or not clock["kernels"]
            or clock["kernels"] != clock["kernels_in_ranges"]
            or clock["range_offset"][0] < 0 or clock["end_offset"] < 0
            or clock["kernel_lead"] < min(0.0, clock["kernel_after_launch"])):
        fail(f"the unet spans and their ranges in the trace disagree: {clock}")
    return stats


def span_kernel_leads(trace_path: str, kept: dict) -> dict:
    """How the ``unet`` spans of ``kept`` (a ``spans.json``) lie on the
    Chrome trace's clock, in µs: each span's start and end against its own
    range in the trace (``range_offset``: the range opens this much later;
    ``end_offset``: it closes this much earlier), the kernels launched while
    the spans were open (found through their launches' correlation ids)
    against those launched inside the ranges, and those kernels' device
    start against the span's start (``kernel_lead``, the least) and against
    their own launch (``kernel_after_launch``, the least: the profiler's
    own skew between its device and host timelines where negative)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    base = kept["baseTimeNanoseconds"]
    start = {e["args"]["correlation"]: e["ts"] for e in events
             if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("cat") == "cuda_runtime" and "Launch" in e["name"]
                      and e.get("args", {}).get("correlation") in start)
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("name") == "unet" and e.get("cat") == "user_annotation")
    unets = [s for s in kept["spans"] if s["name"] == "unet"]
    opened, closed, leads, after, in_ranges = [], [], [], [], 0
    for (r0, r1), s in zip(ranges, unets):
        lo, hi = (s["start_ns"] - base) / 1e3, (s["end_ns"] - base) / 1e3
        opened.append(r0 - lo)
        closed.append(hi - r1)
        inside = [(t, c) for t, c in launches if lo <= t <= hi]
        in_ranges += sum(r0 <= t <= r1 for t, _ in launches)
        leads += [start[c] - lo for _, c in inside]
        after += [start[c] - t for t, c in inside]
    return dict(spans=len(unets), ranges=len(ranges),
                range_offset=[min(opened, default=None), max(opened, default=None)],
                end_offset=min(closed, default=None), kernels=len(leads),
                kernels_in_ranges=in_ranges, kernel_lead=min(leads, default=None),
                kernel_after_launch=min(after, default=None))


# openai/clip-vit-large-patch14: the text tower (SDXL's text_encoder) and a
# ViT-L/14 at 224², both projected to 768, and the contrastive temperature
CLIP_L14_PUBLISHED_PARAMS = 427_616_513
CLIP_SCORE_TOL = 1e-4  # each score, card fp32 (TF32 off) against the CPU
CLIP_EVAL_PROMPT = "photo of a <cat1> cat and a <dog1> dog running"


def write_clip_model_dir(root, seed, device) -> dict:
    """An HF CLIPModel directory at openai/clip-vit-large-patch14's widths
    with seeded random weights in fp32 (one ``model.safetensors`` holding
    both towers, the projections, ``logit_scale`` and the position-id
    buffers), its ``config.json`` and the synthetic BPE files of
    ``write_tokenizers``. Returns the parameters and bytes written."""
    import torch

    from tweediemix_tpu_torch.models.clip import (
        CLIPTextConfig,
        CLIPTextModel,
        CLIPVisionConfig,
        CLIPVisionModel,
    )
    from tweediemix_tpu_torch.models.convert import save_safetensors

    tcfg = CLIPTextConfig(projection_dim=768)
    vcfg = CLIPVisionConfig(projection_dim=768)
    torch.manual_seed(seed)
    state = {}
    for module in (CLIPTextModel(tcfg, device=device), CLIPVisionModel(vcfg, device=device)):
        state.update(module.state_dict())
    state["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    params = sum(t.numel() for t in state.values())
    state["text_model.embeddings.position_ids"] = torch.arange(tcfg.max_positions)[None]
    state["vision_model.embeddings.position_ids"] = torch.arange(vcfg.num_patches + 1)[None]
    os.makedirs(root)
    written = save_safetensors(os.path.join(root, "model.safetensors"), state)
    config = dict(  # HF's names; its historical text eos_token_id of 2
        projection_dim=tcfg.projection_dim, logit_scale_init_value=2.6592,
        text_config=dict(vocab_size=tcfg.vocab_size, hidden_size=tcfg.hidden_size,
                         intermediate_size=tcfg.intermediate_size,
                         num_hidden_layers=tcfg.num_layers, num_attention_heads=tcfg.num_heads,
                         max_position_embeddings=tcfg.max_positions, hidden_act=tcfg.hidden_act,
                         eos_token_id=2),
        vision_config=dict(image_size=vcfg.image_size, patch_size=vcfg.patch_size,
                           hidden_size=vcfg.hidden_size, intermediate_size=vcfg.intermediate_size,
                           num_hidden_layers=vcfg.num_layers, num_attention_heads=vcfg.num_heads,
                           hidden_act=vcfg.hidden_act))
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(config, f)
    written += write_tokenizers(root, folders=(("", "<|endoftext|>"),))
    return dict(params=params, bytes=written)


def phase_cli_evaluate(root, served_dir, instance_dir) -> dict:
    """CLIP-T and CLIP-I of the served PNGs against the training phase's
    instance images, from a CLIP ViT-L/14-width directory of seeded random
    weights: the evaluate CLI on the card, then the scores on the card and
    the CPU held within ``CLIP_SCORE_TOL``."""
    import torch

    from tweediemix_tpu_torch.cli import evaluate
    from tweediemix_tpu_torch.evaluation import CLIPScorer, load_images

    clip_dir = os.path.join(root, "clip-vit-large-patch14")
    t0 = time.perf_counter()
    written = write_clip_model_dir(clip_dir, seed=8, device="cuda")
    write_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    if written["params"] != CLIP_L14_PUBLISHED_PARAMS:
        fail(f"CLIP directory holds {written['params']} parameters, "
             f"openai/clip-vit-large-patch14 {CLIP_L14_PUBLISHED_PARAMS}")
    modifiers = ["<cat1>", "<dog1>"]
    argv = ["--images", served_dir, "--prompt", CLIP_EVAL_PROMPT, "--modifier_token",
            "+".join(modifiers), "--concept_images", instance_dir, "--concepts", "cat",
            "--clip_dir", clip_dir]
    torch.cuda.reset_peak_memory_stats()
    rc, text, wall = run_cli(evaluate.main, argv)
    if rc != 0:
        fail(f"the evaluate CLI returned {rc}")
    line = json.loads(text.strip().splitlines()[-1])
    max_memory = torch.cuda.max_memory_allocated() / 2**30
    images, instances = load_images(served_dir), load_images(instance_dir)
    if line["num_images"] != len(images) or set(line.get("clip_i", {})) != {"cat"}:
        fail(f"the evaluate CLI printed {line}")
    got = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        scorer = CLIPScorer.from_pretrained(clip_dir, device=device)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = evaluate.scores(scorer, images, [CLIP_EVAL_PROMPT], modifiers, [instance_dir], ["cat"])
        if device == "cuda":
            torch.cuda.synchronize()
        got[device] = dict(res, load_s=load_s, score_s=time.perf_counter() - t0)
        del scorer
    torch.cuda.empty_cache()
    err = max(abs(got["cuda"]["clip_t"] - got["cpu"]["clip_t"]),
              abs(got["cuda"]["clip_i"]["cat"] - got["cpu"]["clip_i"]["cat"]))
    stats = dict(gpu=gpu_name_and_power(), params=written["params"], bytes=written["bytes"],
                 write_s=write_s, cli_wall_s=wall, cli_line=line, max_memory_gib=max_memory,
                 num_images=len(images), num_instance_images=len(instances),
                 card=got["cuda"], cpu=got["cpu"], max_abs_score_err=err)
    log(f"cli evaluate: {json.dumps(stats)}")
    if not all(math.isfinite(v) for v in (got["cuda"]["clip_t"], got["cuda"]["clip_i"]["cat"])):
        fail("non-finite CLIP scores")
    if err > CLIP_SCORE_TOL:
        fail(f"CLIP scores on the card vs the CPU differ by {err:.3e} (limit {CLIP_SCORE_TOL})")
    if abs(round(got["cuda"]["clip_t"], 4) - line["clip_t"]) > CLIP_SCORE_TOL:
        fail(f"the CLI's clip_t {line['clip_t']} is not the scorer's {got['cuda']['clip_t']}")
    return stats


def phase_app(sam_path, det_dir, png) -> dict:
    """The demo's predict function (``cli/app.py``, preset ``sam``) on the
    card from ``phase_cli_segmentation``'s SAM ViT-H ``.pth`` and OWL-ViT
    directory, on the fusion PNG: per phrase its overlay must equal
    ``draw_image`` over ``LangSAM.predict``'s kept masks and boxes."""
    import numpy as np
    import torch

    from tweediemix_tpu_torch.cli import app
    from tweediemix_tpu_torch.segmentation.viz import draw_image
    from tweediemix_tpu_torch.utils.image import read_image

    t0 = time.perf_counter()
    predict = app.make_predict_fn("sam", sam_path, det_dir, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    image = read_image(png).astype(np.float32) / 255.0
    out = {}
    for text in SEG_CONCEPTS.split("+"):
        overlay = predict(image, text, box_threshold=0.2)
        t0 = time.perf_counter()
        for _ in range(3):
            overlay = predict(image, text, box_threshold=0.2)
        ms = (time.perf_counter() - t0) / 3 * 1e3
        masks, boxes, scores, valid = predict.lang_sam.predict(torch.from_numpy(image), text,
                                                               box_threshold=0.2)
        keep = valid.cpu().numpy()
        want = draw_image(image, masks.float().cpu().numpy()[keep], boxes.cpu().numpy()[keep])
        out[text] = dict(ms_per_predict=ms, kept=int(keep.sum()), top_score=float(scores.max()),
                         equal=bool(np.array_equal(overlay, want)),
                         changed_share=float((overlay != image).any(-1).mean()))
        if overlay.shape != image.shape or not out[text]["equal"]:
            fail(f"the demo's overlay for {text!r} differs from draw_image over LangSAM.predict")
    stats = dict(gpu=gpu_name_and_power(), load_s=load_s, phrases=out)
    log(f"app: {json.dumps(stats)}")
    if not any(v["kept"] for v in out.values()):
        fail("the demo kept no box for any phrase")
    del predict
    torch.cuda.empty_cache()
    return stats


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
    layer held to fp32 on the CPU within ``SEG_REL_TOL`` of their max.
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
    from tweediemix_tpu_torch.ops.group_norm import group_norm
    from tweediemix_tpu_torch.ops.quant import load_static_scales, quant_sites, w8a8_matmul_cuda
    from tweediemix_tpu_torch.tools.calibrate_quant import calibrate_unet, probe_inputs

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

    # static scales for these weights, by the calibration tool's function
    h, _ = fcfg.latent_hw
    b = n + 1
    t0 = time.perf_counter()
    table = calibrate_unet(pipe.unet, probe_inputs(b, h, 77, 2048, 1280, seed=0), margin=1.25)
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
            quantize_qkv_int8_fused.launches = w8a8_matmul_cuda.launches = 0
            t0 = time.perf_counter()
            img = pipe.sample(embeds, seed=run, fg_masks=fg, num_seeds=seeds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = flash_attention_int8.launches
            stats = dict(
                s_per_call=wall, s_per_image=wall / seeds, int8_launches=launches,
                quantize_launches=quantize_qkv_int8_fused.launches,
                w8a8_launches=w8a8_matmul_cuda.launches,
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
            if w8a8_matmul_cuda.launches != W8A8_SITES * fcfg.unet_calls():
                fail(f"W8A8 main path: the W8A8 linear kernels ran {w8a8_matmul_cuda.launches} "
                     f"times, expected {W8A8_SITES} x {fcfg.unet_calls()} UNet calls")
            runs.append(stats)
        # the launches on the card, from a trace of one more sample: its UNet calls are replays
        flash_attention.launches = flash_attention_int8.launches = 0
        quantize_qkv_int8_fused.launches = w8a8_matmul_cuda.launches = group_norm.launches = 0
        traced = traced_launches(
            lambda: pipe.sample(embeds, seed=2, fg_masks=fg, num_seeds=seeds),
            ("flash_int8_wgmma_kernel", "quantize_kernel", "w8a8_int8_gemm_kernel",
             "flash_fwd_kernel", "group_norm_kernel"))
        traced["counters"] = dict(flash_int8_wgmma_kernel=flash_attention_int8.launches,
                                  quantize_kernel=quantize_qkv_int8_fused.launches,
                                  w8a8_int8_gemm_kernel=w8a8_matmul_cuda.launches,
                                  flash_fwd_kernel=flash_attention.launches,
                                  group_norm_kernel=group_norm.launches)
        log(f"W8A8 main path traced sample: {json.dumps(traced)}")
        want = dict(flash_int8_wgmma_kernel=expected, quantize_kernel=expected,
                    w8a8_int8_gemm_kernel=W8A8_SITES * fcfg.unet_calls(), flash_fwd_kernel=0,
                    group_norm_kernel=GN_SITES_SDXL * fcfg.unet_calls())
        if traced["kernels"] != want or traced["counters"] != want:
            fail(f"W8A8 main path traced sample: kernel events {traced['kernels']}, counters "
                 f"{traced['counters']}; expected {want}")
        call = (embeds.concept_ctx, embeds.concept_pooled, torch.arange(b, device="cuda"))
        syncs = count_syncs(pipe, *call)
        log(f"W8A8 main path: {syncs} synchronising CUDA operations in one replayed UNet call")
        if syncs != 0:
            fail(f"W8A8 main path: {syncs} host syncs in one replayed UNet call, expected 0")
    finally:
        os.environ.pop("TWEEDIEMIX_FLASH_INT8", None)
    return dict(runs=runs, expected_launches=expected, unet_gib=unet_gib, syncs_per_call=syncs,
                traced=traced)


def count_syncs(pipe, ctx, pooled, idx) -> int:
    """Synchronising CUDA operations in one fusion UNet call as the sampler
    makes it (a replay of its CUDA graph, captured by an earlier call of its
    shape), as PyTorch's sync debug mode warns of them."""
    import warnings

    import torch

    from tweediemix_tpu_torch.utils.profiling import SYNC_WARNING

    h, w = pipe.fusion_config.latent_hw
    x = torch.randn((idx.shape[0], h, w, 4), device="cuda")
    with torch.inference_mode():
        pipe._unet_fn(x, 501, ctx, pooled, idx)
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                pipe._unet_fn(x, 501, ctx, pooled, idx)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize()
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def group_norm_sites() -> dict:
    """The GroupNorm calls of one UNet call, from a forward on the ``meta``
    device with the op and the attention cores stubbed: for the SDXL call at
    2 and 4 rows and the I2VGen-XL loop call, {(x shape, groups, silu):
    count}."""
    from collections import Counter

    import torch

    from tweediemix_tpu_torch.models import unet2d, unet3d
    from tweediemix_tpu_torch.ops import attention, short_attention
    from tweediemix_tpu_torch.video.pipeline import VideoConfig

    seen = Counter()

    def spy(x, num_groups, weight=None, bias=None, eps=1e-5, silu=False):
        seen[(tuple(x.shape), num_groups, silu)] += 1
        return torch.empty_like(x)

    saved = (unet2d.group_norm, attention.attention, short_attention.short_seq_attention)
    unet2d.group_norm = spy
    attention.attention = lambda q, k, v, scale=None: torch.empty_like(q)
    short_attention.short_seq_attention = lambda q, k, v, heads, scale: torch.empty_like(q)
    meta = dict(device="meta", dtype=torch.bfloat16)
    sites = {}
    try:
        unet = unet2d.UNet2DConditionModel(
            unet2d.UNetConfig.sdxl(concept_slots=4, dtype=torch.bfloat16), device="meta")
        for rows in (2, 4):
            seen.clear()
            with torch.inference_mode():
                unet(torch.empty((rows, 128, 128, 4), **meta), 501,
                     torch.empty((rows, 77, 2048), **meta), torch.empty((rows, 1280), **meta),
                     torch.empty((rows, 6), **meta), torch.zeros(rows, dtype=torch.long, device="meta"))
            sites[f"sdxl_{rows}_rows"] = dict(seen)
        ucfg = unet3d.UNet3DConfig.i2vgen(dtype=torch.bfloat16)
        vcfg = VideoConfig()
        unet = unet3d.UNet3DConditionModel(ucfg, device="meta")
        h, w = vcfg.latent_hw
        x = torch.empty((2, vcfg.num_frames, h, w, 4), **meta)
        ctx = torch.empty((2, 77, ucfg.cross_attention_dim), **meta)
        emb = torch.empty((2, ucfg.cross_attention_dim), **meta)
        fps = torch.full((2,), float(vcfg.fps), device="meta")
        seen.clear()
        with torch.inference_mode():
            cctx, cil, kv = unet3d.precompute_video_cache(unet, ctx, x, emb, fps)
            unet(x, 501, ctx, x, emb, fps, False, False, vcfg.interp_ratio, cached_ctx=cctx,
                 cached_il=cil, cross_kv=kv)
        sites["video"] = dict(seen)
    finally:
        unet2d.group_norm, attention.attention, short_attention.short_seq_attention = saved
    for name, want in (("sdxl_2_rows", GN_SITES_SDXL), ("sdxl_4_rows", GN_SITES_SDXL),
                       ("video", GN_SITES_VIDEO)):
        if sum(sites[name].values()) != want:
            fail(f"{name}: {sum(sites[name].values())} GroupNorm calls a UNet call, expected {want}")
    return sites


def phase_kernels_group_norm() -> dict:
    """The GroupNorm kernel (``csrc/group_norm.cu``) at every GroupNorm shape
    of the SDXL call (2 and 4 rows) and the I2VGen-XL loop call, bf16: its
    max abs error against the exact (fp64) computation on the same inputs
    within GN_ERR_RATIO_TOL times that of PyTorch's bf16 composition; times
    on the device alone (``utils/profiling.py``): ``ms`` from a CUDA graph of
    launches, ``flushed_ms`` with the L2 flushed between launches (the share
    of the bytes bound is taken from it); the plain version (``F.group_norm``
    then ``F.silu``, what the models ran before, and so also the library
    call) and its flushed time. Sums per UNet call weight each shape by its
    sites."""
    import torch

    from tweediemix_tpu_torch.ops import group_norm as gn_module
    from tweediemix_tpu_torch.ops.group_norm import group_norm, group_norm_reference
    from tweediemix_tpu_torch.utils.profiling import flushed_ms, graph_ms, host_us_per_call

    sites = group_norm_sites()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = sorted({key for calls in sites.values() for key in calls},
                    key=lambda k: (-math.prod(k[0]), k))
    rows = {}
    for shape, groups, silu in shapes:
        gen = torch.Generator(device="cuda").manual_seed(len(rows) + 21)
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        w = (1.0 + 0.2 * torch.randn(shape[1], generator=gen, device="cuda")).to(torch.bfloat16)
        b = (0.2 * torch.randn(shape[1], generator=gen, device="cuda")).to(torch.bfloat16)
        eps = 1e-5
        exact = group_norm_reference(x.double(), groups, w.double(), b.double(), eps, silu)
        got = group_norm(x, groups, w, b, eps, silu=silu)
        lib = group_norm_reference(x, groups, w, b, eps, silu)
        err = (got.double() - exact).abs().max().item()
        lib_err = (lib.double() - exact).abs().max().item()
        scale = exact.abs().max().item()
        del exact, got, lib
        if not err <= GN_ERR_RATIO_TOL * lib_err:
            fail(f"group_norm at {shape} G={groups} silu={silu}: max err {err:.3e} > "
                 f"{GN_ERR_RATIO_TOL} x PyTorch's {lib_err:.3e}")

        def kernel():
            return group_norm(x, groups, w, b, eps, silu=silu)

        def plain():
            return group_norm_reference(x, groups, w, b, eps, silu)

        n, c = shape[:2]
        spatial = x.numel() // (n * c)
        plan = gn_module.launch_plan(n * groups, c // groups * spatial, spatial, c // groups, 2,
                                     True, sms)
        nbytes = 2.0 * x.numel() * 2 + 2 * c * 2  # x read once, y written once, gamma and beta
        bound_ms = nbytes / H100_HBM_BYTES * 1e3
        ms, cold_ms = graph_ms(kernel, 20), flushed_ms(kernel, 10)
        plain_ms, plain_cold_ms = graph_ms(plain, 10), flushed_ms(plain, 5)
        row = dict(shape=list(shape), groups=groups, silu=silu, cluster=plan.cluster,
                   threads=plan.threads, one_read=plan.one_read, max_abs_err=err,
                   rel_err=err / scale, pytorch_max_abs_err=lib_err, ms=ms, flushed_ms=cold_ms,
                   plain_ms=plain_ms, plain_flushed_ms=plain_cold_ms, library_ms=plain_ms,
                   bound_ms=bound_ms, bound_by="bytes", share_of_bound=bound_ms / cold_ms,
                   gbytes_per_s=nbytes / cold_ms / 1e6)
        rows[(shape, groups, silu)] = row
        log(f"group_norm {shape} G={groups} silu={silu} cluster {plan.cluster} x {plan.threads} "
            f"{'one read' if plan.one_read else 'two reads'}: max_abs_err {err:.3e} (PyTorch "
            f"{lib_err:.3e}) ms {ms:.4f} flushed_ms {cold_ms:.4f} plain_ms {plain_ms:.4f} "
            f"plain_flushed_ms {plain_cold_ms:.4f} bound_ms {bound_ms:.4f} share "
            f"{row['share_of_bound']:.3f} {row['gbytes_per_s']:.0f} GB/s")
        del x
    per_call = {}
    for name, calls in sites.items():
        total = {k: sum(rows[key][k] * m for key, m in calls.items())
                 for k in ("ms", "flushed_ms", "plain_ms", "plain_flushed_ms", "bound_ms")}
        total["sites"] = sum(calls.values())
        total["one_read_share"] = sum(m for key, m in calls.items()
                                      if rows[key]["one_read"]) / total["sites"]
        per_call[name] = total
        log(f"group_norm per {name} call: {json.dumps(total)}")
    head = rows[shapes[0]]
    x = torch.randn(shapes[0][0], device="cuda").to(torch.bfloat16)
    head["host_us_per_call"] = host_us_per_call(lambda: group_norm(x, shapes[0][1], silu=True))
    head["library_host_us_per_call"] = host_us_per_call(
        lambda: group_norm_reference(x, shapes[0][1], silu=True))
    log(f"group_norm host us per call at {shapes[0][0]}: {head['host_us_per_call']:.2f} "
        f"(F.group_norm + F.silu {head['library_host_us_per_call']:.2f})")
    return dict(rows=list(rows.values()), per_call=per_call)


def phase_kernels_short() -> list:
    """The short-sequence kernel against its plain version on the same bf16
    inputs: q/k/v as views of one merged projection (as the model gives
    them) and contiguous, at the video path's shapes and the edge cases,
    each written into a buffer with a sentinel before and after its output
    that must survive. Times are device-only (``utils/profiling.py``, as
    ``tools/short_timing.py`` takes them): ``ms`` from a CUDA graph of 50 launches,
    ``flushed_ms`` with the L2 flushed between launches (the share of the
    bytes bound is taken from it), and at the main shapes the wrapper's host
    microseconds per call."""
    import torch
    import torch.nn.functional as F

    from tweediemix_tpu_torch.ops import short_attention as short_module
    from tweediemix_tpu_torch.ops.short_attention import (
        short_seq_attention,
        short_seq_attention_reference,
    )
    from tweediemix_tpu_torch.tools.short_timing import short_inputs
    from tweediemix_tpu_torch.utils.profiling import flushed_ms, graph_ms, host_us_per_call

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = []
    cases = [(shape, merged) for shape in SHORT_MAIN_SHAPES for merged in (True, False)]
    cases += [(shape, True) for shape in SHORT_EDGE_SHAPES] + [("negative", False)]
    for shape, merged in cases:
        main_shape = shape in SHORT_MAIN_SHAPES
        if shape == "negative":  # anti-aligned q/k: scores far below zero
            gen = torch.Generator(device="cuda").manual_seed(len(results) + 3)
            n, s, heads, dh = 64, 16, 2, 32
            q = torch.full((n, s, heads * dh), 8.0, device="cuda")
            k = -8.0 * (1.0 + 0.01 * torch.randn(q.shape, generator=gen, device="cuda"))
            v = torch.randn(q.shape, generator=gen, device="cuda")
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        else:
            n, s, heads, dh = shape
            q, k, v = short_inputs(n, s, heads, dh, merged, seed=len(results) + 3)
        d = heads * dh
        plan = short_module.tile_plan(n, s, heads, dh, sms)
        fill = torch.finfo(torch.bfloat16).max
        big = torch.full((n * s * d + 2 * SHORT_CANARY,), fill, device="cuda", dtype=torch.bfloat16)
        out = big[SHORT_CANARY:SHORT_CANARY + n * s * d].view(n, s, d)
        short_module._launch_cuda(q, k, v, heads, dh**-0.5, out=out)
        ref = short_seq_attention_reference(q.float(), k.float(), v.float(), heads)
        torch.cuda.synchronize()
        canary_ok = bool((big[:SHORT_CANARY] == fill).all()
                         and (big[SHORT_CANARY + n * s * d:] == fill).all())
        del big
        if not canary_ok:
            fail(f"short_attention wrote outside its output at {shape}")
        if not torch.isfinite(out).all():
            fail(f"short_attention non-finite output at {shape}")
        err = (out.float() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        if not rel <= FLASH_REL_TOL:
            fail(f"short_attention disagrees with its plain version at {shape}: "
                 f"max err / max |plain| = {rel:.3e} > {FLASH_REL_TOL}")

        def kernel():
            return short_seq_attention(q, k, v, heads)

        ms, cold_ms = graph_ms(kernel), flushed_ms(kernel)
        plain_ms = graph_ms(lambda: short_seq_attention_reference(q, k, v, heads), 10)
        q4, k4, v4 = (t.view(n, s, heads, dh).transpose(1, 2) for t in (q, k, v))
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
        nbytes = 4.0 * n * s * d * 2  # q, k, v read once, o written once, bf16
        flops = 4.0 * n * s * s * d
        t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_HBM_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        row = dict(shape=[n, s, heads, dh] if shape != "negative" else "negative",
                   merged_qkv=merged, plan=dataclasses.asdict(plan),
                   max_abs_err=err, rel_err=rel, canary_ok=canary_ok, ms=ms, flushed_ms=cold_ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   share_of_bound=bound_ms / cold_ms, gbytes_per_s=nbytes / cold_ms / 1e6)
        if main_shape:
            row["host_us_per_call"] = host_us_per_call(kernel)
        log(f"short_attention {shape} {'merged qkv' if merged else 'contiguous'} "
            f"rows {plan.rows}: max_abs_err {err:.3e} rel_err "
            f"{rel:.3e} ms {ms:.4f} flushed_ms {cold_ms:.4f} plain_ms {plain_ms:.4f} sdpa_ms "
            f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({row['bound_by']}) share "
            f"{row['share_of_bound']:.3f} {row['gbytes_per_s']:.0f} GB/s"
            + (f" host_us {row['host_us_per_call']:.2f}" if main_shape else ""))
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


def video_w8a8_shapes(ucfg, latent_hw, frames: int, rows: int = 2) -> dict:
    """{(M, K, N): sites} of the W8A8 linear sites in one UNet3D call of
    ``rows`` clip rows with its step-invariant cache (the video loop's call;
    the cache's own pass has none): ``transformer_in``'s frame-axis block (8
    heads) over every pixel of level 0, then at each spatial transformer
    (proj_in, merged qkv, out, the cross-attention's query and out, the GEGLU
    in and out, proj_out; its K/V are cached) and the frame-axis transformer
    after it (proj_in, two merged-qkv self-attentions with their outs, the
    GEGLU in and out, proj_out), at C channels, M = rows x frames x pixels."""
    from collections import Counter

    from tweediemix_tpu_torch.models.unet3d import video_cross_attention_names

    h, w = latent_hw
    n_levels = len(ucfg.block_out_channels)
    shapes = Counter()

    def block(m, c, inner, selfs):  # proj_in, attentions, GEGLU, proj_out
        shapes[(m, c, inner)] += 1
        shapes[(m, inner, 8 * inner)] += 1
        shapes[(m, 4 * inner, inner)] += 1
        shapes[(m, inner, c)] += 1
        for kind in selfs:  # "self": merged qkv and out; "cross": query and out
            shapes[(m, inner, 3 * inner if kind == "self" else inner)] += 1
            shapes[(m, inner, inner)] += 1

    c0 = ucfg.block_out_channels[0]
    block(rows * frames * h * w, c0, 8 * ucfg.attention_head_dim, ("self", "self"))
    for name in video_cross_attention_names(ucfg):
        level = n_levels - 1 if name.startswith("mid") else int(name.split("_")[2])
        if name.startswith("up"):
            level = n_levels - 1 - level
        c = ucfg.block_out_channels[level]
        m = rows * frames * (h >> level) * (w >> level)
        block(m, c, c, ("self", "cross"))  # the spatial transformer
        block(m, c, c, ("self", "self"))  # the frame-axis transformer after it
    return dict(shapes)


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
    with the short-attention knob on, then two clips over a mesh."""
    import torch

    from tweediemix_tpu_torch.models.unet3d import UNet3DConfig
    from tweediemix_tpu_torch.models.vae import VAEConfig
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention, flash_attention_int8
    from tweediemix_tpu_torch.ops.group_norm import group_norm
    from tweediemix_tpu_torch.ops.short_attention import short_seq_attention
    from tweediemix_tpu_torch.video.pipeline import I2VPipeline, VideoConfig

    ucfg = UNet3DConfig.i2vgen(dtype=torch.bfloat16)
    vcfg = VideoConfig()
    ctx_len = 77
    gn_expected = GN_SITES_VIDEO * vcfg.n_timesteps  # 8300
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
            short_seq_attention.launches = group_norm.launches = 0
            gn_paths = dict(group_norm.paths)
            t0 = time.perf_counter()
            video = pipe.generate(text, uncond, image, emb, seed=run)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(short=short_seq_attention.launches, flash=flash_attention.launches)
            stats = dict(
                s_per_clip=wall, launches=launches, int8_launches=flash_attention_int8.launches,
                group_norm_launches=group_norm.launches,
                group_norm_paths={k: v - gn_paths[k] for k, v in group_norm.paths.items()},
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
            if group_norm.launches != gn_expected or stats["group_norm_paths"]["one_read"] != gn_expected:
                fail(f"video path: group_norm launched {group_norm.launches} times, "
                     f"{stats['group_norm_paths']}, expected {gn_expected}, each reading x once")
            runs.append(stats)
        mesh = mesh_video(pipe, (text, uncond, image, emb), sites)
    finally:
        os.environ.pop("TWEEDIEMIX_SHORT_ATTENTION", None)
    return dict(runs=runs, expected_launches=expected, unet_params=n_params, mesh=mesh)


def mesh_video(pipe, inputs, sites) -> dict:
    """Two clips over ``two_entry_mesh()`` (one clip per shard, each
    shard's whole loop on its replica): one step's UNet call per shard
    against the whole 4-row call within ``MESH_REL_TOL``; then the clips
    generated unsharded and meshed with the loop cut to
    ``MESH_VIDEO_STEPS`` steps: both kernels' launches (the meshed loop
    makes two UNet calls per step, so twice the unsharded count), seconds,
    peak memory, and the meshed latent held to the unsharded one against
    the distance a bf16 rounding of the initial latents makes."""
    import torch

    from tweediemix_tpu_torch.models.unet3d import precompute_video_cache
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention
    from tweediemix_tpu_torch.ops.short_attention import short_seq_attention
    from tweediemix_tpu_torch.video.pipeline import I2VPipeline

    vcfg = dataclasses.replace(pipe.config, n_timesteps=MESH_VIDEO_STEPS)
    cut = I2VPipeline(vcfg, pipe.unet, pipe.vae, device=pipe.device)
    text, uncond, image, emb = inputs
    image = image.repeat(2, 1, 1, 1)
    mesh = two_entry_mesh()

    # one loop step's UNet call: the 4 interleaved rows at once, and each
    # clip's 2 rows with its own cache, as a shard runs them
    h, w = vcfg.latent_hw
    dev = pipe.device
    gen = torch.Generator(device=dev).manual_seed(6)
    x4 = torch.randn((4, vcfg.num_frames, h, w, 4), generator=gen, device=dev)
    rows = (torch.cat([uncond, text] * 2), 0.3 * torch.randn(x4.shape, generator=gen, device=dev),
            torch.cat([torch.zeros_like(emb), emb] * 2), torch.full((4,), float(vcfg.fps),
                                                                   device=dev))

    def call(x, r):
        cctx, cil, kv = precompute_video_cache(cut.unet, *r)
        return cut.unet(x, 501, *r, False, False, vcfg.interp_ratio, cached_ctx=cctx,
                        cached_il=cil, cross_kv=kv)

    with torch.inference_mode():
        whole = call(x4, rows)
        split = torch.cat([call(x4[i:i + 2], tuple(a[i:i + 2] for a in rows)) for i in (0, 2)])
    out = dict(call_rel_err=_mesh_rel(split, whole))
    latents = {}
    x_init = cut.init_latents(0, 2)
    for label, mesh_devices, factor, start in (
            ("unsharded", 1, 1, x_init), ("mesh2", mesh, 2, x_init),
            ("unsharded_bf16_init", 1, 1, x_init.bfloat16().float())):
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = short_seq_attention.launches = 0
        t0 = time.perf_counter()
        video = cut.generate(text, uncond, image, emb, seed=0, x_init=start,
                             mesh_devices=mesh_devices)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        latents[label] = cut.last_latent
        launches = dict(short=short_seq_attention.launches, flash=flash_attention.launches)
        want = {k: factor * v * MESH_VIDEO_STEPS for k, v in sites.items()}
        out[label] = dict(s_two_clips=wall, launches=launches, expected_launches=want,
                          phases={k: round(v, 4) for k, v in cut.phase_seconds.items()},
                          max_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        if (tuple(video.shape) != (2, vcfg.num_frames, vcfg.height, vcfg.width, 3)
                or not torch.isfinite(video).all()):
            fail(f"{label} two-clip video: shape {tuple(video.shape)} or non-finite frames")
        if launches != want:
            fail(f"{label} two-clip video launches {launches}, expected {want}")
    out["rel_err"] = _mesh_rel(latents["mesh2"], latents["unsharded"])
    out["bf16_init_rel_err"] = _mesh_rel(latents["unsharded_bf16_init"], latents["unsharded"])
    out.update(steps=MESH_VIDEO_STEPS, gpu=gpu_name_and_power())
    log(f"video path over a 2-entry mesh on cuda:0, {MESH_VIDEO_STEPS} steps (cut from "
        f"{pipe.config.n_timesteps} for time): {json.dumps(out)}")
    if out["call_rel_err"] > MESH_REL_TOL:
        fail(f"a meshed video UNet call is {out['call_rel_err']:.3e} of max |eps| from the whole "
             f"call (limit {MESH_REL_TOL})")
    if out["rel_err"] > VIDEO_RATIO_TOL * out["bf16_init_rel_err"]:
        fail(f"the meshed two-clip latent is {out['rel_err']:.3e} of max |latent| from the "
             f"unsharded one, more than {VIDEO_RATIO_TOL} x the {out['bf16_init_rel_err']:.3e} "
             "a bf16 initial latent makes")
    return out


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
    from tweediemix_tpu_torch.ops.quant import w8a8_matmul_cuda
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
    if sum(video_w8a8_shapes(ucfg, vcfg.latent_hw, vcfg.num_frames).values()) != VIDEO_W8A8_SITES:
        fail(f"expected {VIDEO_W8A8_SITES} W8A8 linear sites per video UNet call")
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
            w8a8_matmul_cuda.launches = 0
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
            # every W8A8 linear site of each of the 50 calls through the two kernels
            launches["w8a8"] = w8a8_matmul_cuda.launches
            want_w8a8 = VIDEO_W8A8_SITES * vcfg.n_timesteps if int8_core else 0
            if launches["w8a8"] != want_w8a8:
                fail(f"video CLI ({label}): {launches['w8a8']} W8A8 linear launches, expected "
                     f"{want_w8a8}")
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
                # CLI's peak memory is its own)
                named = {f"{k}/{n}": p for k, m in (("unet", unet), ("te1", te1), ("te2", te2))
                         for n, p in m.named_parameters()}
                kept["params"] = named
                kept["before"] = {n: p.detach().to("cpu", copy=True) for n, p in named.items()}
                return make_step(unet, te1, te2, *args, **kw)

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

        runs["multihost"] = cli_train_multihost(base, root, sites)

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


def _delta_distance(a, b) -> float:
    """Largest |a − b| over every tensor of two delta checkpoints (their
    keys must agree)."""
    dist = 0.0
    for coll in ("unet", "modifier_token", "modifier_token_2"):
        if sorted(a[coll]) != sorted(b[coll]):
            fail(f"delta keys of {coll} differ")
        for k in a[coll]:
            dist = max(dist, (a[coll][k].float() - b[coll][k].float()).abs().max().item())
    return dist


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_train_multihost(base, root, sites) -> dict:
    """The Custom-Diffusion run's flags again, up to its first save, as one
    ``--multihost`` rank (NCCL at world size 1 on 127.0.0.1): every step's
    gradient ``all_reduce`` goes through NCCL on the card. Its delta at that
    step is held to the plain run's: bit for bit, or else within the
    distance between the plain run and a second plain run of the same
    steps; 20 flash launches per step; the process group gone after."""
    import torch

    from tweediemix_tpu_torch.cli import train
    from tweediemix_tpu_torch.concepts.delta import load_reference_delta
    from tweediemix_tpu_torch.ops.flash_attention import flash_attention
    from tweediemix_tpu_torch.training import trainer

    reduce_sum = trainer.all_reduce_sum
    reduces = []

    def counted(tensors, group=None):
        reduces.append(torch.distributed.get_backend())
        return reduce_sum(tensors, group)

    steps = TRAIN_SAVE_STEPS
    common = ["--max_train_steps", str(steps), "--save_steps", str(steps)]
    out = os.path.join(root, "train_mh")
    argv = base + common + ["--output_dir", out, "--multihost", "--coordinator_address",
                            f"127.0.0.1:{_free_port()}", "--num_processes", "1",
                            "--process_id", "0"]
    trainer.all_reduce_sum = counted
    flash_attention.launches = 0
    try:
        rc, stdout, wall = run_cli(train.main, argv)
    finally:
        trainer.all_reduce_sum = reduce_sum
    if rc != 0:
        fail(f"the --multihost training CLI returned {rc}")
    if torch.distributed.is_initialized():
        fail("the --multihost training CLI left its process group")
    parsed = _train_stdout(stdout)
    per_step = flash_attention.launches / steps
    plain = load_reference_delta(os.path.join(root, "train_cd", f"delta-{steps}.bin"))
    got = load_reference_delta(os.path.join(out, f"delta-{steps}.bin"))
    dist = _delta_distance(got, plain)
    stats = dict(gpu=gpu_name_and_power(), wall_s=wall, **parsed["timings"],
                 losses=parsed["losses"], launches=flash_attention.launches,
                 launches_per_step=per_step, all_reduces=len(reduces),
                 backends=sorted(set(reduces)), delta_distance=dist)
    if dist > 0:  # not bit for bit: how far two plain runs of these steps are apart
        out2 = os.path.join(root, "train_plain2")
        rc, _, _ = run_cli(train.main, base + common + ["--output_dir", out2])
        if rc != 0:
            fail(f"the second plain training run returned {rc}")
        stats["plain_distance"] = _delta_distance(
            load_reference_delta(os.path.join(out2, f"delta-{steps}.bin")), plain)
    log(f"cli train multihost (world size 1): {json.dumps(stats)}")
    if per_step != 2 * sites:
        fail(f"the --multihost run launched the kernel {per_step} times per step, "
             f"expected {2 * sites}")
    # a count-reduce and a gradient-and-metrics pair per step, all through NCCL
    if stats["backends"] != ["nccl"] or len(reduces) != 3 * steps:
        fail(f"all_reduce calls {len(reduces)} on {stats['backends']}, expected {3 * steps} on nccl")
    if dist > stats.get("plain_distance", 0.0):
        fail(f"the --multihost delta is {dist:.3e} from the plain run's, two plain runs "
             f"{stats.get('plain_distance', 0.0):.3e}")
    return stats


def traced_launches(call, kernels) -> dict:
    """``call()`` under torch.profiler, device activity alone: the trace's
    kernel events (``events``) and, of each kernel of ``kernels`` (names in
    the source), its events (``kernels``), counted by
    ``models/unet_graph.py::kernel_launches``. A CUDA graph's replay shows
    each of its kernel nodes as an event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tweediemix_tpu_torch.models.unet_graph import kernel_launches

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    return dict(events=len(names), kernels={k: kernel_launches(names, k) for k in kernels})


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
    w8a8_rows, w8a8_video_rows = phase_kernels_w8a8()
    phase_reference()
    reference_train = phase_reference_train()
    reference_w8a8 = phase_reference_w8a8()
    short_rows = phase_kernels_short()
    gn = phase_kernels_group_norm()
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
              cli_serve_launches=cli["serve"]["launches"],
              cli_profile_launches=cli["profile"]["launches"],
              cli_dino_launches={k: v["launches"] for k, v in cli["segmentation"]["dino"]["fusion"].items()},
              cli_video_launches=cli_runs["bf16"]["launches"]["flash"],
              train_launches=cli["train"]["cd"]["launches_per_step"],
              train_multihost_launches=cli["train"]["multihost"]["launches_per_step"],
              mesh_launches=main_path["mesh"]["mesh2"]["launches"],
              mesh_unsharded_launches=main_path["mesh"]["unsharded"]["launches"],
              video_mesh_launches=video["mesh"]["mesh2"]["launches"]["flash"],
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
        entry("w8a8_linear", "tweediemix_tpu_torch/csrc/w8a8_linear.cu",
              "none (tweediemix_tpu/ops/quant.py:101-127 left to XLA)",
              w8a8["runs"][-1]["w8a8_launches"], w8a8_rows,
              host_us_per_call=w8a8_rows[0]["host_us_per_call"],
              cli_video_launches=cli_runs["w8a8"]["launches"]["w8a8"], video_shapes=w8a8_video_rows),
        entry("short_attention", "tweediemix_tpu_torch/csrc/short_attention.cu",
              "tweediemix_tpu/ops/short_attention.py:51", video["runs"][-1]["launches"]["short"],
              short_rows, flushed_ms=short_rows[0]["flushed_ms"],
              share_of_bound=short_rows[0]["share_of_bound"],
              host_us_per_call=short_rows[0]["host_us_per_call"],
              cli_video_launches=cli_runs["bf16"]["launches"]["short"],
              video_mesh_launches=video["mesh"]["mesh2"]["launches"]["short"],
              video_mesh_unsharded_launches=video["mesh"]["unsharded"]["launches"]["short"],
              cli_video_w8a8_launches=cli_runs["w8a8"]["launches"]["short"]),
        entry("group_norm", "tweediemix_tpu_torch/csrc/group_norm.cu",
              "none (nn.GroupNorm left to XLA: tweediemix_tpu/models/unet2d.py:363,398,405,580, "
              "unet3d.py:159)", main_path["runs"][-1]["group_norm_launches"], gn["rows"],
              flushed_ms=gn["rows"][0]["flushed_ms"], share_of_bound=gn["rows"][0]["share_of_bound"],
              host_us_per_call=gn["rows"][0]["host_us_per_call"], per_call=gn["per_call"],
              video_launches=video["runs"][-1]["group_norm_launches"],
              paths=dict(image=main_path["runs"][-1]["group_norm_paths"],
                         clip=video["runs"][-1]["group_norm_paths"])),
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
