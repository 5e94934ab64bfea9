"""Variants of the int8 flash kernel, each held against the plain version.

Each variant is a copy of ``csrc/flash_attention_int8.cu`` (and the headers
it includes) with a few lines replaced, every replacement matching exactly
once; all are built with nvcc at once. At each shape every variant runs on the
same int8 inputs: max |kernel - plain| / max |plain| (the plain version in
fp32 at the kernel's block_k) and CUDA-event ms, timed in two passes, the
variants in forward and then reverse order. The last shapes take loud q and k
(randn x 8), whose score scale q_s·k_s is above 0.01.

    python -m tweediemix_tpu_torch.tools.int8_variants [--out FILE]

Needs one CUDA card and nvcc. Prints one line per shape and variant, the
ptxas spills of each variant at dh 64 and 128, and (with --out) writes the
rows as JSON lines.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_DH64 = "launch<Cfg<64, 128, 32, 8>>"
_EXPONENT = """const float x = kMagicDiff ? fmaf(__int_as_float(s[4 * j + e] + shift[r]), sc_hi, bias)
                                 : static_cast<float>(s[4 * j + e] - m_run[r]) * sc;"""


def _addend(rounding: str) -> str:
    """The exponent as (1.5 * 2^23 + x) * sc - (1.5 * 2^23 * sc + m * sc), the
    addend and m * sc rounded as ``rounding`` says (an earlier design; its
    per-score addend makes its time no measure of that design's)."""
    return (f"const float x = fmaf(magic_float(s[4 * j + e]), sc, -__fmaf_{rounding}(kMagicF, sc, "
            f"__fmul_{rounding}(static_cast<float>(m_run[r]), sc)));")


# name: the replacements that make it from the kernel's source
VARIANTS = {
    "kernel": [],
    # every exp2 on the special-function unit (dh 64 runs one in 8 on the FMA units)
    "exp2_unit_only": [(_DH64, "launch<Cfg<64, 128, 32, 0>>")],
    "exp2_fma_1_in_16": [(_DH64, "launch<Cfg<64, 128, 32, 16>>")],
    # x - m converted by a cast (I2F, 16 per clock per SM) at every dh
    "cast_conversion": [(_EXPONENT, "const float x = static_cast<float>(s[4 * j + e] - m_run[r]) * sc;")],
    "addend_to_nearest": [(_EXPONENT, _addend("rn"))],
    "addend_rounded_up": [(_EXPONENT, _addend("ru"))],
}
# (BH, Sq, Sk, dh, loudness of q and k): the W8A8 path's four shapes, edge
# shapes at dh 128 and 256, then loud inputs
SHAPES = [(160, 4096, 4096, 64, 1.0), (80, 4096, 4096, 64, 1.0), (320, 1024, 1024, 64, 1.0),
          (160, 1024, 1024, 64, 1.0), (1, 1000, 4100, 64, 1.0), (2, 300, 300, 128, 1.0),
          (2, 129, 4100, 128, 1.0), (8, 1024, 1024, 256, 1.0), (8, 1024, 1024, 64, 8.0),
          (4, 1024, 1024, 128, 8.0)]


def variant_source(src: str, replacements) -> str:
    for old, new in replacements:
        if src.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in the kernel's source exactly once")
        src = src.replace(old, new)
    return src


def _spills(ptxas: str) -> dict:
    """Spill stores in bytes of the attention kernel's entries, by dh."""
    out = {}
    for entry in ptxas.split("Compiling entry function")[1:]:
        m = re.search(r"flash_int8_wgmma_kernelINS_3CfgILi(\d+)E", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        if m and spill:
            dh = int(m.group(1))
            out[dh] = max(out.get(dh, 0), int(spill.group(1)))
    return out


def build_variants(work: Path) -> dict:
    """{name: (ctypes library, spills by dh)}, each built in work/<name>."""
    from tweediemix_tpu_torch.ops import cuda_build

    src_path = cuda_build.CSRC_DIR / "flash_attention_int8.cu"
    src = src_path.read_text()
    nvcc = cuda_build.find_nvcc()

    def build(name):
        d = work / name
        d.mkdir(parents=True)
        (d / src_path.name).write_text(variant_source(src, VARIANTS[name]))
        for header in cuda_build.local_headers(src_path):
            shutil.copy(header, d / header.name)
        so = d / f"lib{name}.so"
        proc = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", str(so), str(d / src_path.name)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stderr[-4000:]}")
        return name, so, _spills(proc.stderr)

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build, VARIANTS))
    return {name: (ctypes.CDLL(str(so)), spills) for name, so, spills in built}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the rows here as JSON lines")
    args = parser.parse_args()

    import torch

    from tweediemix_tpu_torch.ops.cuda_build import check_launch
    from tweediemix_tpu_torch.ops.flash_attention import (
        INT8_BLOCK_K,
        bind_int8,
        flash_attention_int8_core_reference,
        pack_v_int8,
        quantize_qkv_int8,
    )

    if not torch.cuda.is_available():
        raise SystemExit("int8_variants needs a CUDA card")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        for name, (_, spills) in libs.items():
            print(f"{name}: spill stores by dh {spills}", flush=True)
        attend = {name: bind_int8(lib)[0] for name, (lib, _) in libs.items()}
        rows = []
        for bh, sq, sk, dh, loud in SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(bh * 11 + sq + sk + dh)
            q, k, v = (torch.randn((bh, s, dh), generator=gen, device="cuda").mul(m)
                       .to(torch.bfloat16) for s, m in ((sq, loud), (sk, loud), (sk, 1.0)))
            q8, k8, v8, scales = quantize_qkv_int8(q, k, v)
            vt8 = pack_v_int8(v8, INT8_BLOCK_K[dh])
            plain = flash_attention_int8_core_reference(q8, k8, v8, scales, INT8_BLOCK_K[dh])
            out = torch.empty(q.shape, dtype=torch.bfloat16, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def run(name):
                err = attend[name](q8.data_ptr(), k8.data_ptr(), vt8.data_ptr(), scales.data_ptr(),
                                   out.data_ptr(), bh, sq, sk, dh, stream)
                check_launch(libs[name][0], err, name)

            def ms(name, reps=20):
                for _ in range(3):
                    run(name)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    run(name)
                end.record()
                torch.cuda.synchronize()
                return start.elapsed_time(end) / reps

            rel = {}
            for name in VARIANTS:
                run(name)
                torch.cuda.synchronize()
                rel[name] = (out.float() - plain).abs().max().item() / plain.abs().max().item()
            first = {name: ms(name) for name in VARIANTS}
            second = {name: ms(name) for name in reversed(VARIANTS)}
            for name in VARIANTS:
                row = dict(shape=[bh, sq, sk, dh], loud=loud, score_scale=scales[0].item(),
                           variant=name, rel_err=rel[name], ms=[first[name], second[name]])
                rows.append(row)
                print(f"{(bh, sq, sk, dh)} q,k x {loud} (score scale {row['score_scale']:.3e}) "
                      f"{name}: rel_err {rel[name]:.3e} ms {first[name]:.4f} {second[name]:.4f}",
                      flush=True)
            del q, k, v, q8, k8, v8, vt8, plain, out
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
