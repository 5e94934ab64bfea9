"""The segmentation's matrix products against the fp32 peak in the traced
slice of one ``segment_fn`` call: the operations the plain reference
counts for the call's linear layers and attention products (``seg_gemm``
and ``seg_attention`` of ``System.seg_work``) at 67 TFLOP/s, over the
device seconds of the slice's ``gemm``-class kernels (cuBLAS; TF32 off)."""

from benchmark.rooflines import PEAK_FP32


def read(ctx):
    sl = ctx.get("slice") or {}
    t = (sl.get("by_class") or {}).get("gemm")
    work = sl.get("seg_work") or {}
    ops = work.get("seg_gemm", 0.0) + work.get("seg_attention", 0.0)
    if not t or not ops:
        return None
    return 100.0 * ops / PEAK_FP32 / t
