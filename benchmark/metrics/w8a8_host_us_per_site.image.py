"""Host µs per W8A8 site: the mean host duration of the traced slice's
first-pass ``w8a8.site`` spans (``ops/quant.py``'s ``QLinear`` and
``QConv2d``: quantise, int8 GEMM, dequantise)."""

from benchmark.program_spans import first_pass, host_seconds


def read(ctx):
    sites = [s for s in first_pass(ctx) or [] if s["name"] == "w8a8.site"]
    if not sites:
        return None
    return 1e6 * sum(host_seconds(s) for s in sites) / len(sites)
