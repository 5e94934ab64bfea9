"""Attention and stacked-projection ops, and the kernels under them."""
