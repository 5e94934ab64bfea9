"""TweedieMix on PyTorch and CUDA: the port of ``tweediemix_tpu`` to an
NVIDIA H100.

The JAX package stays the reference; this package keeps its module layout
and names. It imports torch, never jax, and nothing of ``tweediemix_tpu``.
"""

from tweediemix_tpu_torch.schedulers.ddim import DDIMTable

__version__ = "0.1.0"

__all__ = ["DDIMTable", "__version__"]
