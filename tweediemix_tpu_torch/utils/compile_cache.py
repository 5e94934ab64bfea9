"""Persistent kernel build cache (counterpart of
``tweediemix_tpu/utils/compile_cache.py``).

The JAX package's cold-start cost is XLA compilation, which it caches on
disk. The port compiles no graphs: its cold-start compile is the ``nvcc``
build of ``csrc/*.cu`` (and the ``g++`` build of ``csrc/augment.cpp``),
whose libraries ``ops/cuda_build.py`` keys by a hash of the sources and
flags and loads from its build directory. This module chooses that
directory. Every CLI calls ``enable_compile_cache()`` where the JAX
package's does (the training CLI after ``init_distributed``).

* ``TWEEDIEMIX_COMPILE_CACHE`` unset, ``1``/``on``/``true``/``yes``: the
  default directory, ``<repo>/build`` (gitignored);
* ``0``/``off``/``none``/``false``/empty: no cache: the kernels are built
  into a temporary directory of this process only, removed at its exit;
* any other value: that directory.

An explicit ``cache_dir`` argument wins over the variable. Unlike the JAX
package, whose cache is on by default only on a TPU, the port's is always
on: a kernel cannot run unbuilt, and a library built for ``sm_90a`` runs
on any Hopper card.
"""

from __future__ import annotations

import atexit
import functools
import os
import shutil
import tempfile


def default_cache_dir() -> str:
    """``<repo>/build``, where the kernels are built when nothing else is
    asked."""
    from tweediemix_tpu_torch.ops import cuda_build

    return str(cuda_build.BUILD_DIR)


@functools.cache
def _process_build_dir() -> str:
    path = tempfile.mkdtemp(prefix="tweediemix_build_")
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    return path


def enable_compile_cache(cache_dir: str | None = None) -> str | None:
    """Point ``ops/cuda_build.py`` at the directory the kernels are built
    into and loaded from; returns it, or None when the cache is off (then
    the kernels go to a temporary directory of this process).
    Nothing is built here."""
    from tweediemix_tpu_torch.ops import cuda_build

    env = os.environ.get("TWEEDIEMIX_COMPILE_CACHE")
    if cache_dir is None and env is not None:
        if env.lower() in ("", "0", "off", "none", "false"):
            cuda_build.set_build_dir(_process_build_dir())
            return None
        if env.lower() not in ("1", "on", "true", "yes"):
            cache_dir = env
    if cache_dir is None or os.path.abspath(cache_dir) == default_cache_dir():
        cuda_build.set_build_dir(None)
        return default_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    cuda_build.set_build_dir(os.path.abspath(cache_dir))
    return os.path.abspath(cache_dir)
