"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``tweediemix_tpu_torch/csrc/`` exposes a plain C
interface. At first use it is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``build_dir()`` (``build/`` at the repository root,
listed in ``.gitignore``, unless ``utils/compile_cache.py`` points it
elsewhere) and loaded with ``ctypes``. The library's file name carries a
hash of the source, of every header it includes from ``csrc/`` (such as
``hopper.cuh``) and of the flags, so an edited source or header is rebuilt
and a stale library is never loaded. Nothing is built or imported when this
module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# where libraries are built and loaded from when it is not BUILD_DIR
# (``utils.compile_cache.enable_compile_cache``)
_build_dir_override: Path | None = None
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def build_dir() -> Path:
    """The directory the kernels are built into and loaded from:
    ``BUILD_DIR`` unless ``set_build_dir`` chose another."""
    return BUILD_DIR if _build_dir_override is None else _build_dir_override


def set_build_dir(path) -> None:
    """Build into and load from ``path`` (None: back to ``BUILD_DIR``)."""
    global _build_dir_override
    _build_dir_override = None if path is None else Path(path)


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or $PATH; raises if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def local_headers(src: Path) -> list[Path]:
    """The headers that ``src`` includes with quotes, directly or through
    another such header, resolved beside the including file."""
    found, todo = [], [src]
    while todo:
        including = todo.pop()
        for inc in _LOCAL_INCLUDE.findall(including.read_text()):
            header = including.parent / inc
            if header not in found:
                found.append(header)
                todo.append(header)
    return sorted(found)


def library_path(name: str) -> Path:
    """``build_dir()/lib<name>_<hash>.so``, the hash over the source, its
    local headers and the flags."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in local_headers(src):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``library_path(name)`` unless that
    file already exists; returns its path."""
    src = CSRC_DIR / f"{name}.cu"
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        # ptxas -v resource usage (registers, shared memory, spills)
        (out.parent / f"{name}.ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


# the kernel wrappers that count their launches: {module.name: wrapper}
LAUNCH_COUNTERS: dict = {}


def counts_launches(fn, kernel: str) -> None:
    """Give the wrapper ``fn`` its launch counter, ``fn.launches = 0``, and
    list it in ``LAUNCH_COUNTERS`` with ``fn.kernel = kernel``: the
    ``__global__`` function (its name in the source) that each counted call
    launches once, by which a recorded CUDA graph's launches are counted
    (``models/unet_graph.py``)."""
    fn.launches = 0
    fn.kernel = kernel
    LAUNCH_COUNTERS[f"{fn.__module__}.{fn.__qualname__}"] = fn


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiled on first call."""
    return ctypes.CDLL(str(build_library(name)))


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C launcher returned a non-zero cudaError_t."""
    if err != 0:
        lib.tm_cuda_error_string.restype = ctypes.c_char_p
        lib.tm_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.tm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")
