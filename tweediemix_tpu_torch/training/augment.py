"""The training data's host augmentation: ``csrc/augment.cpp`` (a copy of the
JAX package's ``native/augment.cpp``) built with ``g++`` at first use and
called through ``ctypes``, with its plain numpy versions beside it.

``paste_augment`` is the Custom-Diffusion random-scale paste: a bilinear
resize of the instance image, pasted on a black canvas normalised to
[-1, 1], and the latent-resolution validity mask of the pasted region shrunk
by one latent pixel per side. ``resize_crop_normalize`` is the class-image
transform: a shorter-side resize, a crop and the same normalisation. The
library goes to the kernels' build directory (``build/`` at the repository
root unless ``utils/compile_cache.py`` chose another) under a name that hashes
the source and the flags, like the CUDA kernels (``ops/cuda_build.py``).
Nothing is built when this module is imported; a library that cannot be
built raises (the data path never falls back to numpy). The numpy versions
(``*_reference``) are what the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from tweediemix_tpu_torch.ops.cuda_build import CSRC_DIR, build_dir

SOURCE = CSRC_DIR / "augment.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return build_dir() / f"libaugment_{digest.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile ``csrc/augment.cpp`` into ``library_path()`` unless it
    exists; raises if there is no ``g++`` or it fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the training data's augment library cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with its C entry points typed."""
    lib = ctypes.CDLL(str(build_library()))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i = ctypes.c_int
    lib.paste_augment.argtypes = [u8p, i, i, i, i, i, i, i, f32p, f32p, i]
    lib.paste_augment.restype = None
    lib.resize_crop_normalize.argtypes = [u8p, i, i, i, i, i, i, i, f32p]
    lib.resize_crop_normalize.restype = None
    return lib


def _rgb_u8(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {img.shape}")
    return img


def paste_augment(img: np.ndarray, th: int, tw: int, oy: int, ox: int, size: int,
                  mask_size: int):
    """img uint8 [H, W, 3] resized to (th, tw) and pasted at (oy, ox) →
    (canvas [size, size, 3] fp32 in [-1, 1], mask [mask_size, mask_size])."""
    img = _rgb_u8(img)
    out = np.empty((size, size, 3), np.float32)
    mask = np.empty((mask_size, mask_size), np.float32)
    load_library().paste_augment(img, img.shape[0], img.shape[1], th, tw, oy, ox, size, out,
                                 mask, mask_size)
    return out, mask


def resized_dims(ih: int, iw: int, size: int) -> tuple:
    """The shorter side resized to ``size``, the longer truncated as
    torchvision's ``Resize(int)`` truncates it."""
    if ih <= iw:
        return size, max(size, int(iw * size / max(ih, 1)))
    return max(size, int(ih * size / max(iw, 1))), size


def resize_crop_normalize(img: np.ndarray, size: int, cy: int, cx: int) -> np.ndarray:
    """Shorter-side resize to ``size``, a size² crop at (cy, cx) in resized
    coordinates, normalised to [-1, 1] (the reference's class transform)."""
    img = _rgb_u8(img)
    th, tw = resized_dims(img.shape[0], img.shape[1], size)
    cy, cx = int(np.clip(cy, 0, th - size)), int(np.clip(cx, 0, tw - size))
    out = np.empty((size, size, 3), np.float32)
    load_library().resize_crop_normalize(img, img.shape[0], img.shape[1], th, tw, cy, cx,
                                         size, out)
    return out


def _bilinear_reference(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    ih, iw = img.shape[:2]
    sy = np.float32(ih - 1) / np.float32(max(th - 1, 1)) if ih > 1 else np.float32(0.0)
    sx = np.float32(iw - 1) / np.float32(max(tw - 1, 1)) if iw > 1 else np.float32(0.0)
    fy = np.arange(th, dtype=np.float32) * sy
    fx = np.arange(tw, dtype=np.float32) * sx
    y0, x0 = fy.astype(np.int32), fx.astype(np.int32)
    y1, x1 = np.minimum(y0 + 1, ih - 1), np.minimum(x0 + 1, iw - 1)
    wy = (fy - y0)[:, None, None]
    wx = (fx - x0)[None, :, None]
    a, b = img[y0][:, x0].astype(np.float32), img[y0][:, x1].astype(np.float32)
    c, d = img[y1][:, x0].astype(np.float32), img[y1][:, x1].astype(np.float32)
    return (1 - wy) * ((1 - wx) * a + wx * b) + wy * ((1 - wx) * c + wx * d)


def paste_augment_reference(img, th, tw, oy, ox, size, mask_size):
    """``paste_augment`` in numpy (fp32, the same sampling grid)."""
    canvas = np.full((size, size, 3), -1.0, np.float32)
    resized = _bilinear_reference(img, th, tw) / np.float32(127.5) - np.float32(1.0)
    y0, y1 = max(0, oy), min(size, oy + th)
    x0, x1 = max(0, ox), min(size, ox + tw)
    canvas[y0:y1, x0:x1] = resized[y0 - oy:y1 - oy, x0 - ox:x1 - ox]
    mask = np.zeros((mask_size, mask_size), np.float32)
    factor = size // mask_size
    my0, my1 = oy // factor + 1, (oy + th) // factor - 1
    mx0, mx1 = ox // factor + 1, (ox + tw) // factor - 1
    mask[max(0, my0):max(0, my1), max(0, mx0):max(0, mx1)] = 1.0
    return canvas, mask


def resize_crop_normalize_reference(img, size, cy, cx):
    """``resize_crop_normalize`` in numpy."""
    th, tw = resized_dims(img.shape[0], img.shape[1], size)
    cy, cx = int(np.clip(cy, 0, th - size)), int(np.clip(cx, 0, tw - size))
    resized = _bilinear_reference(img, th, tw)
    return (resized[cy:cy + size, cx:cx + size] / np.float32(127.5) - np.float32(1.0)).astype(np.float32)
