"""Image files without an imaging package: an 8-bit PNG reader and writer
(``zlib`` and ``struct``) and the resize that PIL's ``Image.resize`` applies
by default to an 8-bit gray image.

The writer stores 8-bit gray or RGB, every row with filter 0. The reader
takes 8-bit, non-interlaced gray, gray + alpha, RGB and RGBA with any of
the five row filters, and checks every chunk's CRC.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type → samples per pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def write_png(path: str, pixels: np.ndarray) -> None:
    """uint8 [H, W] (gray) or [H, W, 3] (RGB) → an 8-bit PNG."""
    arr = np.ascontiguousarray(pixels, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c not in (1, 3):
        raise ValueError(f"write_png takes [H, W] or [H, W, 3] pixels, got {pixels.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    color_type = 0 if c == 1 else 2
    png = (PNG_SIGNATURE
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: raw [h, 1 + stride] → [h, stride]."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:  # up
            cur = (line + prev) & 0xFF
        elif kind == 1:  # sub: a running sum per byte lane
            lanes = line.reshape(-1, bpp)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).reshape(-1)
        elif kind in (3, 4):  # average, paeth: each byte needs its left neighbour
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if kind == 3:
                    cur[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str):
    """An 8-bit PNG → (header dict: width, height, bit_depth, color_type,
    interlace; pixels uint8 [H, W, C], C = 1, 2, 3 or 4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, chunks = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in its {tag!r} chunk")
        chunks.append((tag, body))
        pos += 12 + n
        if tag == b"IEND":
            break
    if not chunks or chunks[0][0] != b"IHDR":
        raise ValueError(f"{path}: no IHDR chunk first")
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    header = dict(width=w, height=h, bit_depth=depth, color_type=color, interlace=interlace)
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB(A) PNGs are read, got {header}")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(b for t, b in chunks if t == b"IDAT")), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {header}")
    rows = raw.reshape(h, 1 + w * c)
    if rows[:, 0].any():
        pixels = _unfilter(rows, h, w * c, c)
    else:
        pixels = rows[:, 1:]
    return header, pixels.reshape(h, w, c)


def to_gray(pixels: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] → [H, W] as PIL's ``convert("L")`` (alpha dropped;
    RGB to L = (19595 R + 38470 G + 7471 B + 2^15) >> 16)."""
    if pixels.shape[-1] in (1, 2):
        return pixels[..., 0]
    rgb = pixels[..., :3].astype(np.int64)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2] + 0x8000) >> 16).astype(np.uint8)


_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed-point coefficients for 8-bit images


def _bicubic(x: np.ndarray) -> np.ndarray:
    a, x = -0.5, np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_coefficients(in_size: int, out_size: int) -> np.ndarray:
    """PIL's bicubic resampling coefficients for one axis as an integer
    matrix [out_size, in_size] in its fixed point (support 2, widened by
    the scale when downsampling, normalised per output, rounded half away
    from zero)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    k = np.zeros((out_size, in_size))
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = _bicubic((np.arange(xmin, xmax) - center + 0.5) / filterscale)
        total = w.sum()
        k[xx, xmin:xmax] = w / total if total != 0.0 else w
    one = 1 << _PRECISION_BITS
    return np.where(k < 0, np.trunc(-0.5 + k * one), np.trunc(0.5 + k * one)).astype(np.int64)


def _pil_pass(img: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """One axis of PIL's resample on the last axis of uint8 ``img``."""
    acc = img.astype(np.int64) @ coeffs.T + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_gray(gray: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint8 [H, W] → [h, w] exactly as PIL's ``Image.resize((w, h))`` does
    for an 8-bit gray image by default: bicubic (a = -0.5), the width pass
    first, each pass rounded to 8 bits, a pass skipped where its size does
    not change."""
    out = np.asarray(gray, np.uint8)
    if out.shape[1] != w:
        out = _pil_pass(out, _pil_coefficients(out.shape[1], w))
    if out.shape[0] != h:
        out = _pil_pass(out.T, _pil_coefficients(out.shape[0], h)).T
    return np.ascontiguousarray(out)



def _read_with_pil(path: str) -> np.ndarray:
    """A non-PNG image through PIL, where it imports: uint8 [H, W, C] in
    its own mode (gray, RGB, with or without alpha; others as RGB)."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: only PNG files are read without PIL, and PIL is not "
                           "installed here; convert the image to PNG") from None
    with Image.open(path) as img:
        if img.mode not in ("L", "LA", "RGB", "RGBA"):
            img = img.convert("RGB")
        arr = np.asarray(img, np.uint8)
    return arr if arr.ndim == 3 else arr[..., None]


def read_image(path: str) -> np.ndarray:
    """uint8 [H, W, C] of a PNG (the port's reader) or, where PIL imports,
    of any other image file."""
    with open(path, "rb") as f:
        is_png = f.read(8) == PNG_SIGNATURE
    return read_png(path)[1] if is_png else _read_with_pil(path)


def to_rgb(pixels: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] → [H, W, 3] as PIL's ``convert("RGB")`` (gray
    repeated, alpha dropped)."""
    if pixels.shape[-1] in (1, 2):
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return pixels[..., :3]
