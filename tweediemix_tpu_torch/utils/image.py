"""Image files without an imaging package: an 8-bit PNG reader and writer
(``zlib`` and ``struct``), an animated-GIF writer and reader, and the resize
that PIL's ``Image.resize`` applies by default to an 8-bit gray or RGB
image.

The PNG writer stores 8-bit gray or RGB, every row with filter 0. The PNG
reader takes 8-bit, non-interlaced gray, gray + alpha, RGB and RGBA with
any of the five row filters, and checks every chunk's CRC.

The GIF writer stores GIF89a: per frame an adaptive palette of at most 256
colours (a frame's own colours where it has no more, else a median cut of
them), LZW-coded indices, a ``NETSCAPE2.0`` loop count and a delay in
centiseconds; the reader decodes what it writes (and other GIFs without
interlacing).
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
    """One axis of PIL's resample on the last axis of uint8 ``img``. Every
    product and partial sum is an integer below 2^31, so a float64 product
    (BLAS) sums them exactly."""
    flat = np.ascontiguousarray(img, np.float64).reshape(-1, img.shape[-1])
    acc = (flat @ coeffs.T.astype(np.float64)).astype(np.int64).reshape(*img.shape[:-1], -1)
    return np.clip((acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_planes(planes: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint8 [..., H, W] → [..., h, w] as PIL resizes each band: the width
    pass first, each pass rounded to 8 bits, a pass skipped where its size
    does not change."""
    out = np.asarray(planes, np.uint8)
    if out.shape[-1] != w:
        out = _pil_pass(out, _pil_coefficients(out.shape[-1], w))
    if out.shape[-2] != h:
        out = np.swapaxes(_pil_pass(np.swapaxes(out, -1, -2), _pil_coefficients(out.shape[-2], h)),
                          -1, -2)
    return np.ascontiguousarray(out)


def resize_gray(gray: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint8 [H, W] → [h, w] exactly as PIL's ``Image.resize((w, h))`` does
    for an 8-bit gray image by default: bicubic (a = -0.5) in PIL's fixed
    point."""
    return _resize_planes(gray, h, w)


def resize_rgb(rgb: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint8 [H, W, 3] → [h, w, 3] exactly as PIL's ``Image.resize((w, h))``
    does for an RGB image by default: each band resampled on its own with
    the gray image's coefficients."""
    return np.ascontiguousarray(np.moveaxis(_resize_planes(np.moveaxis(rgb, -1, 0), h, w), 0, -1))



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
    """uint8 [H, W, 3] of a PNG (the port's reader; gray, RGB, with or
    without alpha) or, where PIL imports, of any other image file, as PIL's
    ``Image.open(path).convert("RGB")`` gives it."""
    with open(path, "rb") as f:
        is_png = f.read(8) == PNG_SIGNATURE
    return to_rgb(read_png(path)[1] if is_png else _read_with_pil(path))


def to_rgb(pixels: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] → [H, W, 3] as PIL's ``convert("RGB")`` (gray
    repeated, alpha dropped)."""
    if pixels.shape[-1] in (1, 2):
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return pixels[..., :3]


# -- animated GIF -------------------------------------------------------------

_LZW_MAX_CODES = 4096  # 12-bit codes
_GIF_COLOURS = 256


def median_cut_palette(pixels: np.ndarray):
    """uint8 [..., 3] → (palette uint8 [P, 3], P ≤ 256; indices [...] into
    it). A frame with at most 256 distinct colours keeps them exactly.
    Otherwise its distinct colours, weighted by their pixel counts, are
    split by median cut: the box with the widest channel range is cut at
    the weighted median of that channel until there are 256 boxes, and
    each box's colour is its pixels' rounded mean."""
    flat = np.asarray(pixels, np.uint8).reshape(-1, 3).astype(np.int64)
    packed = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    uniq, inverse, counts = np.unique(packed, return_inverse=True, return_counts=True)
    rgb = np.stack([uniq >> 16, (uniq >> 8) & 0xFF, uniq & 0xFF], axis=1).astype(np.uint8)
    if len(uniq) <= _GIF_COLOURS:
        return rgb, inverse.reshape(pixels.shape[:-1])

    def spread(box):
        c = rgb[box]
        return c.max(axis=0).astype(np.int64) - c.min(axis=0)

    boxes = [np.arange(len(uniq))]
    spreads = [spread(boxes[0])]
    widest = [int(spreads[0].max())]  # -1 for a box of one colour
    while len(boxes) < _GIF_COLOURS:
        i = int(np.argmax(widest))
        box, axis = boxes.pop(i), int(np.argmax(spreads.pop(i)))
        widest.pop(i)
        box = box[np.argsort(rgb[box, axis], kind="stable")]
        weight = np.cumsum(counts[box])
        cut = min(max(int(np.searchsorted(weight, weight[-1] / 2)) + 1, 1), len(box) - 1)
        for part in (box[:cut], box[cut:]):
            boxes.append(part)
            spreads.append(spread(part))
            widest.append(int(spreads[-1].max()) if len(part) > 1 else -1)
    palette = np.empty((len(boxes), 3), np.uint8)
    box_of = np.empty(len(uniq), np.int64)
    for j, box in enumerate(boxes):
        w = counts[box]
        palette[j] = np.round((rgb[box] * w[:, None]).sum(axis=0) / w.sum())
        box_of[box] = j
    return palette, box_of[inverse].reshape(pixels.shape[:-1])


def _lzw_encode(indices: bytes, min_code_size: int) -> bytes:
    """GIF's variable-width LZW (codes of ``min_code_size`` + 1 to 12 bits,
    least significant bit first, a clear code first and whenever the table
    fills, the end code last)."""
    clear = 1 << min_code_size
    end = clear + 1
    codes, widths = [clear], [min_code_size + 1]
    table = {}
    next_code, width = end + 1, min_code_size + 1
    prefix = indices[0]
    for b in indices[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        if next_code < _LZW_MAX_CODES:
            table[key] = next_code
            next_code += 1
            # the decoder reads a wider code once its table (one entry
            # behind this one) has filled the current width
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            codes.append(clear)
            widths.append(width)
            table.clear()
            next_code, width = end + 1, min_code_size + 1
        prefix = b
    codes += [prefix, end]
    widths += [width, width]
    codes, widths = np.asarray(codes, np.int64), np.asarray(widths, np.int64)
    bits = (codes[:, None] >> np.arange(12)) & 1
    keep = np.arange(12)[None, :] < widths[:, None]
    return np.packbits(bits[keep].astype(np.uint8), bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i : i + 255])]) + data[i : i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def write_gif(path: str, frames: np.ndarray, duration_ms: int) -> None:
    """uint8 [F, H, W, 3] → an animated GIF89a: each frame with its own
    ``median_cut_palette`` (frame 0's as the global table), shown for
    ``duration_ms`` milliseconds (stored as ``duration_ms // 10``
    centiseconds, as PIL stores it), looping forever (loop count 0)."""
    frames = np.asarray(frames, np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"write_gif takes uint8 [F, H, W, 3] frames, got {frames.shape}")
    _, h, w, _ = frames.shape
    out = [b"GIF89a"]
    for i, frame in enumerate(frames):
        palette, indices = median_cut_palette(frame)
        bits = max(1, int(np.ceil(np.log2(len(palette)))))
        table = np.zeros((1 << bits, 3), np.uint8)
        table[: len(palette)] = palette
        flags = 0x80 | (bits - 1)  # a colour table of 2^bits entries
        if i == 0:
            out.append(struct.pack("<HHBBB", w, h, flags | 0x70, 0, 0) + table.tobytes())
            out.append(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", duration_ms // 10) + b"\x00\x00")
        descriptor = b"\x2c" + struct.pack("<HHHH", 0, 0, w, h)
        out.append(descriptor + (b"\x00" if i == 0 else bytes([flags]) + table.tobytes()))
        min_code_size = max(2, bits)
        data = _lzw_encode(indices.astype(np.uint8).tobytes(), min_code_size)
        out.append(bytes([min_code_size]) + _sub_blocks(data))
    out.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(out))


def _lzw_decode(data: bytes, min_code_size: int, n: int) -> bytes:
    """The inverse of ``_lzw_encode``: the first ``n`` indices."""
    clear = 1 << min_code_size
    end = clear + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    width, prev = min_code_size + 1, None
    out, have = [], 0
    acc = nbits = pos = 0
    while have < n:
        while nbits < width:
            if pos >= len(data):
                raise ValueError("GIF image data ends before its pixels")
            acc |= data[pos] << nbits
            pos += 1
            nbits += 8
        code = acc & ((1 << width) - 1)
        acc >>= width
        nbits -= width
        if code == clear:
            table, width, prev = list(base), min_code_size + 1, None
            continue
        if code == end:
            break
        if prev is None:
            entry = table[code]
        else:
            entry = table[code] if code < len(table) else prev + prev[:1]
            if len(table) < _LZW_MAX_CODES:
                table.append(prev + entry[:1])
                if len(table) == (1 << width) and width < 12:
                    width += 1
        out.append(entry)
        have += len(entry)
        prev = entry
    return b"".join(out)[:n]


def read_gif(path: str):
    """An animated GIF → (header dict: width, height, loop (None without a
    ``NETSCAPE2.0`` block), durations_ms per frame; frames uint8
    [F, H, W, 3]). Frames are taken whole (each covers the screen, as
    ``write_gif`` writes them); interlaced images are refused."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF")
    w, h, flags, _, _ = struct.unpack("<HHBBB", data[6:13])
    pos = 13
    global_table = None
    if flags & 0x80:
        size = 3 << ((flags & 7) + 1)
        global_table = np.frombuffer(data[pos : pos + size], np.uint8).reshape(-1, 3)
        pos += size

    def blocks(pos):
        chunks = []
        while data[pos]:
            chunks.append(data[pos + 1 : pos + 1 + data[pos]])
            pos += 1 + data[pos]
        return b"".join(chunks), pos + 1

    header = dict(width=w, height=h, loop=None, durations_ms=[])
    frames, delay = [], 0
    while pos < len(data):
        tag = data[pos]
        if tag == 0x3B:
            break
        if tag == 0x21:
            label = data[pos + 1]
            body, pos = blocks(pos + 2)
            if label == 0xF9:
                delay = struct.unpack("<H", body[1:3])[0] * 10
            elif label == 0xFF and body[:11] == b"NETSCAPE2.0":
                header["loop"] = struct.unpack("<H", body[12:14])[0]
            continue
        if tag != 0x2C:
            raise ValueError(f"{path}: unknown block 0x{tag:02x}")
        _, _, fw, fh, fflags = struct.unpack("<HHHHB", data[pos + 1 : pos + 10])
        pos += 10
        table = global_table
        if fflags & 0x80:
            size = 3 << ((fflags & 7) + 1)
            table = np.frombuffer(data[pos : pos + size], np.uint8).reshape(-1, 3)
            pos += size
        if fflags & 0x40 or (fw, fh) != (w, h) or table is None:
            raise ValueError(f"{path}: only whole, non-interlaced frames with a colour table are read")
        min_code_size = data[pos]
        body, pos = blocks(pos + 1)
        indices = np.frombuffer(_lzw_decode(body, min_code_size, w * h), np.uint8)
        frames.append(table[indices].reshape(h, w, 3))
        header["durations_ms"].append(delay)
    return header, np.stack(frames)
