"""Mask and box visualisation, and LabelMe export (counterpart of
``tweediemix_tpu/segmentation/viz.py``).

The overlay is plain numpy: per-mask colour blending plus box outlines.
``mask_contours`` needs no OpenCV: it traces the external borders of a
binary mask as ``cv2.findContours(mask, RETR_EXTERNAL,
CHAIN_APPROX_SIMPLE)`` does (Suzuki and Abe's border following on the
mask framed by one pixel of background: each border starts at the first
pixel of a raster scan, is followed clockwise in image coordinates, keeps
only the points where its direction changes, and the borders come out in
the reverse order of their starts), and filters them by their shoelace
area, which is what ``cv2.contourArea`` computes.
"""

from __future__ import annotations

import numpy as np

# distinct overlay colours (RGB), cycled per detection
_PALETTE = np.array([
    [230, 57, 70], [29, 53, 87], [42, 157, 143], [233, 196, 106],
    [231, 111, 81], [69, 123, 157], [38, 70, 83], [244, 162, 97],
], np.float32)

MIN_AREA = 100  # drop speck contours


def load_image(path: str) -> np.ndarray:
    """Image file → float RGB array in [0, 1] (PNG through the port's
    reader; other formats where PIL is installed)."""
    from tweediemix_tpu_torch.utils.image import read_image

    return read_image(path).astype(np.float32) / 255.0


def draw_image(image: np.ndarray, masks, boxes=None, labels=None,
               alpha: float = 0.5, box_px: int = 2) -> np.ndarray:
    """Overlay masks (and optional xyxy boxes in [0, 1]) on an image.

    image: [H, W, 3] float in [0, 1]; masks: [K, H, W] bool/float;
    boxes: [K, 4] normalised xyxy. Returns [H, W, 3] float in [0, 1].
    """
    img = np.array(image, np.float32, copy=True)
    h, w = img.shape[:2]
    masks = np.asarray(masks, np.float32)
    for i, m in enumerate(masks):
        color = _PALETTE[i % len(_PALETTE)] / 255.0
        m3 = np.clip(m, 0.0, 1.0)[..., None]
        img = img * (1.0 - alpha * m3) + color * (alpha * m3)
    if boxes is not None:
        for i, b in enumerate(np.asarray(boxes, np.float32)):
            color = _PALETTE[i % len(_PALETTE)] / 255.0
            x0, y0, x1, y1 = (b * np.array([w, h, w, h])).astype(int)
            x0, x1 = np.clip([x0, x1], 0, w - 1)
            y0, y1 = np.clip([y0, y1], 0, h - 1)
            img[y0:y0 + box_px, x0:x1 + 1] = color
            img[max(0, y1 - box_px + 1):y1 + 1, x0:x1 + 1] = color
            img[y0:y1 + 1, x0:x0 + box_px] = color
            img[y0:y1 + 1, max(0, x1 - box_px + 1):x1 + 1] = color
    return np.clip(img, 0.0, 1.0)


# chain-code directions (x, y), y down: 0 right, 1 up-right, 2 up, ... 7
# down-right; counter-clockwise on the screen as the code grows
_STEPS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))
_VISITED = 2  # a traced border pixel
_RIGHT_EDGE = -2  # a traced border pixel whose right neighbour is background


def _follow_border(img: np.ndarray, y0: int, x0: int) -> list:
    """Trace the outer border that starts at (y0, x0), marking its pixels in
    ``img`` (the framed 0/1 mask, int8); returns the points (x, y) in the
    framed image where the chain changes direction, from the start."""
    # the first neighbour clockwise from the left (which is background)
    s = 4
    while True:
        s = (s - 1) & 7
        dx, dy = _STEPS[s]
        if img[y0 + dy, x0 + dx] != 0 or s == 4:
            break
    if s == 4:  # a single pixel
        img[y0, x0] = _RIGHT_EDGE
        return [(x0, y0)]
    y1, x1 = y0 + _STEPS[s][1], x0 + _STEPS[s][0]
    points = []
    y3, x3 = y0, x0
    prev_s = s ^ 4
    while True:
        s_end = s
        while True:  # counter-clockwise from the pixel we came from
            s += 1
            dx, dy = _STEPS[s & 7]
            y4, x4 = y3 + dy, x3 + dx
            if img[y4, x4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:  # the right neighbour was examined: background
            img[y3, x3] = _RIGHT_EDGE
        elif img[y3, x3] == 1:
            img[y3, x3] = _VISITED
        if s != prev_s:
            points.append((x3, y3))
            prev_s = s
        if (y4, x4) == (y0, x0) and (y3, x3) == (y1, x1):
            return points
        y3, x3 = y4, x4
        s = (s + 4) & 7


def _external_borders(mask: np.ndarray) -> list:
    """The outer borders of a binary [H, W] mask that lie in no hole of
    another component, each an [P, 2] int32 array of (x, y) points, in
    ``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``'s order."""
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = mask != 0
    found = []
    for y in range(1, h + 1):
        row = img[y]
        prev, lnbd, x = 0, 0, 1  # lnbd: the last traced border pixel met on this row
        while x <= w:
            rest = np.flatnonzero(row[x:w + 1] != prev)  # the next pixel that differs
            if not len(rest):
                break
            x += int(rest[0])
            p = int(row[x])
            if prev == 0 and p == 1:
                # an outer border starts here, unless the last traced border
                # to its left leaves it inside a component's hole
                if not row[lnbd] > 0:
                    found.append(np.array(_follow_border(img, y, x), np.int32) - 1)
                    prev = int(row[x])
                    x += 1
                    continue
            elif p == 0 and prev >= 2:  # a hole's border starts at x - 1 (not traced)
                lnbd = x - 1
            prev = p
            if p not in (0, 1):
                lnbd = x
            x += 1
    return found[::-1]


def contour_area(points: np.ndarray) -> float:
    """The shoelace area of a closed polygon [P, 2] (``cv2.contourArea``)."""
    if len(points) < 3:
        return 0.0
    x = points[:, 0].astype(np.int64)
    y = points[:, 1].astype(np.int64)
    return abs(float(np.sum(np.roll(x, 1) * y - x * np.roll(y, 1)))) * 0.5


def mask_contours(mask: np.ndarray, min_area: float = MIN_AREA):
    """Binary mask [H, W] → list of [P, 2] float32 contour point arrays
    (external borders, area-filtered)."""
    m = np.squeeze(np.asarray(mask))
    assert m.ndim == 2, m.shape
    return [c.astype(np.float32) for c in _external_borders(m > 0.5)
            if contour_area(c) > min_area]


def generate_labelme_json(binary_masks, labels, image_size, image_path=None):
    """Binary masks [N, H, W] + labels → LabelMe-format dict (polygon
    shapes from external contours)."""
    binary_masks = np.asarray(binary_masks)
    json_dict = {
        "version": "4.5.6",
        "imageHeight": int(image_size[0]),
        "imageWidth": int(image_size[1]),
        "imagePath": image_path,
        "flags": {},
        "shapes": [],
        "imageData": None,
    }
    for mask, label in zip(binary_masks, labels):
        for contour in mask_contours(mask):
            json_dict["shapes"].append({
                "label": label,
                "line_color": None,
                "fill_color": None,
                "points": [p.tolist() for p in contour],
                "shape_type": "polygon",
            })
    return json_dict
