"""COCO run-length-encoded mask utilities, pure numpy (copy of
pemp_tpu.data.rle).

Replaces pycocotools.mask (C extension, unavailable here) for the subset the
framework needs: polygon -> mask, compressed/uncompressed RLE decode, and
frPyObjects/decode compatible entry points
(reference usage: src/data/CocoKeypoints_hr.py:113-127).

COCO RLE conventions: column-major (Fortran) order; compressed counts use the
LEB128-with-sign variant from the COCO API.
"""

from __future__ import annotations

import numpy as np


def decode_compressed_counts(s: str) -> list[int]:
    """Decode the COCO compressed counts string to a list of run lengths."""
    counts = []
    p = 0
    prev = 0
    data = s.encode("ascii") if isinstance(s, str) else s
    while p < len(data):
        x = 0
        k = 0
        more = True
        while more:
            c = data[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        prev = x
        counts.append(x)
    return counts


def rle_decode(rle: dict) -> np.ndarray:
    """Decode an RLE dict {'size': [h, w], 'counts': str|list} to a (h, w) mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = decode_compressed_counts(counts)
    mask_flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        c = int(c)
        if val:
            mask_flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return mask_flat.reshape(w, h).T  # column-major


def polygon_to_mask(polygon, h: int, w: int) -> np.ndarray:
    """Rasterize one polygon [x0, y0, x1, y1, ...] via even-odd scanline fill.

    Matches the COCO API's polygon semantics closely enough for crowd
    masking (sub-pixel edge handling approximated at pixel centers).
    """
    xs = np.asarray(polygon[0::2], dtype=np.float64)
    ys = np.asarray(polygon[1::2], dtype=np.float64)
    n = len(xs)
    mask = np.zeros((h, w), dtype=np.uint8)
    if n < 3:
        # degenerate: mark covered pixels directly
        for x, y in zip(xs, ys):
            xi, yi = int(x), int(y)
            if 0 <= yi < h and 0 <= xi < w:
                mask[yi, xi] = 1
        return mask

    y0 = max(int(np.floor(ys.min())), 0)
    y1 = min(int(np.ceil(ys.max())) + 1, h)
    x2 = np.roll(xs, -1)
    y2 = np.roll(ys, -1)
    for row in range(y0, y1):
        yc = row + 0.5
        # edges crossing this scanline
        cross = ((ys <= yc) & (y2 > yc)) | ((y2 <= yc) & (ys > yc))
        if not cross.any():
            continue
        t = (yc - ys[cross]) / (y2[cross] - ys[cross])
        x_int = np.sort(xs[cross] + t * (x2[cross] - xs[cross]))
        for i in range(0, len(x_int) - 1, 2):
            a = max(int(np.ceil(x_int[i] - 0.5)), 0)
            b = min(int(np.ceil(x_int[i + 1] - 0.5)), w)
            if b > a:
                mask[row, a:b] = 1
    return mask


def segmentation_to_mask(segm, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation (polygons, RLE dict, uncompressed RLE) -> mask."""
    if isinstance(segm, list):
        mask = np.zeros((h, w), dtype=np.uint8)
        for poly in segm:
            mask |= polygon_to_mask(poly, h, w)
        return mask
    if isinstance(segm, dict):
        return rle_decode(segm)
    raise TypeError(type(segm))
