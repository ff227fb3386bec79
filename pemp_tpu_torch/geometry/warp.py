"""Host-side bilinear image warp (numpy copy of pemp_tpu.geometry.warp's
``warp_affine``, which replaces cv2.warpAffine).

``mat`` maps source -> destination coordinates; sampling inverts it and
interpolates bilinearly with constant(0) borders.
"""

from __future__ import annotations

import numpy as np


def invert_2x3(mat: np.ndarray) -> np.ndarray:
    m = np.eye(3)
    m[:2] = mat
    return np.linalg.inv(m)[:2]


def warp_affine(image: np.ndarray, mat: np.ndarray, out_size) -> np.ndarray:
    """Bilinear affine warp.

    image: (H, W) or (H, W, C); mat: 2x3 source->dest; out_size: (W_out, H_out).
    """
    out_w, out_h = int(out_size[0]), int(out_size[1])
    inv = invert_2x3(np.asarray(mat, dtype=np.float64))

    ys, xs = np.meshgrid(np.arange(out_h), np.arange(out_w), indexing="ij")
    src_x = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    src_y = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]

    h, w = image.shape[:2]
    x0 = np.floor(src_x).astype(np.int64)
    y0 = np.floor(src_y).astype(np.int64)
    fx = src_x - x0
    fy = src_y - y0

    def gather(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        yc = np.clip(yy, 0, h - 1)
        xc = np.clip(xx, 0, w - 1)
        vals = image[yc, xc]
        if image.ndim == 3:
            vals = np.where(valid[..., None], vals, 0)
        else:
            vals = np.where(valid, vals, 0)
        return vals.astype(np.float64)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    if image.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    out = (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )
    return out.astype(np.float32)
