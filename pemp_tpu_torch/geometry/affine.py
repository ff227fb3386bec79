"""Affine geometry of resizing, training augmentation and output-coordinate
mapping (numpy copy of pemp_tpu.geometry.affine).

This math defines output-coordinate correctness against COCO evaluation, so
it follows the reference exactly:

  * get_transform            reference: src/Utils/transformations.py:142-167
  * get_affine_transform     reference: src/Utils/transformations.py:170-213
  * get_multi_scale_size     reference: src/Utils/transformations.py:216-237
  * get_multi_scale_size_hourglass
                             reference: src/Utils/hr_utils/multi_scales_testing.py:32-39
  * kpt_affine               reference: src/Utils/transformations.py:131-135
  * factor_affine            reference: src/Utils/transformations.py:138-139
  * reverse_affine_map       reference: src/Utils/transformations.py:7-76
  * three_point_affine       replaces cv2.getAffineTransform

The reverse map's ``short_mine`` scaling, which no configuration selects,
is not copied.
"""

from __future__ import annotations

import numpy as np


def three_point_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 2x3 affine matrix mapping three src points to three dst points
    (as cv2.getAffineTransform)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    a = np.concatenate([src, np.ones((3, 1))], axis=1)  # (3, 3)
    # a @ M.T = dst  ->  M.T = solve(a, dst)
    mt = np.linalg.solve(a, dst)  # (3, 2)
    return mt.T.astype(np.float64)  # (2, 3)


def get_transform(center, scale, res, rot: float = 0) -> np.ndarray:
    """Transformation matrix in the Hourglass convention (200px scale units).

    reference: src/Utils/transformations.py:142-167
    """
    scale = np.asarray(scale, dtype=np.float64)
    if scale.ndim == 0:
        scale = np.array([scale, scale])
    h = 200.0 * scale
    t = np.zeros((3, 3))
    t[0, 0] = float(res[1]) / h[1]
    t[1, 1] = float(res[0]) / h[0]
    t[0, 2] = res[1] * (-float(center[0]) / h[0] + 0.5)
    t[1, 2] = res[0] * (-float(center[1]) / h[1] + 0.5)
    t[2, 2] = 1.0
    if rot != 0:
        rot = -rot
        rot_mat = np.zeros((3, 3))
        rot_rad = rot * np.pi / 180.0
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        rot_mat[2, 2] = 1.0
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2.0
        t_mat[1, 2] = -res[0] / 2.0
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def _get_3rd_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float64)


def _get_dir(src_point, rot_rad: float):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array(
        [
            src_point[0] * cs - src_point[1] * sn,
            src_point[0] * sn + src_point[1] * cs,
        ]
    )


def get_affine_transform(
    center,
    scale,
    output_size,
    rot: float = 0.0,
    shift=(0.0, 0.0),
    inv: bool = False,
) -> np.ndarray:
    """Three-point-form affine transform (HigherHRNet convention).

    reference: src/Utils/transformations.py:170-213 and
    src/Utils/hr_utils/multi_scales_testing.py:72-106
    """
    scale = np.asarray(scale, dtype=np.float64)
    if scale.ndim == 0:
        scale = np.array([scale, scale])
    shift = np.asarray(shift, dtype=np.float64)

    scale_tmp = scale * 200.0
    src_w = scale_tmp[0]
    dst_w, dst_h = output_size[0], output_size[1]

    rot_rad = np.pi * rot / 180.0
    src_dir = _get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], dtype=np.float64)

    src = np.zeros((3, 2))
    dst = np.zeros((3, 2))
    src[0, :] = np.asarray(center, dtype=np.float64) + scale_tmp * shift
    src[1, :] = np.asarray(center, dtype=np.float64) + src_dir + scale_tmp * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    src[2, :] = _get_3rd_point(src[0, :], src[1, :])
    dst[2, :] = _get_3rd_point(dst[0, :], dst[1, :])

    if inv:
        return three_point_affine(dst, src)
    return three_point_affine(src, dst)


def get_multi_scale_size(img_h: int, img_w: int, input_size: int, current_scale: float,
                         min_scale: float):
    """64-multiple short-side sizing with scale in 200px units. Returns
    ((w_resized, h_resized), center, scale).

    reference: src/Utils/transformations.py:216-237
    """
    h, w = img_h, img_w
    center = np.array([int(w / 2.0 + 0.5), int(h / 2.0 + 0.5)])
    min_input_size = int((min_scale * input_size + 63) // 64 * 64)
    if w < h:
        w_resized = int(min_input_size * current_scale / min_scale)
        h_resized = int(int((min_input_size / w * h + 63) // 64 * 64) * current_scale / min_scale)
        scale_w = w / 200.0
        scale_h = h_resized / w_resized * w / 200.0
    else:
        h_resized = int(min_input_size * current_scale / min_scale)
        w_resized = int(int((min_input_size / h * w + 63) // 64 * 64) * current_scale / min_scale)
        scale_h = h / 200.0
        scale_w = w_resized / h_resized * h / 200.0
    return (w_resized, h_resized), center, np.array([scale_w, scale_h])


def get_multi_scale_size_hourglass(img_h: int, img_w: int, input_size: int,
                                   current_scale: float, min_scale: float):
    """The Hourglass's long-side sizing: a square input of the scale's
    64-multiple, centred, the long side in 200px units.

    reference: src/Utils/hr_utils/multi_scales_testing.py:32-39
    """
    center = np.array([img_w / 2.0, img_h / 2.0])
    scale = max(img_h, img_w) / 200.0
    inp_res = int((current_scale * input_size + 63) // 64 * 64)
    return (inp_res, inp_res), center, np.array([scale, scale])


def kpt_affine(kpt: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to (..., 2) points.

    reference: src/Utils/transformations.py:131-135
    """
    kpt = np.asarray(kpt)
    shape = kpt.shape
    kpt = kpt.reshape(-1, 2)
    ones = np.ones((kpt.shape[0], 1), dtype=kpt.dtype)
    return (np.concatenate([kpt, ones], axis=1) @ np.asarray(mat).T).reshape(shape)


def factor_affine(factors: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Scale OKS distance factors by the transform's area change.

    reference: src/Utils/transformations.py:138-139
    """
    return factors * mat[0, 0] * mat[1, 1]


def reverse_affine_map(
    keypoints: np.ndarray,
    img_size_orig,
    input_size: int,
    scaling_type: str,
    min_scale: float = 1.0,
) -> np.ndarray:
    """Map predicted keypoints back to original image coordinates.

    ``keypoints``: (P, J, 3), modified in place and returned.
    ``img_size_orig``: (width, height) of the image the scaling starts from.
    ``scaling_type``: ``short`` (keypoints at score-map resolution),
    ``short_with_resize`` (at input resolution), ``long`` or
    ``long_with_multiscale`` (the Hourglass's, at input / 4 on a 512 or
    1024 square canvas; the reference fixes ``input_size`` at 512).

    reference: src/Utils/transformations.py:7-76
    """
    if scaling_type in ("long", "long_with_multiscale"):
        if input_size != 512:
            raise NotImplementedError(f"scaling type {scaling_type!r} at input size "
                                      f"{input_size}: the reference maps back at 512 only")
        gt_width, gt_height = img_size_orig[0], img_size_orig[1]
        scale = np.array([max(gt_height, gt_width) / 200.0] * 2)
        res = 512 if scaling_type == "long" else 1024
        mat = get_transform(np.array((gt_width / 2, gt_height / 2)), scale, (res, res))
        inv_mat = np.linalg.pinv(mat)[:2]
        keypoints[:, :, :2] = kpt_affine(keypoints[:, :, :2] * 4, inv_mat)
        return keypoints
    if scaling_type not in ("short", "short_with_resize"):
        raise NotImplementedError(f"scaling type {scaling_type!r}")
    resized_img, center, scale = get_multi_scale_size(
        img_size_orig[1], img_size_orig[0], input_size, 1.0, min_scale
    )
    div = 2 if scaling_type == "short" else 1
    inv_mat = get_affine_transform(
        center, scale, (int(resized_img[0] / div), int(resized_img[1] / div)), inv=True
    )
    keypoints[:, :, :2] = kpt_affine(keypoints[:, :, :2], inv_mat)
    return keypoints


def get_scaling_type(config) -> str:
    """The eval scaling type. reference: src/valid.py:25-33"""
    scaling, several = config.DATASET.SCALING_TYPE, len(config.TEST.SCALE_FACTOR) > 1
    if scaling == "short":
        if several and not config.TEST.PROJECT2IMAGE:
            raise ValueError("several TEST.SCALE_FACTOR values need TEST.PROJECT2IMAGE")
        return "short_with_resize" if config.TEST.PROJECT2IMAGE else "short"
    if scaling == "long":
        if config.TEST.PROJECT2IMAGE:
            raise ValueError("DATASET.SCALING_TYPE long aggregates at score-map resolution: "
                             "it needs TEST.PROJECT2IMAGE false")
        return "long_with_multiscale" if several else "long"
    raise NotImplementedError(f"DATASET.SCALING_TYPE={scaling!r}")
