"""Training targets: Gaussian heatmaps and AE joint indices (numpy copy of
pemp_tpu.data.targets: ``HeatmapGenerator``, ``JointsGenerator``,
``filter_visible`` and ``pack_for_batch``; reference: src/data/utils.py:4-85). Host-side, shapes
fixed to (max_people, J, ...) so batches stack.
"""

from __future__ import annotations

import numpy as np


class HeatmapGenerator:
    """Per-joint Gaussian splat. reference: data/utils.py:30-65."""

    def __init__(self, output_res: int, num_joints: int, sigma: float = -1):
        self.output_res = output_res
        self.num_joints = num_joints
        if sigma < 0:
            sigma = output_res / 64
        self.sigma = sigma
        size = int(6 * sigma + 3)
        x = np.arange(0, size, 1, float)
        y = x[:, np.newaxis]
        x0 = y0 = 3 * sigma + 1
        self.g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2))

    def __call__(self, joints, factors=None):
        res = self.output_res
        hms = np.zeros((self.num_joints, res, res), dtype=np.float32)
        sigma = self.sigma
        for p in joints:
            for idx, pt in enumerate(p):
                if pt[2] > 0:
                    x, y = int(pt[0]), int(pt[1])
                    if x < 0 or y < 0 or x >= res or y >= res:
                        continue
                    ul = int(np.round(x - 3 * sigma - 1)), int(np.round(y - 3 * sigma - 1))
                    br = int(np.round(x + 3 * sigma + 2)), int(np.round(y + 3 * sigma + 2))
                    c, d = max(0, -ul[0]), min(br[0], res) - ul[0]
                    a, b = max(0, -ul[1]), min(br[1], res) - ul[1]
                    cc, dd = max(0, ul[0]), min(br[0], res)
                    aa, bb = max(0, ul[1]), min(br[1], res)
                    hms[idx, aa:bb, cc:dd] = np.maximum(
                        hms[idx, aa:bb, cc:dd], self.g[a:b, c:d]
                    )
        return hms


class JointsGenerator:
    """AE-loss flat-index targets (max_people, J, 2).

    reference: data/utils.py:4-27.
    """

    def __init__(self, max_num_people: int, num_joints: int, output_res: int, tag_per_joint: bool):
        self.max_num_people = max_num_people
        self.num_joints = num_joints
        self.output_res = output_res
        self.tag_per_joint = tag_per_joint

    def __call__(self, joints):
        visible_nodes = np.zeros((self.max_num_people, self.num_joints, 2))
        res = self.output_res
        for i in range(len(joints)):
            tot = 0
            for idx, pt in enumerate(joints[i]):
                x, y = int(pt[0]), int(pt[1])
                if pt[2] > 0 and 0 <= x < res and 0 <= y < res:
                    if self.tag_per_joint:
                        visible_nodes[i][tot] = (idx * res * res + y * res + x, 1)
                    else:
                        visible_nodes[i][tot] = (y * res + x, 1)
                    tot += 1
        return visible_nodes


def filter_visible(keypoints, output_shape):
    """Zero out keypoints outside the output canvas.

    reference: data/utils.py:68-77.
    """
    out_h, out_w = output_shape[0], output_shape[1]
    vis = keypoints.copy()
    if len(keypoints) == 0:
        return vis
    x, y = keypoints[..., 0], keypoints[..., 1]
    bad = (x < 0) | (x >= out_w) | (y < 0) | (y >= out_h)
    vis[bad] = 0.0
    return vis


def pack_for_batch(array, max_num_people):
    """Pad the person dimension to a fixed size. reference: data/utils.py:80-85."""
    new_shape = list(array.shape)
    new_shape[0] = max_num_people
    out = np.zeros(new_shape, dtype=array.dtype if array.size else np.float32)
    out[: len(array)] = array
    return out
