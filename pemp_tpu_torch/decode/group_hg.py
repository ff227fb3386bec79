"""Hourglass AE grouping parsers (HeatmapParserHG / HeatmapParserHG2) on
the host (copy of pemp_tpu.decode.group_hg, which the port may not import).

The reference's hourglass-specific AE parsers (reference:
src/Utils/hr_utils/group_hg.py:192-488) in numpy. They differ from the
HRNet parser (decode/ae_grouping.py) in load-bearing details, each kept
deliberately and held to the JAX package's copy exactly by the CPU tests:

* ``match_by_tag_1`` (HG) calls ``py_max_match(diff_normed)`` where
  ``py_max_match(s)`` computes ``Munkres().compute(-s)`` — i.e. the HG
  parser *maximises* tag distance in its assignment step
  (group_hg.py:31-35, 156). This is an inherited convention mismatch in
  the reference (pose-ae-train's py_max_match negates internally, Bin
  Xiao's match_by_tag passes a cost), kept verbatim: with
  ``use_detection_val=False`` the ``tag_threshold`` check routes far
  pairs into new groups, so the quirk changes grouping on crowded scenes.
* ``match_by_tag_2`` (HG2) measures tag distance as an RMS over tag dims
  (``mean(axis=2) ** 0.5``, group_hg.py:64) instead of an L2 norm, and
  passes ``-diff`` so the assignment genuinely minimises.
* HG's ``refine`` fills missing joints with the *heatmap value* as score
  (group_hg.py:326-331); the module-level ``refine`` used by HG2 fills
  with score **1** (group_hg.py:404-409). Both differ from the HR
  parser's fill (heatmap value) and Utils.py refine's 0.001.
* ``adjust`` applies the +0.5 centre offset *inside* adjust
  (group_hg.py:250-256) — the HR parser adds it in top_k.
"""

from __future__ import annotations

import numpy as np

from pemp_tpu_torch.decode.munkres import Munkres


def py_max_match(scores: np.ndarray) -> np.ndarray:
    """reference: group_hg.py:31-35 — note the internal negation."""
    pairs = Munkres().compute(-np.asarray(scores, np.float64))
    if not pairs:
        return np.zeros((0, 2), np.int32)
    return np.asarray(pairs, np.int32)


class ParamsHG:
    """reference: group_hg.py:175-190."""

    def __init__(self, num_joints: int = 17, max_num_people: int = 30):
        self.num_joints = num_joints
        self.max_num_people = max_num_people
        self.detection_threshold = 0.1
        self.tag_threshold = 1.0
        self.use_detection_val = False
        self.ignore_too_much = False
        if num_joints == 17:
            self.joint_order = [
                i - 1
                for i in [1, 2, 3, 4, 5, 6, 7, 12, 13, 8, 9, 10, 11, 14, 15, 16, 17]
            ]
        else:
            self.joint_order = list(range(num_joints))


def match_by_tag_1(tag_k, loc_k, val_k, params: ParamsHG) -> np.ndarray:
    """reference: group_hg.py:103-172 (HG variant; max-distance quirk)."""
    default_ = np.zeros((params.num_joints, 3 + tag_k.shape[2]))
    joint_dict = {}
    tag_dict = {}
    for i in range(params.num_joints):
        idx = params.joint_order[i]
        tags = tag_k[idx]
        joints = np.concatenate((loc_k[idx], val_k[idx, :, None], tags), 1)
        mask = joints[:, 2] > params.detection_threshold
        tags = tags[mask]
        joints = joints[mask]
        if joints.shape[0] == 0:
            continue
        if i == 0 or len(joint_dict) == 0:
            for tag, joint in zip(tags, joints):
                key = tag[0]
                joint_dict.setdefault(key, np.copy(default_))[idx] = joint
                tag_dict[key] = [tag]
        else:
            grouped_keys = list(joint_dict.keys())[: params.max_num_people]
            grouped_tags = [np.mean(tag_dict[k], axis=0) for k in grouped_keys]
            if params.ignore_too_much and len(grouped_keys) == params.max_num_people:
                continue
            diff = joints[:, None, 3:] - np.array(grouped_tags)[None, :, :]
            diff_normed = np.linalg.norm(diff, ord=2, axis=2)
            diff_saved = np.copy(diff_normed)
            if params.use_detection_val:
                diff_normed = np.round(diff_normed) * 100 - joints[:, 2:3]
            num_added, num_grouped = diff.shape[0], diff.shape[1]
            if num_added > num_grouped:
                diff_normed = np.concatenate(
                    [diff_normed, np.zeros((num_added, num_added - num_grouped)) + 1e10],
                    axis=1,
                )
            # reference passes the raw distance to py_max_match, whose
            # internal negation makes this a MAX-distance assignment
            pairs = py_max_match(diff_normed)
            for row, col in pairs:
                if (
                    row < num_added
                    and col < num_grouped
                    and diff_saved[row][col] < params.tag_threshold
                ):
                    key = grouped_keys[col]
                    joint_dict[key][idx] = joints[row]
                    tag_dict[key].append(tags[row])
                else:
                    key = tags[row][0]
                    joint_dict.setdefault(key, np.copy(default_))[idx] = joints[row]
                    tag_dict[key] = [tags[row]]
    return np.array([joint_dict[k] for k in joint_dict]).astype(np.float32).reshape(
        -1, params.num_joints, 3 + tag_k.shape[2]
    )


def match_by_tag_2(tag_k, loc_k, val_k, params: ParamsHG) -> np.ndarray:
    """reference: group_hg.py:37-101 (HG2 variant; RMS distance, min-cost)."""
    default_ = np.zeros((params.num_joints, 3 + tag_k.shape[2]))
    dic = {}
    dic2 = {}
    for i in range(params.num_joints):
        pt_idx = params.joint_order[i]
        tags = tag_k[pt_idx]
        joints = np.concatenate((loc_k[pt_idx], val_k[pt_idx, :, None], tags), 1)
        mask = joints[:, 2] > params.detection_threshold
        tags = tags[mask]
        joints = joints[mask]
        if i == 0 or len(dic) == 0:
            for tag, joint in zip(tags, joints):
                dic.setdefault(tag[0], np.copy(default_))[pt_idx] = joint
                dic2[tag[0]] = [tag]
        else:
            actual_keys = list(dic.keys())[: params.max_num_people]
            actual_tags = [np.mean(dic2[k], axis=0) for k in actual_keys]
            if params.ignore_too_much and len(actual_tags) == params.max_num_people:
                continue
            # RMS over tag dims, not an L2 norm (group_hg.py:64)
            diff = (
                (joints[:, None, 3:] - np.array(actual_tags)[None, :, :]) ** 2
            ).mean(axis=2) ** 0.5
            if diff.shape[0] == 0:
                continue
            diff2 = np.copy(diff)
            if params.use_detection_val:
                diff = np.round(diff) * 100 - joints[:, 2:3]
            if diff.shape[0] > diff.shape[1]:
                diff = np.concatenate(
                    [diff, np.zeros((diff.shape[0], diff.shape[0] - diff.shape[1])) + 1e10],
                    axis=1,
                )
            pairs = py_max_match(-diff)  # -> min-cost on diff
            for row, col in pairs:
                if (
                    row < diff2.shape[0]
                    and col < diff2.shape[1]
                    and diff2[row][col] < params.tag_threshold
                ):
                    dic[actual_keys[col]][pt_idx] = joints[row]
                    dic2[actual_keys[col]].append(tags[row])
                else:
                    key = tags[row][0]
                    dic.setdefault(key, np.copy(default_))[pt_idx] = joints[row]
                    dic2[key] = [tags[row]]
    return np.array([dic[k] for k in dic]).astype(np.float32).reshape(
        -1, params.num_joints, 3 + tag_k.shape[2]
    )


def _nms_maxpool3(det: np.ndarray) -> np.ndarray:
    """3x3 stride-1 maxpool NMS per channel. reference: group_hg.py:270-274."""
    j, h, w = det.shape
    pad = np.full((j, h + 2, w + 2), -np.inf, det.dtype)
    pad[:, 1:-1, 1:-1] = det
    stacked = np.stack(
        [pad[:, dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]
    )
    maxm = stacked.max(axis=0)
    return det * (maxm == det)


def _top_k(det: np.ndarray, tag: np.ndarray, max_people: int):
    """Per-joint top-K over the NMSed flattened maps; loc as (x, y).

    reference: group_hg.py:281-318 (HG.top_k) / :440-457 (HG2.calc) —
    identical selection math.
    """
    j, h, w = det.shape
    det_n = _nms_maxpool3(det)
    flat = det_n.reshape(j, -1)
    # torch.topk: sorted descending, ties by lower flat index first;
    # argsort(-flat, kind="stable") reproduces that order
    ind = np.argsort(-flat, axis=1, kind="stable")[:, :max_people]
    val_k = np.take_along_axis(flat, ind, axis=1)
    if tag.ndim == 3:
        tag = tag[..., None]
    tag_flat = tag.reshape(j, h * w, -1)
    tag_k = np.stack(
        [np.take_along_axis(tag_flat[:, :, i], ind, axis=1) for i in range(tag_flat.shape[2])],
        axis=2,
    )
    x = ind % w
    y = ind // w
    loc_k = np.stack([x, y], axis=2)
    return tag_k, loc_k.astype(np.float64), val_k


def _adjust_hg(ans: np.ndarray, det: np.ndarray) -> np.ndarray:
    """Quarter-pixel adjust with the reference's coordinate-swap dance and
    in-adjust +0.5 offset. reference: group_hg.py:246-267 / :459-478."""
    for person in ans:
        for joint_id, joint in enumerate(person):
            if joint[2] > 0:
                y, x = joint[0:2]
                xx, yy = int(x), int(y)
                tmp = det[joint_id]
                if tmp[xx, min(yy + 1, tmp.shape[1] - 1)] > tmp[xx, max(yy - 1, 0)]:
                    y += 0.25
                else:
                    y -= 0.25
                if tmp[min(xx + 1, tmp.shape[0] - 1), yy] > tmp[max(0, xx - 1), yy]:
                    x += 0.25
                else:
                    x -= 0.25
                person[joint_id, 0:2] = (y + 0.5, x + 0.5)
    return ans


def refine_hg(det: np.ndarray, tag: np.ndarray, keypoints: np.ndarray) -> np.ndarray:
    """HG missing-joint refine: fill score = heatmap value.

    reference: group_hg.py:269-332 (HeatmapParserHG.refine).
    """
    if tag.ndim == 3:
        tag = tag[:, :, :, None]
    tags = []
    for i in range(keypoints.shape[0]):
        if keypoints[i, 2] > 0:
            x, y = keypoints[i][:2].astype(np.int32)
            tags.append(tag[i, y, x])
    prev_tag = np.mean(tags, axis=0)
    ans = []
    for i in range(keypoints.shape[0]):
        tmp = det[i, :, :]
        tt = ((tag[i, :, :] - prev_tag[None, None, :]) ** 2).sum(axis=2) ** 0.5
        tmp2 = tmp - np.round(tt)
        y, x = np.unravel_index(np.argmax(tmp2), tmp.shape)
        xx, yy = x, y
        val = tmp[y, x]
        x += 0.5
        y += 0.5
        if tmp[yy, min(xx + 1, tmp.shape[1] - 1)] > tmp[yy, max(xx - 1, 0)]:
            x += 0.25
        else:
            x -= 0.25
        if tmp[min(yy + 1, tmp.shape[0] - 1), xx] > tmp[max(0, yy - 1), xx]:
            y += 0.25
        else:
            y -= 0.25
        ans.append((x, y, val))
    ans = np.array(ans)
    for i in range(det.shape[0]):
        if ans[i, 2] > 0 and keypoints[i, 2] == 0:
            keypoints[i, :2] = ans[i, :2]
            keypoints[i, 2] = ans[i, 2]
    return keypoints


def refine_hg2(det: np.ndarray, tag: np.ndarray, keypoints: np.ndarray,
               adjust: bool = True) -> np.ndarray:
    """HG2 module-level refine: transposed tag indexing, fill score = 1.

    reference: group_hg.py:358-412 (module-level ``refine``). Note the
    double coordinate swap (keypoints unpacked (y, x), tag indexed
    [i, x, y]) and the hard-coded 17-joint fill loop, both kept verbatim.
    """
    if tag.ndim == 3:
        tag = tag[:, :, :, None]
    tags = []
    for i in range(keypoints.shape[0]):
        if keypoints[i, 2] > 0:
            y, x = keypoints[i][:2].astype(np.int32)
            tags.append(tag[i, x, y])
    prev_tag = np.mean(tags, axis=0)
    ans = []
    for i in range(keypoints.shape[0]):
        tmp = det[i, :, :]
        tt = ((tag[i, :, :] - prev_tag[None, None, :]) ** 2).sum(axis=2) ** 0.5
        tmp2 = tmp - np.round(tt)
        x, y = np.unravel_index(np.argmax(tmp2), tmp.shape)
        val = tmp[x, y]
        if adjust:
            xx, yy = x, y
            x += 0.5
            y += 0.5
            if tmp[xx, min(yy + 1, det.shape[1] - 1)] > tmp[xx, max(yy - 1, 0)]:
                y += 0.25
            else:
                y -= 0.25
            if tmp[min(xx + 1, det.shape[0] - 1), yy] > tmp[max(0, xx - 1), yy]:
                x += 0.25
            else:
                x -= 0.25
        x, y = np.array([y, x])
        ans.append((x, y, val))
    ans = np.array(ans)
    for i in range(17):
        if ans[i, 2] > 0 and keypoints[i, 2] == 0:
            keypoints[i, :2] = ans[i, :2]
            keypoints[i, 2] = 1
    return keypoints


class HeatmapParserHG:
    """Hourglass AE parser. reference: group_hg.py:192-355.

    Inputs are numpy (J, H, W) det and (J, H, W[, F]) tag maps (batch=1
    semantics of the reference, tensors pre-squeezed).
    """

    def __init__(self, cfg=None, num_joints: int = 17, max_num_people: int = 30):
        if cfg is not None:
            num_joints = cfg.DATASET.NUM_JOINTS
            max_num_people = cfg.DATASET.MAX_NUM_PEOPLE
        self.params = ParamsHG(num_joints, max_num_people)
        self.tag_per_joint = True

    def parse(self, det: np.ndarray, tag: np.ndarray, adjust: bool = True,
              refine: bool = True):
        tag_k, loc_k, val_k = _top_k(det, tag, self.params.max_num_people)
        ans = match_by_tag_1(tag_k, loc_k, val_k, self.params)
        if adjust:
            ans = _adjust_hg(ans, det)
        scores = [person[:, 2].mean() for person in ans]
        if refine:
            tag4 = tag if tag.ndim == 4 else tag[..., None]
            for i in range(len(ans)):
                ans[i] = refine_hg(det, tag4, ans[i])
        return ans, scores


class HeatmapParserHG2:
    """Hourglass AE parser, variant 2. reference: group_hg.py:414-488."""

    def __init__(self, detection_val: float = 0.03, tag_val: float = 1.0):
        param = ParamsHG()
        param.detection_threshold = 0.1
        param.tag_threshold = tag_val
        param.ignore_too_much = True
        param.max_num_people = 30
        param.use_detection_val = True
        self.param = param

    def parse(self, det: np.ndarray, tag: np.ndarray, adjust: bool = True):
        tag_k, loc_k, val_k = _top_k(det, tag, self.param.max_num_people)
        ans = match_by_tag_2(tag_k, loc_k, val_k, self.param)
        scores = [person[:, 2].mean() for person in ans]
        if adjust:
            ans = _adjust_hg(ans, det)
        for i in range(len(ans)):
            ans[i] = refine_hg2(det, tag, ans[i])
        return ans, scores
