"""Associative-embedding grouping on the host (counterpart of
pemp_tpu.decode.ae_grouping): the HigherHRNet parser and correlation
clustering on the tags.

``match_by_tag`` follows the reference's algorithm exactly
(src/Utils/hr_utils/group.py:42-117 and src/Utils/Utils.py:1493-1578
mpn_match_by_tag): its iteration order, tie-breaking, group-key insertion
and dtype promotion decide which joints group together, and the CPU tests
hold it to the JAX package's copy exactly. NMS runs through the port's
``ops.detection.nms_mask`` on CPU tensors and the quarter adjust through
``decode.assembly.adjust_quarter``; the rest is numpy. The maps are numpy
arrays: on the card only the maps are computed, the grouping is the
host's.
"""

from __future__ import annotations

import numpy as np
import torch

from pemp_tpu_torch.cluster.api import cluster_labels
from pemp_tpu_torch.decode.assembly import adjust_quarter
from pemp_tpu_torch.decode.munkres import min_cost_pairs
from pemp_tpu_torch.ops.detection import nms_mask


def _nms_peaks(det: np.ndarray, kernel: int) -> np.ndarray:
    """(J, H, W) bool local maxima of ``det`` under a ``kernel`` max-pool."""
    return nms_mask(torch.from_numpy(np.ascontiguousarray(det)), kernel).numpy()


class Params:
    """reference: group.py:120-133."""

    def __init__(self, cfg=None, num_joints=17, max_num_people=30):
        if cfg is not None:
            num_joints = cfg.DATASET.NUM_JOINTS
            max_num_people = cfg.DATASET.MAX_NUM_PEOPLE
        self.num_joints = num_joints
        self.max_num_people = max_num_people
        self.detection_threshold = 0.1
        self.tag_threshold = 1.0
        self.use_detection_val = True
        self.ignore_too_much = False
        if num_joints == 17:
            self.joint_order = [
                i - 1 for i in [1, 2, 3, 4, 5, 6, 7, 12, 13, 8, 9, 10, 11, 14, 15, 16, 17]
            ]
        else:
            self.joint_order = list(range(num_joints))


def match_by_tag(tag_k, loc_k, val_k, params: Params):
    """Sequential joint-order Munkres tag matching.

    tag_k: (J, K, D), loc_k: (J, K, 2), val_k: (J, K).
    reference: group.py:42-117. Returns (P, J, 3 + D).
    """
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
            pairs = min_cost_pairs(diff_normed)
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
    return np.array(list(joint_dict.values())).astype(np.float32).reshape(
        -1, params.num_joints, 3 + tag_k.shape[2]
    )


def mpn_match_by_tag(joint_det, tag_k, scores, params: Params):
    """match_by_tag on MPN node lists. reference: Utils.py:1493-1578.

    Joints stay in natural node order within each type: sorting or
    truncating changes the Munkres tie-breaking and the group-key insertion
    order. The dtypes mirror the reference: tags stay float32 (group keys
    and running means), the joint rows float64.
    """
    j = params.num_joints
    per_type = [np.where(joint_det[:, 2] == t)[0] for t in range(j)]
    k = max(max((len(s) for s in per_type), default=1), 1)
    tag_j = np.zeros((j, k, tag_k.shape[1]), np.float32)
    loc_j = np.zeros((j, k, 2), np.float64)
    val_j = np.zeros((j, k), np.float64)
    for t, sel in enumerate(per_type):
        n = len(sel)
        tag_j[t, :n] = tag_k[sel]
        loc_j[t, :n] = joint_det[sel, :2]
        val_j[t, :n] = scores[sel]
    ans = match_by_tag(tag_j, loc_j, val_j, params)
    return ans[:, :, :3]


class HeatmapParser:
    """The AE baseline parser: NMS -> per-joint top-K -> tag matching ->
    quarter adjust -> refine. reference: group.py:135-301."""

    def __init__(self, cfg=None, num_joints=17, max_num_people=30, nms_kernel=5):
        self.params = Params(cfg, num_joints, max_num_people)
        self.nms_kernel = (
            cfg.TEST.NMS_KERNEL if cfg is not None and "NMS_KERNEL" in cfg.TEST else nms_kernel
        )
        self.tag_per_joint = True

    def top_k(self, det: np.ndarray, tag: np.ndarray):
        """det: (J, H, W); tag: (J, H, W) or (J, H, W, D)."""
        j, h, w = det.shape
        masked = det * _nms_peaks(det, self.nms_kernel)
        if tag.ndim == 3:
            tag = tag[..., None]
        k = self.params.max_num_people
        flat = masked.reshape(j, -1)
        # torch.topk's order: descending, ties by lower index
        ind = np.argsort(-flat, axis=1, kind="stable")[:, :k]
        # float64 loc and val: the reference's int64 indices promote the
        # matching's joint rows to float64 (tags stay float32)
        val_k = np.take_along_axis(flat, ind, axis=1).astype(np.float64)
        tag_flat = tag.reshape(j, h * w, -1)
        tag_k = np.stack(
            [np.take_along_axis(tag_flat[..., d], ind, axis=1) for d in range(tag_flat.shape[-1])],
            axis=-1,
        ).astype(np.float32)
        x = (ind % w).astype(np.float64)
        y = (ind // w).astype(np.float64)
        loc_k = np.stack([x, y], axis=-1)
        return tag_k, loc_k, val_k

    def adjust(self, ans, det):
        """Quarter-pixel shift and the 0.5 offset. reference: group.py:191-210.
        det (J, H, W) numpy, or a tensor on any device."""
        maps = torch.as_tensor(det).permute(1, 2, 0)[None]
        out = adjust_quarter(maps, torch.from_numpy(np.ascontiguousarray(ans[None, :, :, :3]))
                             .to(maps.device))
        ans = ans.copy()
        ans[:, :, :3] = out[0].cpu().numpy()
        return ans

    def refine(self, det, tag, keypoints, fill_score=None):
        """Single-person AE refine. reference: group.py:212-275.

        det (J, H, W), tag (J, H, W[, D]): numpy arrays, or tensors on any
        device (the search then runs there); keypoints (J, 3) numpy.
        ``fill_score``: the score of a filled joint; None keeps group.py's
        (the heatmap value at the fill position), Utils.py's refine pins
        it at 0.001. Only a missing joint takes the search's answer
        (group.py:268-273), so only the missing joints' maps are searched,
        all at once; every operation is an exactly rounded float32 one, as
        numpy's, and ties go to the first pixel, as ``np.argmax``'s.
        """
        det, tag = torch.as_tensor(det), torch.as_tensor(tag)
        if tag.dim() == 3:
            tag = tag[..., None]
        present = np.flatnonzero(keypoints[: det.shape[0], 2] > 0)
        if not len(present):
            return keypoints
        at = keypoints[present].astype(np.int64)
        tags = tag[present, at[:, 1], at[:, 0]].cpu().numpy()        # (P, D)
        prev_tag = torch.as_tensor(np.mean(list(tags), axis=0), device=tag.device)
        keypoints = keypoints.copy()
        missing = np.flatnonzero(keypoints[: det.shape[0], 2] == 0)
        if not len(missing):
            return keypoints
        sel = torch.as_tensor(missing, device=det.device)
        tmp = det[sel]                                                  # (M, H, W)
        tt = torch.sqrt(((tag[sel] - prev_tag) ** 2).sum(dim=-1))
        h, w = tmp.shape[1:]
        idx = torch.argmax((tmp - torch.round(tt)).reshape(len(missing), -1), dim=1)
        y, x = idx // w, idx % w
        m = torch.arange(len(missing), device=det.device)

        def at_(yy, xx):
            return tmp[m, yy, xx]

        val = at_(y, x)
        right = at_(y, torch.clamp(x + 1, max=w - 1)) > at_(y, torch.clamp(x - 1, min=0))
        down = at_(torch.clamp(y + 1, max=h - 1), x) > at_(torch.clamp(y - 1, min=0), x)
        found = torch.stack([x.double() + 0.5 + torch.where(right, 0.25, -0.25).double(),
                             y.double() + 0.5 + torch.where(down, 0.25, -0.25).double(),
                             val.double()], dim=1).cpu().numpy()
        for row, i in zip(found, missing):
            if row[2] > 0:
                keypoints[i, :2] = row[:2]
                keypoints[i, 2] = np.float32(row[2]) if fill_score is None else fill_score
        return keypoints

    def parse(self, det, tag, adjust=True, refine=True, scoring="default"):
        """det: (J, H, W); tag: (J, H, W[, D]). Returns (persons, scores)."""
        ans = match_by_tag(*self.top_k(det, tag), self.params)
        if adjust and len(ans):
            ans = self.adjust(ans, det)
        if scoring == "default":
            scores = [p[:, 2].mean() for p in ans]
        else:
            scores = [
                p[p[:, 2] > 0.009, 2].mean() if (p[:, 2] > 0.009).any() else 0.0
                for p in ans
            ]
        if refine and len(ans):
            tag4 = tag if tag.ndim == 4 else tag[..., None]
            ans = np.stack([self.refine(det, tag4, p[:, :3]) for p in ans])
        else:
            ans = ans[:, :, :3] if len(ans) else ans
        return ans, scores


def cluster_cc(heatmaps, tagmaps, num_joints, nms_kernel=5, cc_method="GAEC",
               detect_threshold=0.1, max_per_type=30):
    """AE tags grouped by correlation clustering (the port's g++ library).

    reference: group.py:304-392. heatmaps (J, H, W); tagmaps (J, H, W[, D]).
    Returns persons (P, J, 3). The pair weights are computed pair by pair
    with ``np.linalg.norm``, as the JAX package computes them, so the
    clustering sees the same bits.
    """
    if tagmaps.ndim == 3:
        tagmaps = tagmaps[..., None]
    peaks = _nms_peaks(heatmaps, nms_kernel) * heatmaps
    dets, det_scores, det_tags = [], [], []
    for t in range(heatmaps.shape[0]):
        ys, xs = np.nonzero(peaks[t] >= detect_threshold)
        order = np.argsort(-peaks[t][ys, xs])[:max_per_type]
        for o in order:
            dets.append((xs[o], ys[o], t))
            det_scores.append(peaks[t][ys[o], xs[o]])
            det_tags.append(tagmaps[t, ys[o], xs[o]])
    if len(dets) < 2:
        return np.zeros((0, num_joints, 3), np.float32)
    dets = np.array(dets)
    det_scores = np.array(det_scores)
    det_tags = np.array(det_tags)

    n = len(dets)
    src, dst, wts = [], [], []
    for a in range(n):
        for b in range(a + 1, n):
            d = np.linalg.norm(det_tags[a] - det_tags[b])
            # tag distance -> affinity in [0, 1] -> shifted weight
            wts.append(0.5 - min(d / 2.0, 1.0))
            src.append(a)
            dst.append(b)
    labels = cluster_labels(np.stack([np.array(src), np.array(dst)]), np.array(wts), n,
                            cc_method)
    persons = []
    for lab in np.unique(labels):
        sel = np.where(labels == lab)[0]
        if len(sel) < 2:
            continue
        kp = np.zeros((num_joints, 3), np.float32)
        for t in range(num_joints):
            cand = sel[dets[sel, 2] == t]
            if len(cand):
                best = cand[np.argmax(det_scores[cand])]
                kp[t] = (dets[best, 0], dets[best, 1], det_scores[best])
        if (kp[:, 2] > 0).sum() > 0:
            persons.append(kp)
    return np.array(persons, np.float32).reshape(-1, num_joints, 3)
