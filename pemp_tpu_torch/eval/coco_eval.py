"""Keypoint OKS evaluation, pure numpy (copy of pemp_tpu.eval.coco_eval).

Re-implementation of the pycocotools/crowdposetools COCOeval keypoint
protocol (C extensions unavailable here): OKS IoU, per-image greedy matching
across thresholds 0.50:0.05:0.95, precision/recall accumulation over score-
sorted detections, and the standard 10-stat summary
(reference usage: src/Utils/eval.py:142-187).

CrowdPose variant: 14-joint sigmas and AP-easy/medium/hard split by the
image crowdIndex instead of area ranges.
"""

from __future__ import annotations

import numpy as np

from pemp_tpu_torch.data.datasets import CROWDPOSE_SIGMAS
from pemp_tpu_torch.data.datasets import KPT_OKS_SIGMAS as COCO_SIGMAS


def compute_oks(dts, gts, sigmas):
    """OKS matrix (len(dts), len(gts)). Mirrors COCOeval.computeOks."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    variances = (sigmas * 2) ** 2
    k = len(sigmas)
    ious = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.array(gt["keypoints"], dtype=np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = np.count_nonzero(vg > 0)
        bb = gt.get("bbox", [0, 0, 0, 0])
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        for i, dt in enumerate(dts):
            d = np.array(dt["keypoints"], dtype=np.float64)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx = xd - xg
                dy = yd - yg
            else:
                z = np.zeros(k)
                dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
            e = (dx**2 + dy**2) / variances / (gt.get("area", 1.0) + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] else 0.0
    return ious


class KeypointEval:
    """COCOeval('keypoints') equivalent."""

    def __init__(self, coco_gt, coco_dt, sigmas=None, crowdpose: bool = False):
        self.gt = coco_gt
        self.dt = coco_dt
        self.crowdpose = crowdpose
        self.sigmas = np.asarray(
            sigmas if sigmas is not None else (CROWDPOSE_SIGMAS if crowdpose else COCO_SIGMAS)
        )
        self.iou_thrs = np.linspace(0.5, 0.95, 10)
        self.rec_thrs = np.linspace(0.0, 1.00, 101)
        self.max_dets = 20
        if crowdpose:
            self.area_rngs = [(0, 1e10)]
            self.area_lbls = ["all"]
            self.crowd_rngs = [(-0.01, 1.01), (-0.01, 0.1), (0.1, 0.8), (0.8, 1.01)]
            self.crowd_lbls = ["all", "easy", "medium", "hard"]
        else:
            self.area_rngs = [(0, 1e10), (32**2, 96**2), (96**2, 1e10)]
            self.area_lbls = ["all", "medium", "large"]
        self.params_img_ids = None
        self.stats = None

    # -- evaluation -------------------------------------------------------
    def _gts_dts(self, img_id):
        gts = [
            g
            for g in self.gt.img_to_anns.get(img_id, [])
            if g.get("category_id", 1) == 1
        ]
        dts = [
            d
            for d in self.dt.img_to_anns.get(img_id, [])
            if d.get("category_id", 1) == 1
        ]
        dts = sorted(dts, key=lambda d: -d.get("score", 0.0))[: self.max_dets]
        return gts, dts

    def _evaluate_img(self, gts, dts, area_rng, ious):
        t = len(self.iou_thrs)
        # pycocotools boundary semantics: ignored iff area < rng[0] OR
        # area > rng[1] — both ends INCLUSIVE, so a gt whose area sits
        # exactly on a range edge counts in BOTH adjacent ranges
        # (cocoeval.evaluateImg's `g['area']<aRng[0] or g['area']>aRng[1]`)
        gt_ignore = np.array(
            [
                (g.get("ignore", 0) == 1)
                or (g.get("iscrowd", 0) == 1)
                or (np.count_nonzero(np.array(g["keypoints"])[2::3] > 0) == 0)
                or g.get("area", 0) < area_rng[0]
                or g.get("area", 0) > area_rng[1]
                for g in gts
            ],
            dtype=bool,
        ) if gts else np.zeros(0, bool)
        # sort gts: non-ignored first (COCOeval semantics)
        gt_order = np.argsort(gt_ignore, kind="stable")
        gt_ignore = gt_ignore[gt_order]
        iscrowd = np.array(
            [gts[i].get("iscrowd", 0) == 1 for i in gt_order], dtype=bool
        ) if gts else np.zeros(0, bool)
        ious = ious[:, gt_order] if ious.size else ious

        num_g, num_d = len(gts), len(dts)
        gtm = -np.ones((t, num_g), dtype=np.int64)
        dtm = -np.ones((t, num_d), dtype=np.int64)
        dt_ignore = np.zeros((t, num_d), dtype=bool)
        for ti, thr in enumerate(self.iou_thrs):
            for di in range(num_d):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for gi in range(num_g):
                    # a matched gt is out of play UNLESS it is a crowd —
                    # crowd gts absorb any number of detections
                    # (cocoeval: `if gtm[tind,gind]>0 and not iscrowd[gind]`)
                    if gtm[ti, gi] >= 0 and not iscrowd[gi]:
                        continue
                    # stop at ignored gts once a real match exists
                    if best_g > -1 and not gt_ignore[best_g] and gt_ignore[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                dtm[ti, di] = best_g
                gtm[ti, best_g] = di
                dt_ignore[ti, di] = gt_ignore[best_g]
        # unmatched detections whose own (keypoint-extent) area falls outside
        # the range are ignored, not false positives (cocoeval's final dtIg
        # update); for the "all" range this is a no-op
        if num_d:
            dt_out = np.array(
                [
                    d.get("area", 0) < area_rng[0]
                    or d.get("area", 0) > area_rng[1]
                    for d in dts
                ],
                dtype=bool,
            )
            dt_ignore |= (dtm < 0) & dt_out[None, :]
        scores = np.array([d.get("score", 0.0) for d in dts])
        return dict(
            dtm=dtm,
            dt_ignore=dt_ignore,
            gt_ignore=gt_ignore,
            scores=scores,
            num_gt=int((~gt_ignore).sum()),
        )

    def evaluate(self, img_ids=None):
        if img_ids is None:
            img_ids = sorted(self.gt.imgs.keys())
        self.params_img_ids = list(img_ids)
        self._per_img = {}
        self._ious = {}
        for img_id in img_ids:
            gts, dts = self._gts_dts(img_id)
            ious = compute_oks(dts, gts, self.sigmas)
            self._ious[img_id] = (gts, dts, ious)

    def _select_rngs(self):
        if self.crowdpose:
            for lbl, rng in zip(self.crowd_lbls, self.crowd_rngs):
                yield lbl, ("crowd", rng)
        else:
            for lbl, rng in zip(self.area_lbls, self.area_rngs):
                yield lbl, ("area", rng)

    def accumulate(self):
        t = len(self.iou_thrs)
        self.results = {}
        for lbl, (kind, rng) in self._select_rngs():
            evals = []
            for img_id in self.params_img_ids:
                gts, dts, ious = self._ious[img_id]
                if kind == "crowd":
                    ci = self.gt.imgs.get(img_id, {}).get("crowdIndex", 0.0)
                    if not (rng[0] <= ci <= rng[1]):
                        continue
                    area_rng = (0, 1e10)
                else:
                    area_rng = rng
                evals.append(self._evaluate_img(gts, dts, area_rng, ious))
            if not evals:
                self.results[lbl] = (np.full(t, -1.0), np.full(t, -1.0))
                continue
            scores = np.concatenate([e["scores"] for e in evals])
            order = np.argsort(-scores, kind="mergesort")
            dtm = np.concatenate([e["dtm"] for e in evals], axis=1)[:, order]
            dt_ig = np.concatenate([e["dt_ignore"] for e in evals], axis=1)[:, order]
            num_gt = sum(e["num_gt"] for e in evals)
            if num_gt == 0:
                self.results[lbl] = (np.full(t, -1.0), np.full(t, -1.0))
                continue
            tps = (dtm >= 0) & ~dt_ig
            fps = (dtm < 0) & ~dt_ig
            tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
            ap = np.zeros(t)
            ar = np.zeros(t)
            for ti in range(t):
                tp, fp = tp_cum[ti], fp_cum[ti]
                rc = tp / num_gt
                pr = tp / np.maximum(tp + fp, np.spacing(1))
                ar[ti] = rc[-1] if len(rc) else 0.0
                # interpolated precision over recall thresholds
                pr = pr.tolist()
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                inds = np.searchsorted(rc, self.rec_thrs, side="left")
                q = np.zeros(len(self.rec_thrs))
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                ap[ti] = np.mean(q)
            self.results[lbl] = (ap, ar)

    def summarize(self, verbose: bool = True):
        def s(lbl, kind, thr=None):
            ap, ar = self.results[lbl]
            arr = ap if kind == "ap" else ar
            if thr is None:
                vals = arr[arr > -1]
            else:
                ti = int(np.argmin(np.abs(self.iou_thrs - thr)))
                vals = arr[ti : ti + 1]
                vals = vals[vals > -1]
            return float(np.mean(vals)) if vals.size else -1.0

        if self.crowdpose:
            stats = [
                s("all", "ap"), s("all", "ap", 0.5), s("all", "ap", 0.75),
                s("all", "ar"), s("all", "ar", 0.5), s("all", "ar", 0.75),
                s("easy", "ap"), s("medium", "ap"), s("hard", "ap"),
            ]
            names = ["AP", "AP50", "AP75", "AR", "AR50", "AR75", "AP(E)", "AP(M)", "AP(H)"]
        else:
            stats = [
                s("all", "ap"), s("all", "ap", 0.5), s("all", "ap", 0.75),
                s("medium", "ap"), s("large", "ap"),
                s("all", "ar"), s("all", "ar", 0.5), s("all", "ar", 0.75),
                s("medium", "ar"), s("large", "ar"),
            ]
            names = [
                "AP", "AP50", "AP75", "AP(M)", "AP(L)",
                "AR", "AR50", "AR75", "AR(M)", "AR(L)",
            ]
        self.stats = np.array(stats)
        if verbose:
            for n, v in zip(names, stats):
                print(f"  {n:7s} = {v:.3f}")
        return self.stats


def coco_eval(coco, dt, image_ids, tmp_dir="tmp", dt_file_name="dt.json", crowdpose=False):
    """Writes the results ``dt`` (a list per image) to ``tmp_dir`` and
    returns their stats. reference: src/Utils/eval.py:142-161."""
    import json
    import os

    os.makedirs(tmp_dir, exist_ok=True)
    anns = sum(dt, [])
    with open(os.path.join(tmp_dir, dt_file_name), "w") as f:
        json.dump(anns, f)
    ev = KeypointEval(coco, coco.loadRes(anns), crowdpose=crowdpose)
    ev.evaluate(list(image_ids))
    ev.accumulate()
    return ev.summarize()


def crowd_pose_eval(coco, dt, image_ids, tmp_dir="tmp", dt_file_name="dt.json"):
    """reference: src/Utils/eval.py:167-187."""
    return coco_eval(coco, dt, image_ids, tmp_dir, dt_file_name, crowdpose=True)
