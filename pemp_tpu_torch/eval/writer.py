"""The eval report and the training metrics (counterpart of
pemp_tpu.eval.writer): ``EvalWriter`` with the AP summary, the per-stage
times and the classification metrics' lines, and the metrics themselves,
``calc_metrics``, ``topk_accuracy`` and ``roc_auc``, in numpy (no sklearn).

reference: src/Utils/eval.py:7-139 (EvalWriter), src/Utils/Utils.py:963-979
(calc_metrics), :22-34 (topk_accuracy).
"""

from __future__ import annotations

import os

import numpy as np

from pemp_tpu_torch.eval.coco_eval import coco_eval, crowd_pose_eval

COCO_PART_LABELS = [
    "nose", "eye_l", "eye_r", "ear_l", "ear_r",
    "sho_l", "sho_r", "elb_l", "elb_r", "wri_l", "wri_r",
    "hip_l", "hip_r", "kne_l", "kne_r", "ank_l", "ank_r",
]
CROWDPOSE_PART_LABELS = [
    "sho_l", "sho_r", "elb_l", "elb_r", "wri_l", "wri_r",
    "hip_l", "hip_r", "kne_l", "kne_r", "ank_l", "ank_r", "head_1", "head_2",
]


def _prec_rec(output, targets, c):
    tp = float(np.sum((output == c) & (targets == c)))
    fp = float(np.sum((output == c) & (targets != c)))
    fn = float(np.sum((output != c) & (targets == c)))
    return tp / (tp + fp) if tp + fp > 0 else 0.0, tp / (tp + fn) if tp + fn > 0 else 0.0


def calc_metrics(output, targets, mask=None, num_classes: int = 2):
    """Accuracy, precision, recall and F1 of predicted classes against
    ``targets`` where ``mask`` is 1: of the positive class (1) when
    ``num_classes`` is 2, else the means over the classes. None without
    an output or where the mask keeps nothing. reference: Utils.py:963-979."""
    if output is None:
        return None
    output, targets = np.asarray(output), np.asarray(targets)
    if mask is not None:
        keep = np.asarray(mask) == 1.0
        output, targets = output[keep], targets[keep]
        if len(output) == 0:
            return None
    if num_classes == 2:
        prec, rec = _prec_rec(output, targets, 1)
    else:
        precs, recs = zip(*(_prec_rec(output, targets, c) for c in range(num_classes)))
        prec, rec = float(np.mean(precs)), float(np.mean(recs))
    f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
    return {"acc": float(np.mean(output == targets)), "prec": prec, "rec": rec, "f1": f1}


def topk_accuracy(output, target, topk: int = 1, mask=None):
    """The share of rows whose target is among the ``topk`` largest scores
    of ``output`` (N, C), over the rows ``mask`` keeps; 0.0 for none.
    reference: Utils.py:22-34."""
    output, target = np.asarray(output), np.asarray(target)
    if mask is not None:
        keep = np.asarray(mask) == 1.0
        output, target = output[keep], target[keep]
    if len(output) == 0:
        return 0.0
    top = np.argsort(-output, axis=1)[:, :topk]
    return float(np.mean((top == target[:, None]).any(axis=1)))


def roc_auc(labels, scores) -> float:
    """The area under the ROC curve from ranks (Mann-Whitney U), tied
    scores taking their mean rank; NaN without both classes."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos, n_neg = labels.sum(), (~labels).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = scores.argsort(kind="mergesort")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    # a run of equal scores [i, j] in sorted order takes the mean rank
    sorted_scores = scores[order]
    starts = np.flatnonzero(np.r_[True, sorted_scores[1:] != sorted_scores[:-1]])
    ends = np.r_[starts[1:], len(scores)] - 1
    for i, j in zip(starts, ends):
        if j > i:
            ranks[order[i: j + 1]] = (i + j) / 2 + 1
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


class EvalWriter:
    """Writes the AP summary, the per-stage times and the classification
    metrics to ``<LOG_DIR>/<fname>`` (reference: src/Utils/eval.py:7-139)."""

    def __init__(self, config, fname=None):
        th = int(config.MODEL.MPN.NODE_THRESHOLD * 100)
        self.dir = config.LOG_DIR or "tmp"
        os.makedirs(self.dir, exist_ok=True)
        self.dataset = config.DATASET.DATASET
        self.num_joints = config.DATASET.NUM_JOINTS
        if self.dataset not in ("coco", "crowd_pose"):
            raise ValueError(f"DATASET.DATASET={self.dataset!r}: coco or crowd_pose")
        path = os.path.join(self.dir, fname if fname else f"eval_{th:g}.txt")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = open(path, "w")

    def eval_coco(self, coco, anns, ids, description, dt_file_name="dt.json"):
        print(description)
        if self.dataset == "coco":
            stats = coco_eval(coco, anns, ids, tmp_dir=self.dir, dt_file_name=dt_file_name)
            lines = [("AP       ", 0), ("AP    0.5", 1), ("AP   0.75", 2), ("AP medium", 3),
                     ("AP  large", 4)]
        else:
            stats = crowd_pose_eval(coco, anns, ids, tmp_dir=self.dir,
                                    dt_file_name=dt_file_name)
            lines = [("AP         ", 0), ("AP      0.5", 1), ("AP     0.75", 2),
                     ("AR         ", 3), ("AP     easy", 6), ("AP   medium", 7),
                     ("AP     hard", 8)]
        self.f.write(description + "\n")
        for name, i in lines:
            self.f.write(f"{name}: {stats[i]: 3f} \n")
        return stats

    def eval_speed(self, *args):
        """``name, seconds, name, seconds, ...``: the mean of each."""
        print("Runtime measurement")
        self.f.write("Runtime measurement\n")
        for i in range(0, len(args), 2):
            line = f"{args[i]}: {np.mean(args[i + 1])}"
            print(line)
            self.f.write(line + " \n")

    def eval_metrics(self, eval_dict, description):
        """The mean of each list of ``eval_dict``, as one dict line."""
        out = {k: float(np.mean(v)) for k, v in eval_dict.items()}
        print(description)
        print(out)
        self.f.write(description + "\n")
        self.f.write(str(out) + "\n")

    def eval_metric(self, eval_list, description):
        value = float(np.mean(eval_list))
        print(description, value)
        self.f.write(description + "\n" + str(value) + "\n")

    def eval_part_metrics(self, eval_dict, description):
        """``eval_dict[j]``: lists of acc, prec, rec and f1 of joint type
        ``j``; one line of their means per type."""
        part_labels = COCO_PART_LABELS if self.dataset == "coco" else CROWDPOSE_PART_LABELS
        print(description)
        self.f.write(description + " \n")
        for i in range(self.num_joints):
            m = {k: float(np.mean(v)) for k, v in eval_dict[i].items()}
            line = (f"{part_labels[i]} acc: {m['acc']:3f} prec: {m['prec']:3f} "
                    f"rec: {m['rec']:3f} f1: {m['f1']:3f}")
            print(line)
            self.f.write(line + "\n")

    def eval_roc_auc(self, eval_dict, description):
        """The nodes' ROC AUC (``eval_dict["node"]``: ``pred`` scores,
        ``label`` and joint ``class``), overall and per joint type present
        (named with the COCO labels, as the reference does)."""
        print(description)
        self.f.write(description + " \n")
        node = eval_dict.get("node")
        if not node:
            return
        pred = np.asarray(node["pred"])
        label = np.asarray(node["label"]).astype(int)
        lines = [f"node roc_auc: {roc_auc(label, pred)}"]
        classes = np.asarray(node["class"])
        for i in range(self.num_joints):
            m = classes == i
            if m.sum():
                lines.append(f"{COCO_PART_LABELS[i]}  roc_auc: {roc_auc(label[m], pred[m])}")
        for line in lines:
            print(line)
            self.f.write(line + "\n")

    def close(self):
        self.f.close()
