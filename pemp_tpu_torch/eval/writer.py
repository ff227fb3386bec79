"""The eval report (counterpart of pemp_tpu.eval.writer's EvalWriter:
``eval_coco``, ``eval_speed`` and ``close``).

reference: src/Utils/eval.py:7-139. The per-epoch classification metrics
(``calc_metrics``, ``topk_accuracy``, ``roc_auc``) belong to training's
validation, which is not ported.
"""

from __future__ import annotations

import os

import numpy as np

from pemp_tpu_torch.eval.coco_eval import coco_eval, crowd_pose_eval


class EvalWriter:
    """Writes the AP summary and the per-stage times to
    ``<LOG_DIR>/<fname>`` (reference: src/Utils/eval.py:7-139)."""

    def __init__(self, config, fname=None):
        th = int(config.MODEL.MPN.NODE_THRESHOLD * 100)
        self.dir = config.LOG_DIR or "tmp"
        os.makedirs(self.dir, exist_ok=True)
        self.dataset = config.DATASET.DATASET
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

    def close(self):
        self.f.close()
