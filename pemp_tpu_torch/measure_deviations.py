"""The AP cost of the graph's two static-shape truncations.

    python -m pemp_tpu_torch.make_fake_coco --root tmp/fake_coco --images 48 --size 256
    python -m pemp_tpu_torch.measure_deviations --root tmp/fake_coco [--max-images N] \
        [--input-size 512] [--device cpu]

The counterpart of ``tools/measure_deviations.py``. Ideal Gaussian score
maps rendered from the GT keypoints (sigma 2, the training targets'
kernel) go through the real detection, kNN graph and label construction
(no GT nodes, so the detection top-K and the kNN capacity bind), the
labels decoded as predictions (node threshold 0.5, adjust, no refine or
fill) and scored by COCO AP on the ``val`` set, under four settings:
``TPU.KNN_CAP_IN`` 32 or -1 (the exact transpose capacity) by
``TPU.NODES_PER_TYPE`` 40 or 80. Each setting writes
``tmp/deviation_<cap_in>_<k>.txt`` and prints one JSON row
``{"cap_in", "k", "AP", "AP50", "mean_edges", "mean_nodes"}``.

The configuration is the default one with crowd masks off and label
method 6. The graph and the decode run on CUDA unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pemp_tpu_torch.calc_upper_bounds import image_targets
from pemp_tpu_torch.config import get_config
from pemp_tpu_torch.data.datasets import CocoKeypoints
from pemp_tpu_torch.decode.assembly import decode_poses
from pemp_tpu_torch.decode.format import persons_to_ann
from pemp_tpu_torch.eval.writer import EvalWriter
from pemp_tpu_torch.graph.constructor import GCConfig, construct_graph_batch
from pemp_tpu_torch.models.pose_estimation import resolve_device

# (TPU.KNN_CAP_IN, TPU.NODES_PER_TYPE) as tools/measure_deviations.py:131-136
# sets them
SETTINGS = ({"cap_in": 32, "k": 40}, {"cap_in": -1, "k": 40},
            {"cap_in": 32, "k": 80}, {"cap_in": -1, "k": 80})


def render_heat(kpts, h, w, num_joints, sigma=2.0):
    """Gaussian score maps (h, w, J) from canvas-space GT keypoints: the
    training target generator's kernel (6 sigma + 3 window, exp(-d2 / (2
    sigma^2))), the larger value where two overlap."""
    heat = np.zeros((h, w, num_joints), np.float32)
    size = int(6 * sigma + 3)
    x = np.arange(size, dtype=np.float32)
    x0 = y0 = 3 * sigma + 1
    g = np.exp(-((x - x0) ** 2 + (x[:, None] - y0) ** 2) / (2 * sigma ** 2))
    for person in kpts:
        for j in range(num_joints):
            px, py, v = person[j]
            if v <= 0:
                continue
            xi, yi = int(px), int(py)
            if not (0 <= xi < w and 0 <= yi < h):
                continue
            ul = (int(xi - x0), int(yi - y0))
            br = (int(ul[0] + size), int(ul[1] + size))
            c, d = max(0, -ul[0]), min(br[0], w) - ul[0]
            a, b = max(0, -ul[1]), min(br[1], h) - ul[1]
            cc, dd = max(0, ul[0]), min(br[0], w)
            aa, bb = max(0, ul[1]), min(br[1], h)
            heat[aa:bb, cc:dd, j] = np.maximum(heat[aa:bb, cc:dd, j], g[a:b, c:d])
    return heat


def deviation_config(root, input_size=512):
    """tools/measure_deviations.py:90-97's configuration."""
    config = get_config()
    config.DATASET.ROOT = root
    config.DATASET.INPUT_SIZE = input_size
    config.MODEL.GC.MASK_CROWDS = False
    config.MODEL.GC.EDGE_LABEL_METHOD = 6
    config.LOG_DIR = "tmp"
    return config


def labels_as_predictions(gc: GCConfig, heat, kpts, factors, num_joints, device):
    """The graph on the rendered maps with labels, decoded with the labels
    as the predictions (tools/measure_deviations.py:104-127): persons,
    person_valid, valid edges and valid nodes."""
    heat = torch.from_numpy(heat)[None].to(device)
    gb = construct_graph_batch(gc, heat, torch.zeros_like(heat[..., :1]),
                               torch.zeros_like(heat),
                               joints_gt=torch.from_numpy(kpts)[None].to(device),
                               factors=torch.from_numpy(factors)[None].to(device))
    one = lambda t: t.reshape(1, *t.shape)  # noqa: E731
    persons, valid = decode_poses(
        heat, torch.zeros_like(heat), one(gb.joint_det),
        one(torch.where(gb.node_valid, gb.node_labels, 0.0)),
        gb.edge_index.reshape(1, 2, -1), one(gb.edge_valid),
        one(torch.where(gb.edge_valid, gb.edge_labels, 0.0)), one(gb.node_valid),
        node_threshold=0.5, num_joints=num_joints, blocked_c=gc.blocked_c,
        with_fill_mean=False, with_refine=False, with_adjust=True)
    return persons[0], valid[0], int(gb.edge_valid.sum()), int(gb.node_valid.sum())


def measure(config, eval_set, max_images=None, device="cuda") -> list[dict]:
    """One row a setting of :data:`SETTINGS` on ``eval_set`` (anything with
    ``img_ids`` and ``coco``)."""
    device = resolve_device(device)
    nj, mp = config.DATASET.NUM_JOINTS, config.DATASET.MAX_NUM_PEOPLE
    input_size = config.DATASET.INPUT_SIZE
    n = len(eval_set.img_ids) if max_images is None else min(max_images,
                                                             len(eval_set.img_ids))
    results = []
    for st in SETTINGS:
        cfg = config.clone()
        cfg.TPU.KNN_CAP_IN = st["cap_in"]
        cfg.TPU.NODES_PER_TYPE = st["k"]
        gc = GCConfig.from_config(cfg)
        anns, ids, edge_counts, node_counts = [], [], [], []
        for i in range(n):
            img_id = int(eval_set.img_ids[i])
            ids.append(img_id)
            info = eval_set.coco.loadImgs(img_id)[0]
            h, w = info["height"], info["width"]
            gts = eval_set.coco.loadAnns(eval_set.coco.getAnnIds(imgIds=img_id))
            kpts, factors, people, (bh, bw) = image_targets(gts, h, w, input_size, nj, mp)
            if people == 0:
                continue
            heat = render_heat(kpts[:people], bh, bw, nj)
            persons, valid, n_edges, n_nodes = labels_as_predictions(gc, heat, kpts, factors,
                                                                     nj, device)
            edge_counts.append(n_edges)
            node_counts.append(n_nodes)
            ann = persons_to_ann(persons.cpu(), valid.cpu(), (w, h), input_size, img_id,
                                 "short", scoring_method="correct")
            if ann is not None:
                anns.append(ann)
        writer = EvalWriter(cfg, fname=f"deviation_{st['cap_in']}_{st['k']}.txt")
        stats = writer.eval_coco(eval_set.coco, anns, np.array(ids),
                                 f"deviation cap_in={st['cap_in']} K={st['k']}")
        writer.close()
        row = {**st, "AP": round(float(stats[0]), 4), "AP50": round(float(stats[1]), 4),
               "mean_edges": round(float(np.mean(edge_counts)), 1),
               "mean_nodes": round(float(np.mean(node_counts)), 1)}
        results.append(row)
        print(json.dumps(row), flush=True)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description="AP cost of the static-shape truncations")
    p.add_argument("--root", default="tmp/fake_coco")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--input-size", type=int, default=512)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    resolve_device(args.device)
    config = deviation_config(args.root, args.input_size)
    eval_set = CocoKeypoints(args.root, mini=False, seed=0, mode="val", filter_empty=False,
                             num_joints=config.DATASET.NUM_JOINTS)
    return measure(config, eval_set, args.max_images, args.device)


if __name__ == "__main__":
    main()
