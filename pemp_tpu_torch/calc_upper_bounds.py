"""The AP ceiling of the label construction: the GT labels as predictions.

    python -m pemp_tpu_torch.calc_upper_bounds --config upper_bound/hrnet \
        --out_file ub.txt [--max-images N] [--device cpu] [KEY VALUE ...]

The counterpart of ``tools/calc_upper_bounds.py`` (reference:
src/test/calc_upper_bounds.py). For each image of COCO's val2017 (or the
set under ``DATASET.ROOT``) with a person: the GT keypoints and their OKS
factors mapped to the half-size output of the deterministic eval geometry
(64-multiple short-side resize), the graph built on the GT joints
(``USE_GT``, label method 2, no crowd masks) on a canvas bucketed to
multiples of 64, and ``decode_poses`` on the labels (threshold grouping at
node threshold 0.5, no fill, refine or adjust), both on the device; then on
the host the reverse map and the "correct" scoring of ``persons_to_ann``,
and ``EvalWriter.eval_coco`` over all images. No network runs: it measures
how much AP the matching, label and decode stack can deliver.

``--config`` resolves as the other entry points' (``configs/<name>.yaml``
or a preset). Runs on CUDA unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pemp_tpu_torch.config import check_path, load_config, update_config_command
from pemp_tpu_torch.data.datasets import KPT_OKS_SIGMAS, CocoKeypoints
from pemp_tpu_torch.decode.assembly import decode_poses
from pemp_tpu_torch.decode.format import persons_to_ann
from pemp_tpu_torch.eval.writer import EvalWriter
from pemp_tpu_torch.geometry.affine import (
    factor_affine,
    get_affine_transform,
    get_multi_scale_size,
    kpt_affine,
)
from pemp_tpu_torch.graph.constructor import GCConfig, construct_graph_batch
from pemp_tpu_torch.models.pose_estimation import resolve_device


def upper_bound_config(config):
    """``config`` as the upper bound runs it (tools/calc_upper_bounds.py:
    52-58): the GT joints as the nodes, label method 2, no crowd masks, and
    LOG_DIR ``tmp`` when empty."""
    config.merge_from_other({"MODEL": {"GC": {"USE_GT": True, "EDGE_LABEL_METHOD": 2,
                                              "MASK_CROWDS": False}}})
    if not config.LOG_DIR:
        config.LOG_DIR = "tmp"
    check_path(config, "upper_bound")
    return config


def image_targets(anns, h, w, input_size, num_joints, max_people):
    """The GT of one image in the half-size output of its eval geometry
    (tools/calc_upper_bounds.py:97-114): keypoints (P, J, 3), factors
    (P, J) and the number of persons with keypoints; the canvas (bh, bw)
    bucketed up to multiples of 64."""
    resized, center, scale = get_multi_scale_size(h, w, input_size, 1.0, 1.0)
    out_size = (int(resized[0] / 2), int(resized[1] / 2))
    mat = get_affine_transform(center, scale, out_size)
    sig = KPT_OKS_SIGMAS[:num_joints]
    kpts = np.zeros((max_people, num_joints, 3), np.float32)
    factors = np.ones((max_people, num_joints), np.float32)
    pi = 0
    for a in anns:
        if a.get("num_keypoints", 0) == 0 or pi >= max_people:
            continue
        kp = np.array(a["keypoints"], np.float64).reshape(-1, 3)[:num_joints]
        kp[:, :2] = kpt_affine(kp[:, :2], mat)
        kpts[pi] = kp
        fac = (sig * 2) ** 2 * (a.get("area", 1.0) + np.spacing(1)) * 2.0
        factors[pi] = factor_affine(fac, mat)
        pi += 1
    canvas = (-(-out_size[1] // 64) * 64, -(-out_size[0] // 64) * 64)
    return kpts, factors, pi, canvas


def upper_bound_persons(gc: GCConfig, kpts, factors, canvas, num_joints, device):
    """The graph on the GT joints of one image and the decode of its
    labels, on ``device``: persons (P, J, 3) and person_valid (P,)."""
    bh, bw = canvas
    zeros = torch.zeros((1, bh, bw, num_joints), device=device)
    gb = construct_graph_batch(gc, zeros, torch.zeros((1, bh, bw, 1), device=device), zeros,
                               joints_gt=torch.from_numpy(kpts)[None].to(device),
                               factors=torch.from_numpy(factors)[None].to(device))
    one = lambda t: t.reshape(1, *t.shape)  # noqa: E731
    persons, valid = decode_poses(
        zeros, zeros, one(gb.joint_det), one(torch.where(gb.node_valid, gb.node_labels, 0.0)),
        gb.edge_index.reshape(1, 2, -1), one(gb.edge_valid), one(gb.edge_labels),
        one(gb.node_valid), node_threshold=0.5, num_joints=num_joints,
        blocked_c=gc.blocked_c, with_fill_mean=False, with_refine=False, with_adjust=False)
    return persons[0], valid[0]


def evaluate(config, eval_set, out_file, max_images=None, device="cuda"):
    """The upper bound of ``config`` (already through
    :func:`upper_bound_config`) on ``eval_set`` (anything with ``img_ids``
    and ``coco``): writes the report to ``<LOG_DIR>/<out_file>`` and
    returns (stats, the annotations)."""
    device = resolve_device(device)
    writer = EvalWriter(config, fname=out_file)
    nj, mp = config.DATASET.NUM_JOINTS, config.DATASET.MAX_NUM_PEOPLE
    input_size = config.DATASET.INPUT_SIZE
    gc = GCConfig.from_config(config)
    n = len(eval_set.img_ids) if max_images is None else min(max_images,
                                                             len(eval_set.img_ids))
    anns, ids = [], []
    for i in range(n):
        img_id = int(eval_set.img_ids[i])
        ids.append(img_id)
        info = eval_set.coco.loadImgs(img_id)[0]
        h, w = info["height"], info["width"]
        gts = eval_set.coco.loadAnns(eval_set.coco.getAnnIds(imgIds=img_id))
        kpts, factors, people, canvas = image_targets(gts, h, w, input_size, nj, mp)
        if people == 0:
            continue
        persons, valid = upper_bound_persons(gc, kpts, factors, canvas, nj, device)
        ann = persons_to_ann(persons.cpu(), valid.cpu(), (w, h), input_size, img_id, "short",
                             scoring_method="correct")
        if ann is not None:
            anns.append(ann)
    stats = writer.eval_coco(eval_set.coco, anns, np.array(ids),
                             "Upper bound (labels as predictions)")
    writer.close()
    return stats, anns


def main(argv=None):
    p = argparse.ArgumentParser(description="Label-construction AP ceiling")
    p.add_argument("--config", required=True)
    p.add_argument("--out_file", required=True)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args, options = p.parse_known_args(argv)
    resolve_device(args.device)
    config = upper_bound_config(update_config_command(load_config(args.config), options))
    eval_set = CocoKeypoints(config.DATASET.ROOT, mini=False, seed=0, mode="val",
                             filter_empty=False, num_joints=config.DATASET.NUM_JOINTS)
    return evaluate(config, eval_set, args.out_file, args.max_images, args.device)[0]


if __name__ == "__main__":
    main()
