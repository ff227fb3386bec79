"""Draws predicted poses and the graph's detections over images.

    python -m pemp_tpu_torch.draw_images --config C [--out tmp/draws] \
        [--max-images 8] [--detail] [--device cpu] [KEY VALUE ...]

The counterpart of ``tools/draw_images.py`` (reference:
src/draw_images_coco.py, draw_images_hr.py). Each image of the ``val`` set
under ``DATASET.ROOT`` goes alone through the eval pipeline
(tta.TTAPipeline: multi-scale and flip as ``TEST`` sets them, graph, MPN,
threshold decode); its persons, mapped back to the image, are drawn to
``<out>/<id>_poses.png`` and the valid detections above
``MODEL.MPN.NODE_THRESHOLD`` on a gray canvas of the pipeline's size to
``<id>_det.png``. ``--detail`` adds, on the same canvas, the clusters of
the threshold grouping (``decode.assembly.cluster_threshold``), the node
labels (score > 0.5), each cluster's edges into its best nose and the
edges between clusters for joint types 0, 3 and 4
(``utils.vis``; PNGs of the port's own pixels, without matplotlib).

Weights come from ``MODEL.PRETRAINED`` (train.checkpoint.load_params_only)
or are seeded random ones. Runs on CUDA unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pemp_tpu_torch.config import load_config, update_config_command
from pemp_tpu_torch.data.datasets import CocoKeypoints
from pemp_tpu_torch.decode.assembly import cluster_threshold
from pemp_tpu_torch.geometry.affine import reverse_affine_map
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.pipeline import init_random_weights
from pemp_tpu_torch.train.checkpoint import load_params_only
from pemp_tpu_torch.tta.multi_scale import TTAPipeline
from pemp_tpu_torch.utils import vis

DETAIL_TYPES = (0, 3, 4)


def draw(config, model, eval_set, out_dir, max_images=8, detail=False) -> list[str]:
    """Draws the first ``max_images`` of ``eval_set`` (anything with
    ``img_ids`` and ``load_raw``) with ``model``; returns the files
    written."""
    os.makedirs(out_dir, exist_ok=True)
    pipe = TTAPipeline(model, config)
    in_size, nj = config.DATASET.INPUT_SIZE, config.DATASET.NUM_JOINTS
    dataset = "COCO" if config.DATASET.DATASET == "coco" else "CROWDPOSE"
    written = []
    for i in range(min(max_images, len(eval_set))):
        img_id, _, _, image = eval_set.load_raw(i)
        out = pipe(np.asarray(image))
        host = {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                for k, v in out.items() if torch.is_tensor(v)}
        persons = host["persons"][host["person_valid"]]
        if len(persons):
            persons = reverse_affine_map(persons.copy(), (image.shape[1], image.shape[0]),
                                         in_size, out["scaling_type"],
                                         min(config.TEST.SCALE_FACTOR))
        stem = os.path.join(out_dir, f"{img_id}")
        written.append(vis.save_valid_image(image, persons, f"{stem}_poses.png", dataset))
        det = host["nodes"]
        valid = host["node_valid"] & (host["node_scores"] > config.MODEL.MPN.NODE_THRESHOLD)
        # the detections lie on the pipeline's canvas: drawn on a gray one
        ch, cw = out["canvas_size"]
        canvas = np.full((ch, cw, 3), 0.3, np.float32)
        written.append(vis.draw_detections(canvas, det, valid, f"{stem}_det.png"))
        if detail:
            # reference: draw_images_coco.py:154-175
            keep = torch.from_numpy(valid).to(pipe.device)
            labels = cluster_threshold(out["edge_index"][None], out["edge_valid"][None],
                                       out["edge_pred"][None], len(det), keep[None])
            labels = labels[0].cpu().numpy()
            nscore, ei, ep = host["node_scores"], host["edge_index"], host["edge_pred"]
            written.append(vis.draw_detection_with_cluster(canvas, det, labels, valid, stem))
            written.append(vis.draw_detection_classification_result(canvas, det, nscore > 0.5,
                                                                    valid, stem))
            written.append(vis.draw_edges_conf(canvas, det, labels, nscore, ei, ep, valid, stem))
            for t in DETAIL_TYPES:
                written.append(vis.draw_inter_person_edge_conf(canvas, det, labels, nscore, ei,
                                                               ep, valid, t, stem, nj))
        print(f"{img_id}: {len(persons)} persons -> {out_dir}")
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description="Draw predicted poses over images")
    p.add_argument("--config", required=True)
    p.add_argument("--out", default="tmp/draws")
    p.add_argument("--max-images", type=int, default=8)
    p.add_argument("--detail", action="store_true",
                   help="also write the cluster, node-label and edge-confidence drawings")
    p.add_argument("--device", default="cuda")
    args, options = p.parse_known_args(argv)
    config = update_config_command(load_config(args.config), options)
    model = build_pose_model(config, dtype=torch.float32, device=args.device, path="valid")
    if config.MODEL.PRETRAINED and os.path.exists(config.MODEL.PRETRAINED):
        load_params_only(config.MODEL.PRETRAINED, model)
    else:
        init_random_weights(model, 0)
    eval_set = CocoKeypoints(config.DATASET.ROOT, mode="val", filter_empty=False,
                             num_joints=config.DATASET.NUM_JOINTS)
    return draw(config, model, eval_set, args.out, args.max_images, args.detail)


if __name__ == "__main__":
    main()
