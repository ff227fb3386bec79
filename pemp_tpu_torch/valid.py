"""Evaluates a pose model on a keypoint set: the eval entry point.

    python -m pemp_tpu_torch.valid --config hrnet/w48_640 --out_file eval.txt \
        [--max-images N] [--msg-pass ROUTE] [--device cpu] [KEY VALUE ...]

The counterpart of ``tools/valid.py`` (reference: src/valid.py:94-183). Per
window of images: multi-scale + flip test-time augmentation on the card
(tta.TTAPipeline), graph and MPN, grouping, the reverse affine map, and
COCO or CrowdPose OKS scoring (test-dev writes the results file instead).
The grouping is ``MODEL.GC.CC_METHOD``'s: ``threshold`` on the card;
``GAEC``, ``KL`` or ``MUT`` by correlation clustering on the host, then the
card's decode with refine and adjust; ``greedy`` by the greedy person
construction on the host (decode.greedy). An MPN with a tag head groups
by its tags whatever the method, as tools/valid.py does: the AE matching
of the kept nodes by tag (``mpn_match_by_tag``), then the AE parser's
refine and adjust (decode.ae_grouping).

``--config`` takes ``hrnet/w48_640`` and
``hybrid_class_agnostic_end2end/model_58_4`` from their Python presets (no
PyYAML needed) and any other name from ``configs/<name>.yaml``; ``KEY
VALUE`` pairs override it (``TEST.FLIP_TEST True``). ``--msg-pass`` sets
``TPU.MSG_PASS``. Weights come from ``MODEL.PRETRAINED`` (a torch
checkpoint; train.checkpoint.load_params_only) or, when it is empty or
missing, are seeded random ones. Runs on CUDA unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import warnings

import numpy as np
import torch

from pemp_tpu_torch.cluster.api import cluster_labels
from pemp_tpu_torch.config import load_config, update_config_command
from pemp_tpu_torch.data.datasets import (
    CocoKeypoints,
    CocoKeypointsTest,
    CrowdPoseKeypoints,
    OCHumans,
)
from pemp_tpu_torch.decode.assembly import decode_poses
from pemp_tpu_torch.decode.format import persons_to_ann
from pemp_tpu_torch.eval.writer import EvalWriter
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.pipeline import init_random_weights
from pemp_tpu_torch.train.checkpoint import load_params_only
from pemp_tpu_torch.tta.multi_scale import TTAPipeline


def eval_set_for(config):
    """The keypoint set ``TEST.SPLIT`` names under ``DATASET.ROOT``
    (tools/valid.py:71-96)."""
    split, root = config.TEST.SPLIT, config.DATASET.ROOT
    if split in ("coco_17_full", "coco_17_mini"):
        return CocoKeypoints(root, mini=split == "coco_17_mini", seed=0, mode="val", year=17,
                             filter_empty=False)
    if split == "test-dev2017":
        return CocoKeypointsTest(root, year=17)
    if split == "crowd_pose_test":
        return CrowdPoseKeypoints(root, mini=False, seed=0, mode="test", filter_empty=False)
    if split in ("ochuman_valid", "ochuman_test"):
        return OCHumans(root, mode="val" if split == "ochuman_valid" else "test")
    raise NotImplementedError(split)


def _host_grouping(out, config):
    """Correlation clustering on the host, then the decode with its
    clusters (tools/valid.py:194-222)."""
    nodes = out["nodes"].cpu().numpy()
    nscore = out["node_scores"].cpu().numpy()
    nvalid = out["node_valid"].cpu().numpy()
    ei = out["edge_index"].cpu().numpy()
    ev = out["edge_valid"].cpu().numpy()
    ep = out["edge_pred"].cpu().numpy()
    keep = nvalid & (nscore > config.MODEL.MPN.NODE_THRESHOLD)
    sel = ev & keep[ei[0]] & keep[ei[1]]
    labels = cluster_labels(ei[:, sel], ep[sel] - 0.5, len(nodes), config.MODEL.GC.CC_METHOD)
    one = lambda t: t[None]  # noqa: E731
    persons, person_valid = decode_poses(
        one(out["scoremaps"]), one(out["tags"]), one(out["nodes"]), one(out["node_scores"]),
        one(out["edge_index"]), one(out["edge_valid"]), one(out["edge_pred"]),
        one(out["node_valid"]), node_threshold=config.MODEL.MPN.NODE_THRESHOLD,
        num_joints=config.DATASET.NUM_JOINTS, blocked_c=0,
        class_probs=None if out["class_prob"] is None else one(out["class_prob"]),
        with_fill_mean=config.TEST.FILL_MEAN, with_refine=config.TEST.WITH_REFINE,
        with_adjust=config.TEST.ADJUST,
        cluster_labels=torch.from_numpy(labels).to(out["nodes"].device)[None],
    )
    return persons[0], person_valid[0]


def _tag_grouping(out, config):
    """Grouping by the MPN's per-node tags (tools/valid.py:165-191): the
    valid nodes matched by tag with their detector scores on the host, then
    the AE parser's refine (fill score 0.001, the reference's
    perd_to_ann_ae) and quarter adjust on the maps, where they lie.
    Returns numpy (persons (P, J, 3), person_valid (P,))."""
    from pemp_tpu_torch.decode.ae_grouping import HeatmapParser, Params, mpn_match_by_tag

    num_joints = config.DATASET.NUM_JOINTS
    keep = out["node_valid"].cpu().numpy()
    det = out["nodes"].cpu().numpy()[keep]
    scr = out["detector_scores"].cpu().numpy()[keep]
    tp = out["tag_pred"].cpu().numpy()[keep]
    ans = mpn_match_by_tag(det, tp, scr, Params(num_joints=num_joints))
    sm = out["scoremaps"].permute(2, 0, 1)
    tg = out["tags"].permute(2, 0, 1, 3)
    parser = HeatmapParser(num_joints=num_joints)
    if len(ans) and config.TEST.WITH_REFINE:
        ans = np.stack([parser.refine(sm, tg, kp, fill_score=0.001) for kp in ans])
    if len(ans) and config.TEST.ADJUST:
        ans = parser.adjust(np.asarray(ans, np.float32), sm)
    persons = np.asarray(ans, np.float32).reshape(-1, num_joints, 3)
    return persons, np.ones(len(persons), bool)


def _greedy_grouping(out, config):
    """The greedy person construction on the host (tools/valid.py:197-212):
    node scores and edge scores zeroed off the valid nodes and slots, the
    class argmax as the types. Returns numpy (persons (P, J, 3),
    person_valid (P,))."""
    from pemp_tpu_torch.decode.greedy import greedy_person_construction

    num_joints = config.DATASET.NUM_JOINTS
    host = {k: out[k].cpu().numpy() for k in ("nodes", "node_valid", "node_scores",
                                              "edge_index", "edge_valid", "edge_pred")}
    cp = None if out["class_prob"] is None else out["class_prob"].cpu().numpy()
    persons, _ = greedy_person_construction(
        host["nodes"], host["node_scores"] * host["node_valid"],
        host["edge_pred"] * host["edge_valid"], cp, host["edge_index"], num_joints)
    return persons, np.ones(len(persons), bool)


def evaluate(config, model, eval_set, out_file, max_images=None, batch_size: int = 8,
             window: int = 64, stage_times=None):
    """Evaluates ``model`` on ``eval_set`` (anything with ``img_ids``,
    ``coco`` and ``load_raw``) and writes the report to
    ``<LOG_DIR>/<out_file>``. Returns the stats (None on test-dev, whose
    results go to ``<LOG_DIR>/person_keypoints_test-dev2017_mpn_results.json``).

    ``stage_times``, when a dict, gathers the seconds of each stage: the
    pipeline's (TTAPipeline), ``cluster`` (host grouping of any kind) and
    ``scoring``.
    """
    cc_method = config.MODEL.GC.CC_METHOD
    # a tag-regression MPN groups by its tags on the host: no card decode
    has_tag = getattr(model.mpn, "tag_pred", None) is not None
    pipe = TTAPipeline(model, config, with_decode=cc_method == "threshold" and not has_tag)
    pipe.stage_times = stage_times
    split = config.TEST.SPLIT
    writer = None if split == "test-dev2017" else EvalWriter(config, fname=out_file)
    n = len(eval_set) if max_images is None else min(max_images, len(eval_set))
    anns, eval_ids, dur_kpt, dur_constr = [], [], [], []
    for w0 in range(0, n, window):
        idxs = range(w0, min(w0 + window, n))
        images = [np.asarray(eval_set.load_raw(i)[3]) for i in idxs]
        t0 = time.perf_counter()
        outs = pipe.run_batched(images, batch_size=batch_size)
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)
        per_img = (time.perf_counter() - t0) / len(idxs)
        for i, out in zip(idxs, outs):
            dur_kpt.append(per_img)
            img_id = int(eval_set.img_ids[i])
            eval_ids.append(img_id)
            t0 = time.perf_counter()
            if has_tag:
                persons, person_valid = _tag_grouping(out, config)
            elif cc_method == "threshold":
                persons, person_valid = out["persons"], out["person_valid"]
            elif cc_method == "greedy":
                persons, person_valid = _greedy_grouping(out, config)
            else:
                persons, person_valid = _host_grouping(out, config)
            if stage_times is not None and (has_tag or cc_method != "threshold"):
                stage_times["cluster"] = (stage_times.get("cluster", 0.0)
                                          + time.perf_counter() - t0)
            if torch.is_tensor(persons):
                persons, person_valid = persons.cpu().numpy(), person_valid.cpu().numpy()
            ann = persons_to_ann(
                persons, person_valid, out["base_size"],
                config.DATASET.INPUT_SIZE, img_id, out["scaling_type"],
                min(config.TEST.SCALE_FACTOR), scoring_method=config.TEST.SCORING,
            )
            dur_constr.append(time.perf_counter() - t0)
            if ann is not None:
                anns.append(ann)
            if (i + 1) % 50 == 0:
                print(f"{i + 1}/{n} images, {np.mean(dur_kpt[-50:]):.3f}s/img fwd")

    t0 = time.perf_counter()
    if writer is None:
        os.makedirs(config.LOG_DIR, exist_ok=True)
        with open(os.path.join(config.LOG_DIR,
                               "person_keypoints_test-dev2017_mpn_results.json"), "w") as f:
            json.dump(sum(anns, []), f)
        return None
    stats = writer.eval_coco(eval_set.coco, anns, np.array(eval_ids), "General Evaluation",
                             f"person_keypoints_{split}_mpn_results.json")
    writer.eval_speed("kpt_detector", dur_kpt, "pose_constr", dur_constr)
    writer.close()
    if stage_times is not None:
        stage_times["scoring"] = stage_times.get("scoring", 0.0) + time.perf_counter() - t0
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate the MPN pose model")
    p.add_argument("--config", required=True,
                   help="config name under configs/ (no .yaml), or a .yaml path")
    p.add_argument("--out_file", required=True)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--msg-pass", help="TPU.MSG_PASS (the config's value by default)")
    p.add_argument("--device", default="cuda")
    p.add_argument("options", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)

    config = update_config_command(load_config(args.config), args.options or [])
    if args.msg_pass:
        config.TPU.MSG_PASS = args.msg_pass
    if not config.LOG_DIR:
        config.LOG_DIR = "tmp"
    model = build_pose_model(config, dtype=torch.float32, device=args.device, path="valid")
    pretrained = config.MODEL.PRETRAINED
    if pretrained and os.path.exists(pretrained):
        load_params_only(pretrained, model)
        print(f"loaded checkpoint {pretrained}")
    else:
        warnings.warn("no checkpoint found, evaluating random weights", stacklevel=1)
        init_random_weights(model, 0)
    return evaluate(config, model, eval_set_for(config), args.out_file,
                    max_images=args.max_images)


if __name__ == "__main__":
    main()
