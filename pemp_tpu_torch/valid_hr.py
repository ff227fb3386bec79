"""Evaluates a backbone by associative-embedding grouping: the AE-grouping
entry point.

    python -m pemp_tpu_torch.valid_hr --config hrnet/w32_512 --out_file hr_eval.txt \
        [--parser hr|hg|hg2] [--max-images N] [--device cpu] [KEY VALUE ...]

The counterpart of ``tools/valid_hr.py`` (reference: src/valid_hr.py:88-172).
Per window of images: the backbone alone under multi-scale + flip
test-time augmentation on the card (tta.TTAPipeline with ``maps_only``),
then on the host two groupings of the same maps, each mapped back and
scored: the AE parser (``hr``: HigherHRNet's HeatmapParser; ``hg`` and
``hg2``: the Hourglass's) into ``dt_ae.json``, and correlation clustering
(GAEC) on the tag distances into ``dt_cc.json``. The report also gives the
mean seconds an image of the device pass (``kpt_forward``).

``--config`` takes the presets' names (config.PRESETS; ``hrnet/w32_512``
and ``hourglass/hg_512`` are this entry point's) and any other name from
``configs/<name>.yaml``; ``KEY VALUE`` pairs override it. Weights come from
``MODEL.PRETRAINED`` (a torch checkpoint of the backbone or of a composite
model, whose backbone part is read; train.checkpoint.load_params_only) or,
when it is empty or missing, are seeded random ones. Runs on CUDA unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time
import warnings

import numpy as np
import torch

from pemp_tpu_torch.config import load_config, update_config_command
from pemp_tpu_torch.data.datasets import CocoKeypoints
from pemp_tpu_torch.decode.ae_grouping import HeatmapParser, cluster_cc
from pemp_tpu_torch.decode.format import gen_ann_format
from pemp_tpu_torch.decode.group_hg import HeatmapParserHG, HeatmapParserHG2
from pemp_tpu_torch.eval.writer import EvalWriter
from pemp_tpu_torch.geometry.affine import reverse_affine_map
from pemp_tpu_torch.models.ae_group import build_ae_group_model
from pemp_tpu_torch.pipeline import init_random_weights
from pemp_tpu_torch.train.checkpoint import load_params_only
from pemp_tpu_torch.tta.multi_scale import TTAPipeline

PARSERS = ("hr", "hg", "hg2")


def make_parser(name: str, config):
    """The AE parser ``--parser`` names: HigherHRNet's (reference
    valid_hr.py:109) or the Hourglass's two (reference group_hg.py:192,
    :414)."""
    if name == "hr":
        return HeatmapParser(config)
    if name == "hg":
        return HeatmapParserHG(config)
    if name == "hg2":
        return HeatmapParserHG2()
    raise ValueError(f"parser {name!r}: one of {PARSERS}")


def host_maps(out):
    """One image's aggregated maps as the parsers take them, cropped to its
    canvas: det (J, H, W) and tags (J, H, W, S), numpy."""
    ch, cw = out["canvas_size"]
    det = out["scoremaps"].cpu().numpy().transpose(2, 0, 1)[:, :ch, :cw]
    tags = out["tags"].cpu().numpy().transpose(2, 0, 1, 3)[:, :ch, :cw, :]
    return det, tags


def group(parser_name, parser, det, tags, config):
    """The two groupings of one image's maps: (AE persons,
    correlation-clustering persons), in map coordinates."""
    if parser_name == "hg2":   # HG2 always refines (group_hg.py:480-487)
        grouped, _ = parser.parse(det, tags, adjust=config.TEST.ADJUST)
    else:
        # tools/valid_hr.py passes ``TEST.REFINE_COMP or True``: always
        grouped, _ = parser.parse(det, tags, adjust=config.TEST.ADJUST, refine=True)
    return grouped, cluster_cc(det, tags, config.DATASET.NUM_JOINTS)


def to_anns(persons, out, img_id, config):
    """Persons in map coordinates -> COCO results of the image, mapped back
    to its coordinates (None when there are none)."""
    if not len(persons):
        return None
    mapped = reverse_affine_map(np.array(persons, copy=True), out["base_size"],
                                config.DATASET.INPUT_SIZE, out["scaling_type"],
                                min(config.TEST.SCALE_FACTOR))
    return gen_ann_format(mapped, img_id)


def evaluate(config, model, eval_set, out_file, parser: str = "hr", max_images=None,
             batch_size: int = 8, window: int = 64, stage_times=None):
    """Evaluates ``model`` (models.ae_group) on ``eval_set`` (anything with
    ``img_ids``, ``coco`` and ``load_raw``) and writes the report to
    ``<LOG_DIR>/<out_file>`` and the results to ``<LOG_DIR>/dt_ae.json``
    and ``dt_cc.json``. Returns (AE stats, clustering stats).

    ``stage_times``, when a dict, gathers the seconds of each stage: the
    pipeline's (TTAPipeline) and ``parse`` (both host groupings and the
    reverse map).
    """
    pipe = TTAPipeline(model, config, maps_only=True)
    pipe.stage_times = stage_times
    ae_parser = make_parser(parser, config)
    writer = EvalWriter(config, fname=out_file)
    n = len(eval_set) if max_images is None else min(max_images, len(eval_set))
    anns_ae, anns_cc, eval_ids, durations = [], [], [], []
    for w0 in range(0, n, window):
        idxs = range(w0, min(w0 + window, n))
        images = [np.asarray(eval_set.load_raw(i)[3]) for i in idxs]
        t0 = time.perf_counter()
        outs = pipe.run_batched(images, batch_size=batch_size)
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)
        per_img = (time.perf_counter() - t0) / len(idxs)
        for i, out in zip(idxs, outs):
            durations.append(per_img)
            img_id = int(eval_set.img_ids[i])
            eval_ids.append(img_id)
            t0 = time.perf_counter()
            det, tags = host_maps(out)
            grouped, persons_cc = group(parser, ae_parser, det, tags, config)
            for anns, persons in ((anns_ae, grouped), (anns_cc, persons_cc)):
                ann = to_anns(persons, out, img_id, config)
                if ann is not None:
                    anns.append(ann)
            if stage_times is not None:
                stage_times["parse"] = stage_times.get("parse", 0.0) + time.perf_counter() - t0
            if (i + 1) % 50 == 0:
                print(f"{i + 1}/{n}")

    ids = np.array(eval_ids)
    stats_ae = writer.eval_coco(eval_set.coco, anns_ae, ids, "AE grouping (HeatmapParser)",
                                "dt_ae.json")
    stats_cc = writer.eval_coco(eval_set.coco, anns_cc, ids, "Correlation clustering on tags",
                                "dt_cc.json")
    writer.eval_speed("kpt_forward", durations)
    writer.close()
    return stats_ae, stats_cc


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a backbone by AE grouping")
    p.add_argument("--config", required=True,
                   help="config name under configs/ (no .yaml), or a .yaml path")
    p.add_argument("--out_file", required=True)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--parser", choices=PARSERS, default="hr",
                   help="AE parser: hr = HigherHRNet's HeatmapParser; hg / hg2 = the "
                        "Hourglass's")
    p.add_argument("--device", default="cuda")
    p.add_argument("options", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)

    config = update_config_command(load_config(args.config), args.options or [])
    if not config.LOG_DIR:
        config.LOG_DIR = "tmp"
    model = build_ae_group_model(config, device=args.device)
    pretrained = config.MODEL.PRETRAINED
    if pretrained and os.path.exists(pretrained):
        load_params_only(pretrained, model)
        print(f"loaded checkpoint {pretrained}")
    else:
        warnings.warn("no checkpoint found, evaluating random weights", stacklevel=1)
        init_random_weights(model, 0)
    eval_set = CocoKeypoints(config.DATASET.ROOT, mini=config.TEST.SPLIT == "coco_17_mini",
                             seed=0, mode="val", year=17, mask_crowds=False, filter_empty=False)
    return evaluate(config, model, eval_set, args.out_file, parser=args.parser,
                    max_images=args.max_images)


if __name__ == "__main__":
    main()
