"""The port's OKS scoring, report writer and result formatting against
pemp_tpu.eval and pemp_tpu.decode.format: on detections made from the
ground truth with noise (chip_smoke.py's scoring case), the ten (COCO) or
nine (CrowdPose) stats equal JAX's to 1e-12, and so do the stats the card's
scoring phase pins; the report's lines are JAX's, and the ground truth
itself scores AP 1.0."""

import importlib.util
import pathlib

import numpy as np
import pytest

from pemp_tpu.data.coco_api import COCO as JaxCOCO
from pemp_tpu.decode.format import persons_to_ann as jax_persons_to_ann
from pemp_tpu.eval import EvalWriter as JaxEvalWriter
from pemp_tpu.eval import KeypointEval as JaxKeypointEval
from pemp_tpu_torch.config import get_config
from pemp_tpu_torch.data.coco_api import COCO
from pemp_tpu_torch.decode.format import persons_to_ann
from pemp_tpu_torch.eval.writer import EvalWriter


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the card's scoring phase: its case and the stats it pins
SMOKE = _load_chip_smoke()


def _jax_stats(gt, dets, crowdpose):
    coco = JaxCOCO(gt)
    ev = JaxKeypointEval(coco, coco.loadRes(dets), crowdpose=crowdpose)
    ev.evaluate(sorted(coco.imgs))
    ev.accumulate()
    return ev.summarize(verbose=False)


@pytest.mark.parametrize("crowdpose", [False, True], ids=["coco", "crowdpose"])
@pytest.mark.parametrize("noise", [0.0, 2.0, 6.0])
def test_keypoint_eval_matches(crowdpose, noise):
    gt, dets = SMOKE.scoring_case(crowdpose, noise)
    got = SMOKE.keypoint_stats(gt, sum(dets, []), crowdpose)
    want = _jax_stats(gt, sum(dets, []), crowdpose)
    assert len(got) == (9 if crowdpose else 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.all(want > -1)          # every area or crowd range holds ground truth
    if noise == 0.0:
        assert want[0] < 1.0          # the false detections score above some true ones


@pytest.mark.parametrize("name", ["coco", "crowdpose"])
def test_card_scoring_stats_are_jax_stats(name):
    """chip_smoke.py's scoring phase holds the port on the card's machine to
    SCORING_STATS: they are the JAX package's stats on its case."""
    crowdpose = name == "crowdpose"
    gt, dets = SMOKE.scoring_case(crowdpose, 2.0)
    np.testing.assert_allclose(_jax_stats(gt, sum(dets, []), crowdpose),
                               SMOKE.SCORING_STATS[name], rtol=0, atol=1e-12)


def test_ground_truth_scores_ap_one():
    for crowdpose in (False, True):
        gt, _ = SMOKE.scoring_case(crowdpose, 0.0)
        for a in gt["annotations"]:
            a["iscrowd"] = 0
        dets = [{"image_id": a["image_id"], "category_id": 1, "keypoints": a["keypoints"],
                 "score": 1.0} for a in gt["annotations"]]
        assert SMOKE.keypoint_stats(gt, dets, crowdpose)[0] == 1.0


@pytest.mark.parametrize("dataset", ["coco", "crowd_pose"])
def test_eval_writer_lines_match(tmp_path, dataset):
    gt, anns = SMOKE.scoring_case(dataset == "crowd_pose", 3.0)
    ids = np.array([i["id"] for i in gt["images"]])
    texts = []
    for name, writer_cls, coco_cls in (("port", EvalWriter, COCO),
                                       ("jax", JaxEvalWriter, JaxCOCO)):
        cfg = get_config()
        cfg.LOG_DIR = str(tmp_path / name)
        cfg.DATASET.DATASET = dataset
        writer = writer_cls(cfg, fname="eval.txt")
        writer.eval_coco(coco_cls(gt), anns, ids, "General Evaluation", "dt.json")
        writer.eval_speed("kpt_detector", [0.5, 0.25], "pose_constr", [0.125])
        writer.close()
        texts.append(((tmp_path / name / "eval.txt").read_text(),
                      (tmp_path / name / "dt.json").read_text()))
    assert texts[0] == texts[1]
    assert "AP" in texts[0][0] and "pose_constr: 0.125" in texts[0][0]


@pytest.mark.parametrize("scoring", ["default", "correct", "mean"])
@pytest.mark.parametrize("scaling_type", ["short", "short_with_resize"])
def test_persons_to_ann_matches(scoring, scaling_type):
    rng = np.random.RandomState(3)
    persons = rng.rand(30, 17, 3).astype(np.float32) * [160, 120, 1]
    valid = rng.rand(30) < 0.3
    got = persons_to_ann(persons, valid, (320, 240), 256, 7, scaling_type, 0.5, scoring)
    want = jax_persons_to_ann(persons, valid, (320, 240), 256, 7, scaling_type, 0.5, scoring)
    assert got == want and len(got) == valid.sum()
    assert persons_to_ann(persons, np.zeros(30, bool), (320, 240), 256, 7, scaling_type) is None
