"""The training metrics of the eval writer, port against the JAX package:
``calc_metrics`` (binary and multi-class), ``topk_accuracy`` and
``roc_auc`` exactly on seeded arrays with ties and empty masks, and the
lines ``EvalWriter.eval_metrics``, ``eval_metric``, ``eval_part_metrics``
and ``eval_roc_auc`` write and print, for COCO and CrowdPose."""

import math

import numpy as np
import pytest

from pemp_tpu.config import get_config as jax_get_config
from pemp_tpu.eval import writer as jw
from pemp_tpu_torch.config import get_config
from pemp_tpu_torch.eval import writer as pw


def _same(got, want):
    if want is None or isinstance(want, float) and math.isnan(want):
        assert got is None or math.isnan(got), (got, want)
    elif isinstance(want, dict):
        assert got == want
    else:
        assert type(got) is type(want) and got == want, (got, want)


def _case(seed, n=200, classes=2, mask="random"):
    rng = np.random.RandomState(seed)
    out = rng.randint(0, classes, n)
    tgt = np.where(rng.rand(n) < 0.6, out, rng.randint(0, classes, n))
    m = {"random": (rng.rand(n) < 0.7).astype(np.float32), "none": None,
         "empty": np.zeros(n, np.float32)}[mask]
    return out, tgt, m


@pytest.mark.parametrize("seed,classes,mask", [
    (0, 2, "random"), (1, 2, "none"), (2, 2, "empty"), (3, 17, "random"), (4, 5, "none"),
    (5, 3, "empty")])
def test_calc_metrics_matches(seed, classes, mask):
    out, tgt, m = _case(seed, classes=classes, mask=mask)
    _same(pw.calc_metrics(out, tgt, m, classes), jw.calc_metrics(out, tgt, m, classes))
    # a predictor with no positive prediction: precision's empty denominator
    _same(pw.calc_metrics(np.zeros_like(out), tgt, m, classes),
          jw.calc_metrics(np.zeros_like(out), tgt, m, classes))
    assert pw.calc_metrics(None, tgt) is None


@pytest.mark.parametrize("topk", [1, 3])
@pytest.mark.parametrize("mask", ["random", "none", "empty"])
def test_topk_accuracy_matches(topk, mask):
    rng = np.random.RandomState(topk)
    scores = rng.randint(0, 4, (150, 17)).astype(np.float32)   # many ties
    target = rng.randint(0, 17, 150)
    _, _, m = _case(7, 150, mask=mask)
    _same(pw.topk_accuracy(scores, target, topk, m), jw.topk_accuracy(scores, target, topk, m))


@pytest.mark.parametrize("case", ["ties", "distinct", "one_class", "all_tied", "nan"])
def test_roc_auc_matches(case):
    rng = np.random.RandomState(11)
    labels = rng.rand(300) < 0.3
    scores = {"ties": np.round(rng.rand(300), 1), "distinct": rng.rand(300),
              "one_class": rng.rand(300), "all_tied": np.full(300, 0.5),
              "nan": np.where(rng.rand(300) < 0.05, np.nan, np.round(rng.rand(300), 2))}[case]
    if case == "one_class":
        labels = np.ones(300, bool)
    _same(pw.roc_auc(labels, scores), jw.roc_auc(labels, scores))
    if case == "all_tied":
        assert pw.roc_auc(labels, scores) == 0.5


def _eval_dicts(rng, nj):
    parts = {i: {k: list(rng.rand(4)) for k in ("acc", "prec", "rec", "f1")}
             for i in range(nj)}
    n = 400
    node = {"pred": list(np.round(rng.rand(n), 2)), "label": list(rng.rand(n) < 0.4),
            "class": list(rng.randint(0, nj - 2, n))}     # the last two types absent
    return parts, {"node": node}


@pytest.mark.parametrize("dataset,nj", [("coco", 17), ("crowd_pose", 14)])
def test_writer_lines_match(dataset, nj, tmp_path, capsys):
    """The four methods write and print the same text."""
    rng = np.random.RandomState(5)
    parts, roc = _eval_dicts(rng, nj)
    metrics = {"edge_acc": list(rng.rand(5)), "node_prec": list(rng.rand(3))}
    losses = list(rng.rand(6))
    texts = {}
    for side, (cfg, module) in {"port": (get_config(), pw),
                                "jax": (jax_get_config(), jw)}.items():
        if side == "jax":
            cfg.defrost()
        cfg.LOG_DIR = str(tmp_path / side)
        cfg.DATASET.DATASET = dataset
        cfg.DATASET.NUM_JOINTS = nj
        w = module.EvalWriter(cfg, fname="m.txt")
        w.eval_metrics(metrics, "Validation metrics")
        w.eval_metric(losses, "Mean loss")
        w.eval_part_metrics(parts, "Per part")
        w.eval_roc_auc(roc, "ROC AUC")
        w.eval_roc_auc({}, "no nodes")
        w.close()
        texts[side] = (tmp_path / side / "m.txt").read_text()
        texts[side + "_out"] = capsys.readouterr().out
    assert texts["port"] == texts["jax"]
    assert texts["port_out"] == texts["jax_out"]
    assert "node roc_auc" in texts["port"] and texts["port"].count("roc_auc") == nj - 1
