"""The upper bounds, port against the JAX package: the three files of
configs/upper_bound as Python (``config.UPPER_BOUNDS``), the upper-bound
model (``models.upper_bound``) on the small HigherHRNet and Hourglass cuts,
its 3x3 average pool at the border, and ``python -m
pemp_tpu_torch.calc_upper_bounds`` against ``tools/calc_upper_bounds.py``
on a COCO-format set of rendered scenes (annotations only: no network
runs)."""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import _seeded_variables

from pemp_tpu.config import get_config as jax_get_config
from pemp_tpu.config import update_config as jax_update_config
from pemp_tpu.models.upper_bound import build_upper_bound_model as jax_build_ub
from pemp_tpu_torch import calc_upper_bounds
from pemp_tpu_torch.config import (
    UPPER_BOUNDS,
    check_path,
    get_config,
    load_config,
    update_config,
    upper_bound,
)
from pemp_tpu_torch.config.defaults import SMALL, SMALL_HG
from pemp_tpu_torch.data.synthetic import eval_scenes, make_batch
from pemp_tpu_torch.models.upper_bound import build_upper_bound_model, pooled_features
from pemp_tpu_torch.weights import from_jax_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", sorted(UPPER_BOUNDS))
def test_upper_bound_presets_are_the_files(name):
    """Each preset is its file as the port's loader and (on every key the
    port reads) the JAX package read it, and load_config resolves the name
    to it without PyYAML; the upper-bound path takes it."""
    path = str(ROOT / "configs" / f"{name}.yaml")
    got = upper_bound(name)
    assert got.to_dict() == update_config(get_config(), path).to_dict()
    assert load_config(name).to_dict() == got.to_dict()
    jax_tree = jax_update_config(jax_get_config(), path).to_dict()
    assert got.UB.KP == jax_tree["UB"]["KP"] == got.MODEL.KP
    check_path(got, "upper_bound")


def test_pooled_features_at_the_border():
    """The 3x3 mean pads with zeros and divides by 9 everywhere, as
    ``reduce_window`` with SAME padding over 9: 4/9 at a corner and 6/9 on
    an edge of ones; random maps within float32 rounding."""
    ones = pooled_features(torch.ones(1, 5, 7, 2))[0, ..., 0]
    assert float(ones[0, 0]) == pytest.approx(4 / 9) and float(ones[0, 3]) == pytest.approx(6 / 9)
    assert float(ones[2, 3]) == pytest.approx(1.0)
    x = np.random.RandomState(0).randn(2, 6, 9, 3).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), 0.0, jax.lax.add, (1, 3, 3, 1),
                                 (1, 1, 1, 1), "SAME") / 9.0
    np.testing.assert_allclose(pooled_features(torch.from_numpy(x)).numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


def _small(name, cut, use_gt):
    cfg = upper_bound(name)
    cfg.merge_from_other(cut)
    cfg.MODEL.GC.USE_GT = use_gt
    jcfg = jax_get_config()
    jcfg.defrost()
    jcfg.merge_from_other(cfg.to_dict())
    jcfg.TPU.MSG_PASS = "pallas"   # the asymmetric kNN layout, as the port's "auto"
    jcfg.freeze()
    return cfg, jcfg


class _WithGT:
    """The upper-bound model's ``init`` with the GT argument it needs
    (_seeded_variables calls ``init(key, imgs, train=False)``)."""

    def __init__(self, model):
        self.model = model

    def init(self, key, imgs, train=False):
        return self.model.init(key, imgs, jnp.zeros((imgs.shape[0], 30, 17, 3)),
                               factors=jnp.ones((imgs.shape[0], 30, 17)))


CUTS = {"hrnet": ("upper_bound/hrnet", SMALL, 64, 32),
        "hourglass": ("upper_bound/hg", SMALL_HG, 128, 32)}


@pytest.mark.parametrize("backbone,use_gt", [("hrnet", False), ("hrnet", True),
                                             ("hourglass", False)])
def test_upper_bound_model_matches_jax(backbone, use_gt):
    """UpperBoundModel on the small cuts with the same seeded backbone:
    labels, label masks, the predictions (the labels, one-hot classes) and
    the graph exact; the first stage's heatmap, the tags, the detector
    scores and the score maps within 1e-4 of their largest. The hrnet file's method 6 on detections, and on
    the GT joints (USE_GT)."""
    name, cut, size, out = CUTS[backbone]
    cfg, jcfg = _small(name, cut, use_gt)
    rng = np.random.RandomState(1)
    # one person an image on detections: at random weights the maps peak
    # anywhere, and more persons contend for them in the auction's slow
    # phases (thousands of rounds) on both sides
    batch = make_batch(rng, 2, size, (out,), 17, 30, n_people=None if use_gt else 1,
                       scale_range=(0.4, 0.9))
    jmodel = jax_build_ub(jcfg)
    variables = _seeded_variables(_WithGT(jmodel), jnp.zeros((1, size, size, 3)), rng)
    args = (batch["imgs"], batch["keypoints"])
    kw = dict(masks=batch["masks"][-1], factors=batch["factors"])
    want_sm, want = jax.jit(lambda v, i, k, m, f: jmodel.apply(v, i, k, masks=m, factors=f))(
        variables, *map(jnp.asarray, (*args, kw["masks"], kw["factors"])))
    model = build_upper_bound_model(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(variables["params"], variables.get("batch_stats", {}),
                                             cfg, backbone=cfg.UB.KP))
    with torch.no_grad():
        got_sm, got = model(*map(torch.from_numpy, args),
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    for part in ("labels", "masks", "graph", "preds"):
        for key, w in want[part].items():
            g = got[part][key].numpy()
            if key in ("heatmap", "tags", "detector_scores"):
                scale = float(np.abs(w).max())
                np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4 * scale,
                                           err_msg=f"{part} {key}")
            else:
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{part} {key}")
    np.testing.assert_allclose(got_sm.numpy(), np.asarray(want_sm), rtol=0,
                               atol=1e-4 * float(np.abs(want_sm).max()))
    assert np.asarray(want["labels"]["edge"]).sum() > (100 if use_gt else 10)


@pytest.fixture(scope="module")
def rendered_set(tmp_path_factory):
    """A COCO-format val2017 set of 6 scenes in two aspects (two canvas
    buckets), annotations only."""
    root = tmp_path_factory.mktemp("ub") / "coco"
    _, dataset = eval_scenes(np.random.RandomState(3), [(480, 640), (640, 480)] * 3,
                             render=False)
    (root / "annotations").mkdir(parents=True)
    (root / "val2017").mkdir()
    (root / "annotations" / "person_keypoints_val2017.json").write_text(json.dumps(dataset))
    return root


def test_calc_upper_bounds_matches_tools(rendered_set, tmp_path, monkeypatch):
    """The entry point on the CPU against tools/calc_upper_bounds.py on the
    same set and file: the same persons per image, keypoints within 2e-3,
    scores within 1e-6 and the same stats."""
    opts = ["DATASET.ROOT", str(rendered_set)]
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import calc_upper_bounds as jax_tool

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, "argv", ["calc_upper_bounds.py", "--config", "upper_bound/hrnet",
                                      "--out_file", "ub.txt", *opts, "LOG_DIR",
                                      str(tmp_path / "jax")])
    want_stats = jax_tool.main()
    got_stats = calc_upper_bounds.main(["--config", "upper_bound/hrnet", "--out_file", "ub.txt",
                                        "--device", "cpu", *opts, "LOG_DIR",
                                        str(tmp_path / "port")])
    got, want = (json.loads((tmp_path / side / "dt.json").read_text())
                 for side in ("port", "jax"))
    assert len(got) == len(want) >= 6
    assert [a["image_id"] for a in got] == [a["image_id"] for a in want]
    np.testing.assert_allclose([a["keypoints"] for a in got], [a["keypoints"] for a in want],
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose([a["score"] for a in got], [a["score"] for a in want], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got_stats), np.asarray(want_stats))
    assert float(np.asarray(got_stats)[0]) > 0.5     # the labels group most persons
    assert (tmp_path / "port" / "ub.txt").read_text().startswith("Upper bound")
