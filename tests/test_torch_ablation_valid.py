"""The ablation configurations through the eval entry point, port against
JAX package: ``python -m pemp_tpu_torch.valid`` against ``tools/valid.py``
with model_58_4 as the file and each ablation delta's keys as KEY VALUE
options (the three connectivity graphs and the six feature-importance
sets), on a 4-image set written by tools/make_fake_coco.py, at the narrow
configuration, one scale with flip, threshold grouping (GAEC on the host
for `fully`). The same seeded weights reach JAX through its model's
``init`` and the port through a torch checkpoint. Keypoints within 2e-3,
scores within 1e-4."""

import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import yaml
from test_torch_slice import _seeded_variables
from test_torch_tta import OVERRIDES

from pemp_tpu.config import get_config as jax_get_config
from pemp_tpu.config import update_config as jax_update_config
from pemp_tpu.config import update_config_command as jax_update_config_command
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu_torch import valid
from pemp_tpu_torch.config import ABLATIONS, ablation, load_config, update_config_command
from pemp_tpu_torch.config.defaults import NOT_READ
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.train.checkpoint import save_checkpoint
from pemp_tpu_torch.weights import from_jax_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = "hybrid_class_agnostic_end2end/model_58_4"
SPLIT = "coco_17_full"
# one scale with flip; the file's node threshold 1.0 passes no sigmoid
EVAL = ["TEST.SCALE_FACTOR", "[1.0]", "TEST.FLIP_TEST", "True", "TEST.SPLIT", SPLIT,
        "MODEL.MPN.NODE_THRESHOLD", "0.3", "MODEL.PRETRAINED", "''"]
DELTAS = ["connectivity/fully", "connectivity/score_based", "connectivity/score_based_per_type",
          "feature_importance/model_nothing", "feature_importance/model_position",
          "feature_importance/model_type", "feature_importance/model_gostic_nothing",
          "feature_importance/model_gostic_position", "feature_importance/model_gostic_type"]


def delta_options(name: str) -> list:
    """The delta file's keys (but its LOG_DIR) as KEY VALUE options."""
    tree = yaml.safe_load((ROOT / "configs" / f"{name}.yaml").read_text())
    tree.pop("LOG_DIR", None)
    out = []

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out.extend([f"{prefix}{k}", repr(v)])

    walk(tree, "")
    return out


@pytest.fixture(scope="module")
def fake_coco(tmp_path_factory):
    base = tmp_path_factory.mktemp("ablation_valid")
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_fake_coco.py"), "--root",
                    str(base / "coco"), "--images", "4", "--size", "96"],
                   check=True, capture_output=True)
    return base


class _Seeded:
    """The JAX model, its ``init`` giving the seeded variables."""

    def __init__(self, model, variables):
        self._model, self._variables = model, variables

    def __getattr__(self, name):
        return getattr(self._model, name)

    def init(self, *args, **kwargs):
        return self._variables


def _results(log_dir):
    return json.loads((log_dir / f"person_keypoints_{SPLIT}_mpn_results.json").read_text())


@pytest.mark.parametrize("name,method", [(d, "threshold") for d in DELTAS[:3]]
                         + [("connectivity/fully", "GAEC")])
def test_ablation_valid_matches_tools_valid(fake_coco, monkeypatch, name, method):
    """The connectivity deltas here; the feature-importance ones in
    test_torch_ablation_valid_features.py (a file of its own, so that the
    two halves run on two workers)."""
    valid_matches(fake_coco, monkeypatch, name, method)


def valid_matches(fake_coco, monkeypatch, name, method):
    base = fake_coco / f"{name.replace('/', '_')}_{method}"
    opts = (OVERRIDES + EVAL + delta_options(name)
            + ["DATASET.ROOT", str(fake_coco / "coco"), "MODEL.GC.CC_METHOD", method])
    # the JAX side's asymmetric kNN layout: "auto" is the symmetric einsum
    # one away from a TPU, the port's "auto" the asymmetric one
    jax_opts = opts + ["TPU.MSG_PASS", "pallas"]
    jcfg = jax_update_config_command(
        jax_update_config(jax_get_config(), str(ROOT / "configs" / f"{CONFIG}.yaml")),
        jax_opts)
    jcfg.defrost()
    jcfg.TPU.COLLECT_AUX = False
    jcfg.freeze()
    jmodel = jax_build_pose_model(jcfg)
    variables = _seeded_variables(jmodel, jnp.zeros((1, 64, 64, 3)), np.random.RandomState(0))
    # edge logits around both grouping thresholds, so that persons form
    agnostic = jcfg.MODEL.MPN.AGGR_TYPE == "agnostic"
    bias = (2.0 if agnostic else 1.5) if method == "threshold" else 0.2
    variables["params"]["mpn"]["edge_classification"]["lin2"]["bias"] = np.array(
        [bias], np.float32)
    if agnostic:
        # MPLayer sums its messages over 80 slots unnormalised: at seeded
        # weights the logits saturate after 3 steps and no node passes;
        # smaller message weights keep them in range
        layer = variables["params"]["mpn"]["mpn"]["layer"]
        layer["mlp_node"]["kernel"] = layer["mlp_node"]["kernel"] * np.float32(0.01)

    import pemp_tpu.models

    monkeypatch.setattr(pemp_tpu.models, "build_pose_model",
                        lambda cfg: _Seeded(jmodel, variables))
    monkeypatch.setenv("EVAL_FANOUT", "0")
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import valid as jax_valid

    monkeypatch.setattr(sys, "argv", ["valid.py", "--config", CONFIG, "--out_file", "eval.txt",
                                      *jax_opts, "LOG_DIR", str(base / "jax")])
    monkeypatch.chdir(ROOT)
    jax_valid.main()

    port_cfg = update_config_command(load_config(CONFIG), opts)
    model = build_pose_model(port_cfg, device="cpu", path="valid")
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"],
                                             port_cfg))
    save_checkpoint(str(base / "weights.pt"), model)
    valid.main(["--config", CONFIG, "--out_file", "eval.txt", "--device", "cpu", *opts,
                "MODEL.PRETRAINED", str(base / "weights.pt"), "LOG_DIR", str(base / "port")])
    got, want = _results(base / "port"), _results(base / "jax")
    assert len(got) == len(want) >= 2
    assert [a["image_id"] for a in got] == [a["image_id"] for a in want]
    np.testing.assert_allclose([a["keypoints"] for a in got], [a["keypoints"] for a in want],
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose([a["score"] for a in got], [a["score"] for a in want],
                               atol=1e-4, rtol=0)


def _read_keys(tree: dict, prefix: str = "") -> dict:
    """``tree`` without its NOT_READ keys."""
    return {k: _read_keys(v, f"{prefix}{k}.") if isinstance(v, dict) else v
            for k, v in tree.items() if f"{prefix}{k}" not in NOT_READ}


@pytest.mark.parametrize("name", sorted(ABLATIONS))
def test_ablation_table_is_the_delta_file(name):
    """config.ABLATIONS (what chip_smoke.py runs, without PyYAML) is each
    ablation file but its LOG_DIR and the keys no path reads (NOT_READ:
    node_feature_selection's KP_OUTPUT_DIM), and ``ablation(name)`` is
    model_58_4 with the file's keys given as options."""
    tree = yaml.safe_load((ROOT / "configs" / f"{name}.yaml").read_text())
    tree.pop("LOG_DIR")
    assert ABLATIONS[name] == _read_keys(tree)
    want = update_config_command(load_config(CONFIG), delta_options(name))
    assert ablation(name) == want
