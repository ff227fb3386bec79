"""The tag-regression, greedy, background-class and group-based
configurations (config.ZOO over model_58_4) through the eval entry point,
port against JAX package: ``python -m pemp_tpu_torch.valid`` against
``tools/valid.py`` on a 4-image set written by tools/make_fake_coco.py, at
the narrow configuration, one scale with flip: the tag model grouped by
its tags (mpn_match_by_tag, refine, adjust), the flagship grouped greedily
on the host, the background model (J + 1 classes: a node whose class
argmax is the background keeps the type J, which the decode clamps as the
JAX package's gathers do) by GAEC and on the card's threshold decode, the
group-based model by GAEC. The same seeded weights reach JAX through its
model's ``init`` and the port through a torch checkpoint. Keypoints within
2e-3, scores within 1e-4."""

import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import _seeded_variables
from test_torch_tta import OVERRIDES

from pemp_tpu.config import get_config as jax_get_config
from pemp_tpu.config import update_config as jax_update_config
from pemp_tpu.config import update_config_command as jax_update_config_command
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu_torch import valid
from pemp_tpu_torch.config import ZOO, load_config, update_config_command, zoo
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.train.checkpoint import save_checkpoint
from pemp_tpu_torch.weights import from_jax_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = "hybrid_class_agnostic_end2end/model_58_4"
SPLIT = "coco_17_full"
EVAL = ["TEST.SCALE_FACTOR", "[1.0]", "TEST.FLIP_TEST", "True", "TEST.SPLIT", SPLIT,
        "MODEL.MPN.NODE_THRESHOLD", "0.3", "MODEL.PRETRAINED", "''"]


def zoo_options(name: str) -> list:
    """The ZOO delta ``name`` as KEY VALUE options."""
    out = []

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out.extend([f"{prefix}{k}", repr(v)])

    walk(ZOO[name], "")
    return out


@pytest.fixture(scope="module")
def fake_coco(tmp_path_factory):
    base = tmp_path_factory.mktemp("zoo_valid")
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


# (preset, grouping, head biases that make persons form at seeded weights)
CASES = {
    "tag": ("tag", "GAEC", {"node_classification": [1.0]}),
    "tag_threshold": ("tag", "threshold", {"node_classification": [1.0]}),
    "greedy": ("greedy", "greedy", {"node_classification": [1.0], "edge_classification": [1.0]}),
    "background": ("background", "GAEC", {"edge_classification": [0.2]}),
    "background_threshold": ("background", "threshold", {"edge_classification": [1.5]}),
    "group_based": ("group_based", "GAEC", {"edge_classification": [0.2]}),
}


def test_zoo_presets_are_model_58_4_with_the_options():
    for name in ZOO:
        assert zoo(name) == update_config_command(load_config(CONFIG), zoo_options(name))


class _Shared:
    """tools/valid.py's TTAPipeline replaced by the port pipeline's outputs
    (as numpy), for the grouping by tag."""

    outs = None

    def __init__(self, *args, **kwargs):
        pass

    def run_batched(self, images, batch_size=8):
        return [{k: v.numpy() if torch.is_tensor(v) else v for k, v in o.items()}
                for o in self.outs]


@pytest.mark.parametrize("case", list(CASES))
def test_zoo_valid_matches_tools_valid(fake_coco, monkeypatch, case):
    """Both entry points end to end on their own pipelines; the tag model's
    grouping (match_by_tag and refine round tag distances, where the
    backbones' float32 sums in another order, 1e-5 at these seeded
    weights, can cross a half-integer) runs in tools/valid.py on the port
    pipeline's outputs, which are first held against the JAX pipeline's:
    nodes and validity exactly, maps and tags within 1e-5 of their
    largest."""
    name, method, biases = CASES[case]
    base = fake_coco / case
    opts = (OVERRIDES + EVAL + zoo_options(name)
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
    mpn = variables["params"]["mpn"]
    for head, bias in biases.items():
        mpn[head]["lin2"]["bias"] = np.array(bias, np.float32)
    if name == "background":
        # the background class wins on some nodes
        mpn["classification"]["lin2"]["bias"][-1] = 0.3

    port_cfg = update_config_command(load_config(CONFIG), opts)
    model = build_pose_model(port_cfg, device="cpu", path="valid")
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"],
                                             port_cfg))
    save_checkpoint(str(base / "weights.pt"), model)
    if name == "tag":
        _hold_pipelines(fake_coco, port_cfg, model, jcfg, jmodel, variables, monkeypatch)

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

    valid.main(["--config", CONFIG, "--out_file", "eval.txt", "--device", "cpu", *opts,
                "MODEL.PRETRAINED", str(base / "weights.pt"), "LOG_DIR", str(base / "port")])
    got, want = _results(base / "port"), _results(base / "jax")
    assert len(got) == len(want) >= 2
    assert [a["image_id"] for a in got] == [a["image_id"] for a in want]
    np.testing.assert_allclose([a["keypoints"] for a in got], [a["keypoints"] for a in want],
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose([a["score"] for a in got], [a["score"] for a in want],
                               atol=1e-4, rtol=0)


def _hold_pipelines(fake_coco, port_cfg, model, jcfg, jmodel, variables, monkeypatch):
    """The port's and the JAX package's TTA pipelines on the set's images:
    the graph exactly, maps and per-node tags within 1e-5 of their largest,
    the edge scores of the edge-less model 0; then tools/valid.py is given
    the port's outputs."""
    import pemp_tpu.tta
    from pemp_tpu.tta import TTAPipeline as JaxTTAPipeline
    from pemp_tpu_torch.tta.multi_scale import TTAPipeline

    eval_set = valid.eval_set_for(port_cfg)
    images = [np.asarray(eval_set.load_raw(i)[3]) for i in range(len(eval_set.img_ids))]
    outs = TTAPipeline(model, port_cfg, with_decode=False).run_batched(images)
    jouts = JaxTTAPipeline(jmodel, variables, jcfg, with_decode=False).run_batched(images)
    for p, j in zip(outs, jouts):
        # no edge head: edge scores 0 on every slot (tests/test_tta.py:228)
        assert not p["edge_pred"].any() and not np.asarray(j["edge_pred"]).any()
        for key in ("nodes", "node_valid", "edge_index"):
            np.testing.assert_array_equal(p[key].numpy(), np.asarray(j[key]), err_msg=key)
        for key in ("tag_pred", "scoremaps", "tags", "detector_scores"):
            want = np.asarray(j[key])
            np.testing.assert_allclose(p[key].numpy(), want, atol=1e-5 * np.abs(want).max(),
                                       rtol=0, err_msg=key)
    _Shared.outs = outs
    monkeypatch.setattr(pemp_tpu.tta, "TTAPipeline", _Shared)
