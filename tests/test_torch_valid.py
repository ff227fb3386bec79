"""The eval entry point, port against JAX package: ``python -m
pemp_tpu_torch.valid`` against ``tools/valid.py`` on a 4-image set written
by tools/make_fake_coco.py, the narrow configuration given as KEY VALUE
pairs, scales [1.0, 0.5] with flip, threshold grouping on the device and
GAEC on the host. The same seeded weights reach JAX through its model's
``init`` and the port through a torch checkpoint. Also the checkpoint's
round trip and the entry point's refusals."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_tta import OVERRIDES, jax_setup

from pemp_tpu_torch import valid
from pemp_tpu_torch.config import load_config, update_config_command
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.train.checkpoint import load_checkpoint, load_params_only, save_checkpoint
from pemp_tpu_torch.train.optim import SplitAdamW
from pemp_tpu_torch.weights import from_jax_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPLIT = "coco_17_full"
TTA = ["TEST.SCALE_FACTOR", "[1.0,0.5]", "TEST.FLIP_TEST", "True", "TEST.SPLIT", SPLIT]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("valid")
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_fake_coco.py"), "--root",
                    str(base / "coco"), "--images", "4", "--size", "96"],
                   check=True, capture_output=True)
    opts = OVERRIDES + TTA + ["DATASET.ROOT", str(base / "coco")]
    # off a TPU the JAX package's "auto" is the einsum route
    jcfg, jmodel, variables = jax_setup(opts, msg_pass_kernel=False)
    port_cfg = update_config_command(load_config("hrnet/w48_640"), opts)
    model = build_pose_model(port_cfg, device="cpu", path="valid")
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"],
                                             port_cfg))
    save_checkpoint(str(base / "weights.pt"), model)
    return dict(base=base, opts=opts, jmodel=jmodel, variables=variables)


class _Seeded:
    """The JAX model, its ``init`` giving the seeded variables."""

    def __init__(self, model, variables):
        self._model, self._variables = model, variables

    def __getattr__(self, name):
        return getattr(self._model, name)

    def init(self, *args, **kwargs):
        return self._variables


def _run_jax(setup, monkeypatch, log_dir, method):
    import pemp_tpu.models

    monkeypatch.setattr(pemp_tpu.models, "build_pose_model",
                        lambda cfg: _Seeded(setup["jmodel"], setup["variables"]))
    monkeypatch.setenv("EVAL_FANOUT", "0")
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import valid as jax_valid

    monkeypatch.setattr(sys, "argv", [
        "valid.py", "--config", "hrnet/w48_640", "--out_file", "eval.txt",
        *setup["opts"], "MODEL.GC.CC_METHOD", method, "LOG_DIR", str(log_dir)])
    monkeypatch.chdir(ROOT)
    jax_valid.main()


def _results(log_dir):
    return json.loads((log_dir / f"person_keypoints_{SPLIT}_mpn_results.json").read_text())


@pytest.mark.parametrize("method", ["threshold", "GAEC"])
def test_valid_matches_tools_valid(setup, monkeypatch, method):
    base = setup["base"]
    _run_jax(setup, monkeypatch, base / f"jax_{method}", method)
    stats = valid.main([
        "--config", "hrnet/w48_640", "--out_file", "eval.txt", "--device", "cpu",
        "--msg-pass", "einsum", *setup["opts"], "MODEL.GC.CC_METHOD", method,
        "MODEL.PRETRAINED", str(base / "weights.pt"), "LOG_DIR", str(base / f"port_{method}")])
    got, want = _results(base / f"port_{method}"), _results(base / f"jax_{method}")
    assert len(got) == len(want) >= 4
    assert [a["image_id"] for a in got] == [a["image_id"] for a in want]
    np.testing.assert_allclose([a["keypoints"] for a in got], [a["keypoints"] for a in want],
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose([a["score"] for a in got], [a["score"] for a in want],
                               atol=1e-4, rtol=0)
    report = (base / f"port_{method}" / "eval.txt").read_text()
    assert report.split("Runtime")[0] == (
        base / f"jax_{method}" / "eval.txt").read_text().split("Runtime")[0]
    assert len(stats) == 10


def test_valid_warns_on_random_weights(setup, tmp_path):
    with pytest.warns(UserWarning, match="evaluating random weights"):
        valid.main(["--config", "hrnet/w48_640", "--out_file", "eval.txt", "--device", "cpu",
                    "--max-images", "1", *setup["opts"], "TEST.SCALE_FACTOR", "[1.0]",
                    "LOG_DIR", str(tmp_path)])
    assert "AP" in (tmp_path / "eval.txt").read_text()


@pytest.mark.parametrize("opts,match", [
    (["MODEL.GC.CC_METHOD", "spectral"], "MODEL.GC.CC_METHOD"),
    (["DATASET.SCALING_TYPE", "long"], "DATASET.SCALING_TYPE"),
    (["MODEL.MPN.NAME", "NodeClassificationMPNAttention"], "MPN zoo"),
])
def test_valid_refuses(opts, match):
    with pytest.raises(NotImplementedError, match=match):
        valid.main(["--config", "hrnet/w48_640", "--out_file", "x.txt", "--device", "cpu",
                    *OVERRIDES, *opts])


def test_checkpoint_round_trip(setup, tmp_path):
    """Outputs are the same bits after a reload; the optimizer's state,
    epoch and step come back; load_params_only reads model_state_dict,
    state_dict and plain files, and refuses a flax msgpack one."""
    import flax.serialization

    cfg = update_config_command(load_config("hrnet/w48_640"), setup["opts"])
    model = build_pose_model(cfg, device="cpu", path="valid")
    load_params_only(str(setup["base"] / "weights.pt"), model)
    imgs = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    train_cfg = load_config("hybrid_class_agnostic_end2end/model_58_4")
    opt = SplitAdamW(train_cfg, model)
    model.train()
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    save_checkpoint(str(tmp_path / "ckpt.pt"), model, opt, epoch=3, step=7)
    model.eval()
    want = model(imgs)[1]["preds"]
    for name, payload in (("full", None), ("state_dict", "state_dict"), ("plain", "")):
        fresh = build_pose_model(cfg, device="cpu", path="valid")
        path = tmp_path / "ckpt.pt"
        if payload is not None:
            path = tmp_path / f"{name}.pt"
            sd = model.state_dict()
            torch.save({payload: sd} if payload else sd, path)
        load_params_only(str(path), fresh)
        got = fresh(imgs)[1]["preds"]
        for key in ("edge", "node", "class"):
            assert torch.equal(got[key][-1], want[key][-1]), (name, key)
    fresh = build_pose_model(cfg, device="cpu", path="valid")
    opt2 = SplitAdamW(train_cfg, fresh)
    assert load_checkpoint(str(tmp_path / "ckpt.pt"), fresh, opt2) == (3, 7)
    assert opt2.count == 1
    a, b = opt.state_dict()["adamw"]["state"], opt2.state_dict()["adamw"]["state"]
    assert a.keys() == b.keys() and all(torch.equal(a[k]["exp_avg"], b[k]["exp_avg"]) for k in a)
    flax_file = tmp_path / "flax.ckpt"
    flax_file.write_bytes(flax.serialization.to_bytes(
        {"epoch": 0, "params": {"w": np.zeros(2)}, "batch_stats": {}, "opt_state": None,
         "step": 0}))
    with pytest.raises(ValueError, match="flax msgpack"):
        load_params_only(str(flax_file), fresh)
