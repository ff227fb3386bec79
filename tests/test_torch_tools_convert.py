"""``python -m pemp_tpu_torch.convert_checkpoint`` against
``tools/convert_checkpoint.py``: a narrow HigherHRNet ``.pth`` made from
seeded weights in the published key layout (the reference's names, which
the port's backbone carries), under each of the four rename schemes and in
mmpose's names, converted by both tools; the port's backbone equals the
JAX msgpack's carried across (``weights.from_jax_variables``) bit for bit,
and the ``.pth``'s; a missing key raises by name in both. The converted
checkpoint then runs ``valid`` through ``MODEL.PRETRAINED`` and a ``train``
step through ``TRAIN.CONTINUE ... TRAIN.FINETUNE True``, on the CPU."""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import _seeded_variables
from test_torch_tta import OVERRIDES
from test_torch_valid import _Seeded

from pemp_tpu.config import get_config as jax_get_config
from pemp_tpu.config import update_config as jax_update_config
from pemp_tpu.config import update_config_command as jax_update_config_command
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.train.checkpoint import load_params_only as jax_load_params_only
from pemp_tpu_torch import convert_checkpoint, make_fake_coco, valid
from pemp_tpu_torch.config import load_config, update_config_command
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.train.__main__ import main as train_main
from pemp_tpu_torch.weights import from_jax_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = "hybrid_class_agnostic_end2end/model_58_4"
OPTS = OVERRIDES + ["TRAIN.BATCH_SIZE", "2", "MODEL.PRETRAINED", ""]
PREFIX = {"plain": "", "strip1": "module.", "strip2": "model.module.",
          "strip_prefix2char": "1."}
HEADS = ("final_layers.", "deconv_layers.")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The published-layout weights (seeded, BatchNorm statistics drawn),
    and the JAX model with seeded variables for the tool's template."""
    base = tmp_path_factory.mktemp("convert")
    cfg = update_config_command(load_config(CONFIG), OPTS)
    model = build_pose_model(cfg, device="cpu", path="valid")
    gen = torch.Generator().manual_seed(5)

    def draw(name, v):
        if not v.is_floating_point():
            return v
        r = torch.rand(v.shape, generator=gen)
        if name.endswith("running_var") or (v.dim() == 1 and name.endswith("weight")):
            return 0.5 + r                          # BatchNorm scale and variance
        if v.dim() == 1:
            return (r - 0.5) * 0.2                  # biases and means
        return torch.randn(v.shape, generator=gen) / v[0].numel() ** 0.5

    published = {k: draw(k, v) for k, v in model.backbone.state_dict().items()}
    jcfg = jax_update_config_command(
        jax_update_config(jax_get_config(), f"configs/{CONFIG}.yaml"), OPTS)
    jmodel = jax_build_pose_model(jcfg)
    size = jcfg.DATASET.INPUT_SIZE
    variables = _seeded_variables(jmodel, jnp.zeros((1, size, size, 3)),
                                  np.random.RandomState(0))
    return dict(base=base, cfg=cfg, published=published, jmodel=jmodel, variables=variables)


def _write_pth(setup, path, scheme, mmpose=False, drop=None):
    sd = dict(setup["published"])
    if drop:
        del sd[drop]
    if mmpose:
        sd = {("keypoint_head." if k.startswith(HEADS) else "backbone.") + k: v
              for k, v in sd.items()}
    sd["unread.weight"] = torch.ones(3)          # entries the backbone does not read
    sd = {PREFIX[scheme] + k: v for k, v in sd.items()}
    wrap = {"plain": lambda d: {"state_dict": d}, "strip1": lambda d: {"model_state_dict": d},
            "strip2": lambda d: d, "strip_prefix2char": lambda d: {"epoch": 3, "state_dict": d}}
    torch.save(wrap[scheme](sd), path)


def _run_jax(setup, monkeypatch, pth, out, scheme, mmpose):
    import pemp_tpu.models

    monkeypatch.setattr(pemp_tpu.models, "build_pose_model",
                        lambda cfg: _Seeded(setup["jmodel"], setup["variables"]))
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import convert_checkpoint as jax_tool

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, "argv", [
        "convert_checkpoint.py", "--config", CONFIG, "--pth", str(pth), "--out", str(out),
        "--scheme", scheme, *(["--mmpose"] if mmpose else []), *OPTS])
    jax_tool.main()


@pytest.mark.parametrize("scheme,mmpose", [(s, False) for s in PREFIX] + [("plain", True),
                                                                          ("strip1", True)])
def test_convert_matches_tools(setup, monkeypatch, capsys, scheme, mmpose):
    base = setup["base"] / f"{scheme}_{mmpose}"
    base.mkdir()
    pth = base / "published.pth"
    _write_pth(setup, pth, scheme, mmpose)
    _run_jax(setup, monkeypatch, pth, base / "jax.ckpt", scheme, mmpose)
    model = convert_checkpoint.main(["--config", CONFIG, "--pth", str(pth), "--out",
                                     str(base / "port.ckpt"), "--scheme", scheme,
                                     *(["--mmpose"] if mmpose else []), "--device", "cpu",
                                     *OPTS])
    want_line, got_line = capsys.readouterr().out.strip().splitlines()[-2:]
    assert got_line == want_line.replace("jax.ckpt", "port.ckpt")

    variables = setup["variables"]
    params, stats = jax_load_params_only(str(base / "jax.ckpt"), variables["params"],
                                         variables["batch_stats"])
    carried = from_jax_variables(params, stats, setup["cfg"])
    saved = torch.load(base / "port.ckpt", weights_only=True)
    assert saved["epoch"] == 0
    sd = saved["model_state_dict"]
    n = 0
    for k, v in setup["published"].items():
        key = f"backbone.{k}"
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(sd[key], v), key
        assert torch.equal(sd[key], carried[key]), key
        assert torch.equal(model.state_dict()[key], v), key
        n += 1
    assert n > 100


def test_missing_key_raises_by_name(setup, monkeypatch):
    name = "stage3.0.branches.1.0.conv2.weight"
    pth = setup["base"] / "missing.pth"
    _write_pth(setup, pth, "plain", drop=name)
    with pytest.raises(KeyError, match=name.replace(".", r"\.")):
        _run_jax(setup, monkeypatch, pth, setup["base"] / "missing_jax.ckpt", "plain", False)
    with pytest.raises(KeyError, match=name.replace(".", r"\.")):
        convert_checkpoint.main(["--config", CONFIG, "--pth", str(pth), "--out",
                                 str(setup["base"] / "missing.ckpt"), "--device", "cpu", *OPTS])


def test_converted_checkpoint_runs_valid_and_train(setup, tmp_path):
    """valid takes it through MODEL.PRETRAINED (and says so), train takes a
    step from it through TRAIN.CONTINUE + TRAIN.FINETUNE (epoch 0 of the
    config, not the checkpoint's)."""
    pth = tmp_path / "published.pth"
    _write_pth(setup, pth, "plain")
    ckpt = tmp_path / "converted.ckpt"
    convert_checkpoint.main(["--config", CONFIG, "--pth", str(pth), "--out", str(ckpt),
                             "--device", "cpu", *OPTS])
    root = tmp_path / "coco"
    make_fake_coco.make_fake_coco(str(root), images=1, size=96)
    stats = valid.main(["--config", CONFIG, "--out_file", "e.txt", "--device", "cpu",
                        *OPTS[:-2], "MODEL.PRETRAINED", str(ckpt), "DATASET.ROOT", str(root),
                        "TEST.SPLIT", "coco_17_full", "MODEL.GC.CC_METHOD", "threshold",
                        "LOG_DIR", str(tmp_path / "eval")])
    assert len(stats) == 10 and (tmp_path / "eval" / "e.txt").exists()
    rc = train_main([CONFIG, "--synthetic", "--epochs", "1", "--steps-per-epoch", "1",
                     "--device", "cpu", *OPTS, "TRAIN.CONTINUE", str(ckpt),
                     "TRAIN.FINETUNE", "True", "LOG_DIR", str(tmp_path / "train")])
    assert rc == 0
    after = torch.load(tmp_path / "train" / "pose_estimation.ckpt", weights_only=True)
    assert after["epoch"] == 0 and after["step"] == 1
    moved = after["model_state_dict"]["backbone.conv1.weight"]
    assert not torch.equal(moved, setup["published"]["conv1.weight"])
    assert torch.allclose(moved, setup["published"]["conv1.weight"], atol=1e-3)
