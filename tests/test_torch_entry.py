"""The port's entry points: the w48/640 preset, the CUDA requirement and
chip_smoke.py's refusal to run without a card."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from pemp_tpu.config import get_config as jax_get_config
from pemp_tpu.config import update_config as jax_update_config
from pemp_tpu_torch.config import get_config, small, update_config, w48_640
from pemp_tpu_torch.config.defaults import FIXED, NOT_READ
from pemp_tpu_torch.models.mpn.models import _check_fused_path, mpn_cfg_from_config
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.pipeline import build_pipeline

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "configs"
W48_YAML = str(CONFIGS / "hrnet" / "w48_640.yaml")
# the only config file of the repo whose settings the slice implements
LOADS = {"hrnet/w48_640.yaml"}


def _project(full: dict, like: dict) -> dict:
    """``full`` cut to the keys of ``like``."""
    return {k: _project(full[k], v) if isinstance(v, dict) else full[k]
            for k, v in like.items()}


def test_w48_preset_matches_yaml():
    """The PyYAML-free preset is the YAML file, on every key the port
    reads, as the JAX package and the port's own loader read it."""
    got = w48_640().to_dict()
    assert got == _project(jax_update_config(jax_get_config(), W48_YAML).to_dict(), got)
    assert update_config(get_config(), W48_YAML).to_dict() == got


def _jax_keys(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        key = prefix + k
        if isinstance(v, dict) and key != "MODEL.MPN":
            yield from _jax_keys(v, key + ".")
        else:
            yield key


def _lookup(tree: dict, key: str):
    for part in key.split("."):
        tree = tree[part]
    return tree


def test_every_jax_key_is_read_fixed_or_not_read():
    """Each key of the JAX package's tree (so each key of any YAML file it
    loads, outside the open MPN subtree) is one the port reads, one it
    fixes or one it drops; FIXED and NOT_READ name only real keys."""
    jax_tree = jax_get_config().to_dict()
    port = get_config().to_dict()
    skip = FIXED.keys() | NOT_READ
    for key in _jax_keys(jax_tree):
        if not any(key == s or key.startswith(s + ".") for s in skip):
            _lookup(port, key)
    for key in skip:
        _lookup(jax_tree, key)


@pytest.mark.parametrize(
    "path", sorted(CONFIGS.rglob("*.yaml")), ids=lambda p: str(p.relative_to(CONFIGS))
)
def test_repo_yaml_loads_or_is_refused(path):
    """A config file is refused by the loader for asking what the slice
    does not implement, or loads with the values the JAX package reads from
    it; then the MPN refuses it unless it is one the slice runs."""
    name = str(path.relative_to(CONFIGS))
    try:
        cfg = update_config(get_config(), str(path))
    except NotImplementedError as e:
        assert name not in LOADS and "the port implements only" in str(e)
        return
    got = cfg.to_dict()
    assert got == _project(jax_update_config(jax_get_config(), str(path)).to_dict(), got)
    mpn = {**mpn_cfg_from_config(cfg.MODEL.MPN), "_BLOCKED_C": 80, "_NODES_PER_TYPE": 40}
    if name in LOADS:
        _check_fused_path(mpn)
    else:
        with pytest.raises(NotImplementedError, match="only the fused-step flagship path"):
            _check_fused_path(mpn)


@pytest.mark.parametrize("text,error", [
    ("TPU: {MSG_PASS: hybrid}", NotImplementedError),
    ("TPU: {S2D_DECONV: 1}", NotImplementedError),
    ("TEST: {FLIP_TEST: true}", NotImplementedError),
    ("MODEL: {GC: {DETECT_THRESHOLDS: 0.1}}", KeyError),
    ("MODEL: {HRNET: {NUM_JOINTS: seventeen}}", ValueError),
])
def test_config_refuses_what_the_port_does_not_do(tmp_path, text, error):
    path = tmp_path / "c.yaml"
    path.write_text(text)
    with pytest.raises(error):
        update_config(get_config(), str(path))


def test_config_drops_what_eval_does_not_read(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("TRAIN: {LR: 0.1}\nTEST: {FLIP_TEST: false, SCORING: mean}\n"
                    "TPU: {KNN_K: 20, MSG_PASS: fused_step}\n")
    cfg = update_config(get_config(), str(path))
    want = get_config()
    want.TPU.KNN_K = 20
    assert cfg == want
    with pytest.raises(KeyError):
        cfg.TPU.MSG_PASS = "hybrid"


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pose_model(small())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pipeline(2, cfg=small())


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "torch.cuda.is_available() is false" in out.stderr
