"""The port's entry points: the presets (w48/640, model_58_4,
model_81_1_2, hg_512, w32/512), the per-path configuration checks, the
CUDA requirement and chip_smoke.py's refusal to run without a card."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from pemp_tpu.config import get_config as jax_get_config
from pemp_tpu.config import update_config as jax_update_config
from pemp_tpu_torch.config import (
    PRESETS,
    check_path,
    get_config,
    hg_512,
    load_config,
    model_81_1_2,
    small,
    small_train,
    update_config,
    w32_512,
    w32_512_train,
    w48_640,
)
from pemp_tpu_torch.config.defaults import FIXED, NOT_READ
from pemp_tpu_torch.losses.factories import dispatch_loss_func
from pemp_tpu_torch.graph.constructor import GCConfig
from pemp_tpu_torch.models.mpn.models import get_mpn_model
from pemp_tpu_torch.models.pose_estimation import build_pose_model, mpn_config
from pemp_tpu_torch.pipeline import build_pipeline
from pemp_tpu_torch.train.__main__ import main as train_main
from pemp_tpu_torch.train.train_step import build_trainer

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "configs"
W48_YAML = str(CONFIGS / "hrnet" / "w48_640.yaml")
M58_YAML = str(CONFIGS / "hybrid_class_agnostic_end2end" / "model_58_4.yaml")
# the config files of the repo whose settings a path of the port implements,
# besides the AE-grouping entry point, which runs the backbone of every file
# that loads, and the upper bounds (models.upper_bound, calc_upper_bounds),
# which run the graph of every file that loads: EVERY
# (w48_640's default loss, "edge_loss", trains the edge head alone; the
# upper_bound files run the upper bounds and the backbone alone)
EVERY = {"valid_hr", "upper_bound"}
LOADS = {"hrnet/w48_640.yaml": {"eval", "valid", "train"},
         "hybrid_class_agnostic_end2end/model_58_4.yaml": {"train", "valid"},
         "crowdpose/model_81_1_2.yaml": {"train", "valid"},
         "test/tiny.yaml": {"train", "valid"},
         "upper_bound/hg.yaml": {"upper_bound"},
         "upper_bound/hrnet.yaml": {"upper_bound"},
         "upper_bound/mmpose_hrnet.yaml": {"upper_bound"}}


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


def test_model_58_4_preset_matches_yaml():
    """The same for the training preset, and its small cut keeps every key
    but the sizes."""
    got = w32_512_train().to_dict()
    assert got == _project(jax_update_config(jax_get_config(), M58_YAML).to_dict(), got)
    assert update_config(get_config(), M58_YAML).to_dict() == got
    small_cfg = small_train()
    assert small_cfg.MODEL.LOSS == w32_512_train().MODEL.LOSS
    assert small_cfg.TRAIN.KP_FREEZE_MODE == "nothing" and small_cfg.DATASET.INPUT_SIZE == 64


@pytest.mark.parametrize("name", ["crowdpose/model_81_1_2", "hourglass/hg_512",
                                  "hrnet/w32_512"])
def test_backbone_presets_match_yaml(name):
    """The presets of the other two backbones and the AE-grouping entry
    point are their files, as the JAX package and the port's loader read
    them; load_config resolves each name to its preset."""
    got = PRESETS[name]().to_dict()
    path = str(CONFIGS / f"{name}.yaml")
    assert got == _project(jax_update_config(jax_get_config(), path).to_dict(), got)
    assert update_config(get_config(), path).to_dict() == got
    assert load_config(name).to_dict() == got


def test_long_scaling_is_accepted_on_valid_and_valid_hr():
    """Long-side scaling runs on both eval entry points at input size 512
    (the reference's reverse map is fixed there) and is refused elsewhere."""
    for preset in (hg_512, w32_512_train, model_81_1_2):
        cfg = preset()
        cfg.DATASET.SCALING_TYPE, cfg.TEST.PROJECT2IMAGE = "long", False
        check_path(cfg, "valid_hr")
        if preset is not hg_512:
            check_path(cfg, "valid")
        cfg.DATASET.INPUT_SIZE = 640
        for path in ("valid", "valid_hr"):
            with pytest.raises(NotImplementedError, match="DATASET.SCALING_TYPE"):
                check_path(cfg, path)
    cfg = w32_512()
    check_path(cfg, "valid_hr")
    cfg.TPU.S2D_DECONV = 1
    with pytest.raises(NotImplementedError, match="TPU.S2D_DECONV"):
        check_path(cfg, "valid_hr")


def test_vanilla_mpn_is_refused_at_model_build():
    """hg_512 and w32_512 name no MPN, so the tree's VanillaMPN stands
    without embedding sizes: the composite model raises the missing key at
    build, as the JAX package raises it at its first call (their path
    checks pass: they run on valid_hr)."""
    for preset in (hg_512, w32_512):
        cfg = preset()
        check_path(cfg, "valid")
        with pytest.raises(KeyError, match="OUTPUT_SIZES"):
            build_pose_model(cfg, device="cpu", path="valid")


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


def _paths(cfg) -> set:
    """The paths of the port that run ``cfg``: its checks, its MPN built
    (but on the AE-grouping entry point, which runs the backbone alone,
    and the upper bounds, which run no MPN; a delta file loaded alone
    leaves VanillaMPN without its sizes, a KeyError) and, for training,
    the loss."""
    ok = set()
    mpn = mpn_config(cfg, GCConfig.from_config(cfg))
    for path in ("eval", "valid", "valid_hr", "train", "upper_bound"):
        try:
            check_path(cfg, path)
            if path not in ("valid_hr", "upper_bound"):
                get_mpn_model(mpn)
            if path == "train":
                dispatch_loss_func(cfg)
        except (NotImplementedError, KeyError):
            continue
        ok.add(path)
    return ok


@pytest.mark.parametrize(
    "path", sorted(CONFIGS.rglob("*.yaml")), ids=lambda p: str(p.relative_to(CONFIGS))
)
def test_repo_yaml_loads_or_is_refused(path):
    """A config file is refused by the loader for asking what no path
    implements, or loads with the values the JAX package reads from it;
    then each path of the port refuses it unless it is one that path runs."""
    name = str(path.relative_to(CONFIGS))
    try:
        cfg = update_config(get_config(), str(path))
    except NotImplementedError as e:
        assert name not in LOADS and "the port implements only" in str(e)
        return
    got = cfg.to_dict()
    assert got == _project(jax_update_config(jax_get_config(), str(path)).to_dict(), got)
    assert _paths(cfg) == LOADS.get(name, set()) | EVERY


@pytest.mark.parametrize("text,error", [
    ("TPU: {MSG_PASS: dots_x}", NotImplementedError),
    ("TPU: {S2D_DECONV: 1}", NotImplementedError),
    ("TEST: {FLIP_TEST: true}", NotImplementedError),
    ("MODEL: {GC: {DETECT_THRESHOLDS: 0.1}}", KeyError),
    ("MODEL: {HRNET: {NUM_JOINTS: seventeen}}", ValueError),
    ("MODEL: {GC: {CC_METHOD: greedy}}", NotImplementedError),
])
def test_config_refuses_what_the_port_does_not_do(tmp_path, text, error):
    """Refused when the file loads (a value no path implements, an unknown
    key, a wrong type) or, for eval-only settings, by the eval path."""
    path = tmp_path / "c.yaml"
    path.write_text(text)
    with pytest.raises(error):
        check_path(update_config(get_config(), str(path)), "eval")


@pytest.mark.parametrize("key,value", [
    ("MODEL.GC.CC_METHOD", "spectral"),
    ("TPU.S2D_DECONV", 1),
])
def test_valid_path_refuses_what_it_does_not_do(key, value):
    """The eval entry point takes any scales, flip, grouping by threshold,
    GAEC, KL, MUT or greedily and a checkpoint, and refuses a grouping
    neither package has (the JAX package's multicut library raises on a
    method it does not know) and the space-to-depth deconvolution."""
    for name, preset in (("w48_640", w48_640), ("model_58_4", w32_512_train)):
        cfg = preset()
        check_path(cfg, "valid")
        cfg.TEST.FLIP_TEST, cfg.TEST.SCALE_FACTOR = True, [2.0, 1.0, 0.5]
        for method in ("threshold", "GAEC", "KL", "MUT", "greedy"):
            cfg.MODEL.GC.CC_METHOD = method
            check_path(cfg, "valid")
        *parents, leaf = key.split(".")
        node = cfg
        for part in parents:
            node = node[part]
        node[leaf] = value
        with pytest.raises(NotImplementedError, match=key):
            check_path(cfg, "valid")


@pytest.mark.parametrize("msg_pass,path,runs", [
    ("hybrid", "eval", True),
    ("einsum", "eval", True),
    ("hybrid", "train", True),
    ("einsum", "train", True),
    ("pallas", "eval", True),
    ("dots", "eval", True),
    ("dots", "train", True),
    ("fused_step", "train", True),
])
def test_reverse_permutation_routes(tmp_path, msg_pass, path, runs):
    """Every route loads from a file and runs on both paths: eval and
    training take all five, fused_step training through K2b, K1b and G1."""
    file = tmp_path / "c.yaml"
    file.write_text(f"TPU: {{MSG_PASS: {msg_pass}}}\n")
    cfg = update_config(w48_640() if path == "eval" else w32_512_train(), str(file))
    assert cfg.TPU.MSG_PASS == msg_pass
    assert runs
    check_path(cfg, path)


def test_config_drops_what_eval_does_not_read(tmp_path):
    """Keys no path reads are dropped; keys a path reads are kept, and each
    path checks its own (eval here: MSG_PASS fused_step, CC_METHOD GAEC)."""
    path = tmp_path / "c.yaml"
    path.write_text("TRAIN: {LR: 0.1, END_EPOCH: 3}\nTEST: {FLIP_TEST: false, SCORING: mean}\n"
                    "TPU: {KNN_K: 20, MSG_PASS: fused_step, COMPUTE_DTYPE: float32}\n"
                    "MODEL: {GC: {CC_METHOD: GAEC, CHEAT: true}}\n")
    cfg = update_config(get_config(), str(path))
    want = get_config()
    want.TPU.KNN_K = 20
    want.TRAIN.LR = 0.1
    want.TRAIN.END_EPOCH = 3
    want.TEST.FLIP_TEST = False
    want.TEST.SCORING = "mean"
    want.TPU.MSG_PASS = "fused_step"
    assert cfg == want
    with pytest.raises(KeyError):
        cfg.TPU.COMPUTE_DTYPE = "float32"
    with pytest.raises(NotImplementedError, match="MODEL.GC.CC_METHOD"):
        check_path(cfg, "eval")
    # the training path takes MSG_PASS fused_step too
    check_path(_with(w32_512_train(), "fused_step"), "train")


def _with(cfg, msg_pass):
    cfg.TPU.MSG_PASS = msg_pass
    return cfg


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pose_model(small())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pipeline(2, cfg=small())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_trainer(small_train())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["hybrid_class_agnostic_end2end/model_58_4", "--synthetic", "--epochs", "1",
                    "--steps-per-epoch", "1"])


def test_builders_check_their_path():
    """The eval builder refuses the training configuration (a checkpoint
    path, GAEC grouping), and the trainer a loss list neither package
    dispatches (the class loss with the heatmaps, and no node loss)."""
    with pytest.raises(NotImplementedError, match="MODEL.PRETRAINED"):
        build_pose_model(w32_512_train(), device="cpu")
    cfg = small()
    cfg.MODEL.LOSS.NAME = ["heatmap", "class"]
    with pytest.raises(NotImplementedError, match="MODEL.LOSS.NAME"):
        build_trainer(cfg, device="cpu")


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "torch.cuda.is_available() is false" in out.stderr
