"""The training entry point, port against the JAX package at the small
model_58_4 cut (narrow HigherHRNet at 64x64, batch 2, K = 8, 3 MPN steps,
``pallas`` with the typed message kernel in interpret mode on the JAX
side): ``train()`` over two epochs of a COCO-format set written with PIL,
its per-step losses against ``make_train_step`` on the same batches and
weights (5e-3), checkpoints, snapshot, metrics, resume and finetune; the
abort after five non-finite steps, ``--synthetic`` through the CLI,
``make_coco_loaders`` against tools/train.py's, and the training path's
refusals.
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import _seeded_variables
from test_torch_train_data import _assert_same, write_coco_set
from test_torch_train_opened import jax_config, jax_model

from pemp_tpu.losses import dispatch_loss_func as jax_dispatch_loss_func
from pemp_tpu.train import TrainState, build_optimizer, make_eval_step, make_train_step
from pemp_tpu_torch.config import check_path, small_train
from pemp_tpu_torch.data import datasets, targets, transforms
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.train.__main__ import main as train_main
from pemp_tpu_torch.train.__main__ import make_coco_loaders, train
from pemp_tpu_torch.train.checkpoint import load_params_only
from pemp_tpu_torch.train.optim import multistep_lr
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
from pemp_tpu_torch.weights import from_jax_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent


# ------------------------------------------------------------------ train()


class Recording:
    """A loader that keeps a copy of each batch it yields."""

    def __init__(self, loader):
        self.loader, self.seen = loader, []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for b in self.loader:
            self.seen.append(jax.tree_util.tree_map(np.copy, b))
            yield b


def _small_loaders(cfg, root):
    """The written set's training and validation loaders at the small
    sizes (sigma 1: the default size / 64 splats from 64 up only)."""
    nj, mp = cfg.DATASET.NUM_JOINTS, cfg.DATASET.MAX_NUM_PEOPLE
    outs = list(cfg.DATASET.OUTPUT_SIZE)
    kw = dict(transforms=transforms.transforms_hr_train(cfg, rng=np.random.RandomState(0)),
              heatmap_generator=[targets.HeatmapGenerator(s, nj, sigma=1) for s in outs],
              joint_generator=[targets.JointsGenerator(mp, nj, s, True) for s in outs])
    bs = cfg.TRAIN.BATCH_SIZE
    return (Recording(datasets.DataLoader(datasets.CocoKeypoints(root, mode="train", **kw),
                                          bs, shuffle=True)),
            datasets.DataLoader(datasets.CocoKeypoints(root, mode="val", **kw), bs))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train() for 2 epochs of 2 steps from the JAX seeded weights (loaded
    by FINETUNE), with LR_STEP [1] over a 2-step schedule, then the JAX
    train step on the batches train() saw."""
    base = tmp_path_factory.mktemp("train")
    root = write_coco_set(base / "coco", [("train", 4), ("val", 2)])
    cfg = small_train()
    cfg.merge_from_other({"PRINT_FREQ": 1, "WORKERS": 0, "MODEL": {"PRETRAINED": ""},
                          "TRAIN": {"LR_STEP": [1]}})
    jcfg = jax_config(cfg)
    jmodel = jax_model(jcfg)
    rng = np.random.RandomState(0)
    variables = _seeded_variables(jmodel, jnp.zeros((2, 64, 64, 3), jnp.float32), rng)
    init = base / "init.pt"
    torch.save(from_jax_variables(variables["params"], variables["batch_stats"], cfg), init)
    cfg.TRAIN.CONTINUE, cfg.TRAIN.FINETUNE = str(init), True
    loader, val_loader = _small_loaders(cfg, root)
    log_dir = base / "log"
    summary = train(cfg, loader, val_loader, str(log_dir), schedule_steps=2, epochs=2,
                    device="cpu")

    loss_factory = jax_dispatch_loss_func(jcfg)
    tx, _ = build_optimizer(jcfg, variables["params"], 2)
    step = jax.jit(make_train_step(jmodel, loss_factory, tx, jcfg))
    state = TrainState(variables["params"], variables["batch_stats"],
                       tx.init(variables["params"]), jnp.int32(0), jnp.int32(0))
    losses, val = [], None
    eval_step = jax.jit(make_eval_step(jmodel, loss_factory, jcfg))
    for i, batch in enumerate(loader.seen):
        state, loss, _ = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
        losses.append(float(loss))
        if i == 1:      # after epoch 0: its validation loss
            val = float(np.mean([float(eval_step(state.params, state.batch_stats,
                                                 jax.tree_util.tree_map(jnp.asarray, vb))[0])
                                 for vb in val_loader]))
    return dict(cfg=cfg, root=root, log_dir=log_dir, summary=summary, jax_losses=losses,
                jax_val=val)


def test_train_losses_match_make_train_step(trained):
    """Per-step losses within 5e-3 of the JAX train step's on the same
    batches and weights (Adam's first updates move each weight by about
    the learning rate whatever its gradient, so the steps after the first
    drift apart by a little); the first validation loss too."""
    s = trained["summary"]
    assert len(s["losses"]) == 4 and s["start_epoch"] == 0 and not s["aborted"]
    np.testing.assert_allclose(s["losses"], trained["jax_losses"], rtol=5e-3)
    np.testing.assert_allclose(s["losses"][0], trained["jax_losses"][0], rtol=1e-4)
    np.testing.assert_allclose(s["val_losses"][0], trained["jax_val"], rtol=5e-3)
    assert s["fail_count"] == 0 and len(s["epochs"]) == 2


def test_train_writes_checkpoints_and_metrics(trained):
    """The epoch checkpoint (epoch 1, 4 steps, the optimizer's 4 updates),
    the snapshot before the learning-rate step (epoch 0), and metrics.jsonl
    with the loss parts at every step (PRINT_FREQ 1) and the validation
    loss at every epoch."""
    log_dir = trained["log_dir"]
    ckpt = torch.load(log_dir / "pose_estimation.ckpt", weights_only=True)
    assert ckpt["epoch"] == 1 and ckpt["step"] == 4
    assert ckpt["optimizer_state_dict"]["count"] == 4
    snap = torch.load(log_dir / "pose_estimation.ckpt.epoch0", weights_only=True)
    assert snap["epoch"] == 0 and snap["optimizer_state_dict"]["count"] == 2
    records = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    parts = [r for r in records if r["tag"] == "Loss/parts"]
    assert [r["iter"] for r in parts] == [0, 1, 2, 3]
    assert {"heatmap", "node", "edge", "class_loss", "tag_loss", "loss"} <= set(parts[0])
    assert [r["iter"] for r in records if r["tag"] == "Loss/valid"] == [0, 1]


def test_train_resumes_and_finetunes(trained):
    """CONTINUE restores model, optimizer and epoch and runs again from the
    saved epoch (tools/train.py's range(start_epoch, end_epoch)), its first
    update at the restored count's learning rate; FINETUNE from the
    snapshot takes the weights only: a fresh optimizer, epochs from
    START_EPOCH."""
    cfg = trained["cfg"].clone()
    log_dir = trained["log_dir"]
    firsts = []

    def first_step(trainer, it, loss, logging):
        if len(firsts) < runs:
            opt = trainer.optimizer
            firsts.append((it, opt.count, [g["lr"] for g in opt.opt.param_groups]))

    loader, _ = _small_loaders(cfg, trained["root"])
    cfg.TRAIN.CONTINUE, cfg.TRAIN.FINETUNE = str(log_dir / "pose_estimation.ckpt"), False
    runs = 1
    summary = train(cfg, loader, None, str(log_dir.parent / "resumed"), schedule_steps=2,
                    epochs=3, device="cpu", on_step=first_step)
    assert summary["start_epoch"] == 1 and len(summary["epochs"]) == 2
    it, count, lrs = firsts[0]
    assert it == 2 and count == 5           # the restored 4 updates, then this one
    np.testing.assert_allclose(lrs, [multistep_lr(cfg.TRAIN.LR, [1], 0.1, 2, 4),
                                     multistep_lr(cfg.TRAIN.KP_LR, [1], 0.1, 2, 4)], rtol=1e-12)
    assert summary["steps"] == 8

    snapshot = log_dir / "pose_estimation.ckpt.epoch0"
    cfg.TRAIN.CONTINUE, cfg.TRAIN.FINETUNE = str(snapshot), True
    runs = 2
    model = build_trainer(cfg, device="cpu", seed=5).model
    load_params_only(str(snapshot), model)
    summary = train(cfg, loader, None, str(log_dir.parent / "finetuned"), schedule_steps=2,
                    epochs=1, device="cpu", on_step=first_step)
    assert summary["start_epoch"] == 0 and firsts[1][:2] == (0, 1)
    assert summary["steps"] == 2
    # the first step started from the snapshot's weights: the same loss as
    # a model given them directly
    want = build_trainer(cfg, device="cpu", model=model)
    batch = batch_to_torch(loader.seen[-2], "cpu")
    np.testing.assert_allclose(summary["losses"][0], float(want.loss(batch)[0].detach()),
                               rtol=1e-6)


def test_five_non_finite_steps_abort(tmp_path):
    """NaN images make every step non-finite; with PRINT_FREQ 1 training
    stops after the fifth skipped step, the epoch's checkpoint still
    written, and no later epoch runs."""
    cfg = small_train()
    cfg.merge_from_other({"PRINT_FREQ": 1, "MODEL": {"PRETRAINED": ""}})
    rng = np.random.RandomState(0)
    batch = make_batch(rng, 2, 64, (16, 32), 17, 30, scale_range=(0.4, 0.9))
    batch["imgs"][:] = np.nan
    summary = train(cfg, [batch] * 7, None, str(tmp_path), epochs=2, device="cpu")
    assert summary["aborted"] and summary["fail_count"] == 5
    assert len(summary["losses"]) == 5 and len(summary["epochs"]) == 1
    assert (tmp_path / "pose_estimation.ckpt").exists()


def test_synthetic_cli_trains(tmp_path, capsys):
    """python -m pemp_tpu_torch.train ... --synthetic --epochs 1
    --steps-per-epoch 2 --device cpu at a small input."""
    rc = train_main([
        "hybrid_class_agnostic_end2end/model_58_4", "--synthetic", "--epochs", "1",
        "--steps-per-epoch", "2", "--device", "cpu", "DATASET.INPUT_SIZE", "64",
        "DATASET.OUTPUT_SIZE", "[16, 32]", "TRAIN.BATCH_SIZE", "2", "TPU.NODES_PER_TYPE", "8",
        "MODEL.MPN.STEPS", "2", "PRINT_FREQ", "1", "MODEL.PRETRAINED", "",
        "LOG_DIR", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "Iter: 1, loss:" in out and "skipped steps 0" in out
    assert (tmp_path / "pose_estimation.ckpt").exists()


def test_make_coco_loaders_matches_tools_train(tmp_path, monkeypatch):
    """make_coco_loaders against tools/train.py's on a written set (the
    default sigma at outputs 64 and 128; both augment from the global
    np.random, seeded alike): the training and validation batches equal."""
    root = write_coco_set(tmp_path / "coco", [("train", 4), ("val", 2)])
    monkeypatch.chdir(tmp_path)        # the JAX set caches its usable ids under ./tmp
    spec = importlib.util.spec_from_file_location("tools_train", ROOT / "tools" / "train.py")
    tools_train = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools_train)
    cfg = small_train()
    cfg.merge_from_other({"WORKERS": 0, "DATASET": {"ROOT": root, "INPUT_SIZE": 128,
                                                    "OUTPUT_SIZE": [64, 128]}})
    jcfg = jax_config(cfg)
    got, want = [], []
    for make, c, out in ((make_coco_loaders, cfg, got), (tools_train.make_coco_loaders, jcfg,
                                                          want)):
        np.random.seed(0)
        loader, val_loader = make(c)
        out.append((len(loader), list(loader), list(val_loader)))
    assert got[0][0] == 2 and len(got[0][2]) == 1
    _assert_same(got, want, "loaders")


@pytest.mark.parametrize("key,value,runs", [
    ("MODEL.GC.EDGE_LABEL_METHOD", 1, True),
    ("MODEL.GC.EDGE_LABEL_METHOD", 2, True),
    ("MODEL.GC.EDGE_LABEL_METHOD", 7, True),
    ("MODEL.GC.WITH_BACKGROUND", True, True),
    ("MODEL.GC.IMAGE_CENTRIC_SAMPLING", True, False),
    ("MODEL.GC.WEIGHT_CLASS_LOSS", True, True),
    ("MODEL.GC.NODE_DROPOUT", 0.1, False),
    ("MODEL.GC.EDGE_LABEL_METHOD", 3, True),
    ("MODEL.GC.EDGE_LABEL_METHOD", 5, True),
    ("MODEL.GC.USE_NEIGHBOURS", True, True),
    ("TRAIN.FREEZE_BN", False, True),
    ("TRAIN.WITH_AE_LOSS", [True, True], True),
    ("TPU.MATCHER", "greedy", True),
])
def test_training_path_opens_and_refuses(key, value, runs):
    cfg = small_train()
    *parents, leaf = key.split(".")
    node = cfg
    for part in parents:
        node = node[part]
    node[leaf] = value
    if runs:
        check_path(cfg, "train")
    else:
        with pytest.raises(NotImplementedError, match=key):
            check_path(cfg, "train")
