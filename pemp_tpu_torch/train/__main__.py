"""Trains a pose model: the training entry point.

    python -m pemp_tpu_torch.train hybrid_class_agnostic_end2end/model_58_4 \
        [--synthetic] [--epochs N] [--steps-per-epoch N] [--device cpu] \
        [--seed 0] [--msg-pass ROUTE] [KEY VALUE ...]

The counterpart of ``tools/train.py`` (reference: src/train.py). The
configuration is ``configs/<name>.yaml`` (model_58_4 and w48_640 come from
their Python presets, so no PyYAML is needed), with ``KEY VALUE`` pairs
merged over it and ``--msg-pass`` setting ``TPU.MSG_PASS``. The weights are
seeded random ones, or a checkpoint's: ``TRAIN.CONTINUE`` names one to
resume (model, optimizer and the saved epoch, from which the epochs run
again) or, with ``TRAIN.FINETUNE``, to take the weights and statistics
from only.

Batches come from the COCO (or CrowdPose) training set under
``DATASET.ROOT`` with the training augmentation, loaded by ``WORKERS``
threads, with a validation loader on COCO's mini val2017 when it is there;
or with ``--synthetic`` from generated scenes, ``--steps-per-epoch`` (1000
when not given) an epoch. Epochs run from ``TRAIN.START_EPOCH`` to
``--epochs`` (``TRAIN.END_EPOCH`` when not given). Every ``PRINT_FREQ``
iterations the loss and its parts are printed and logged to
``<LOG_DIR>/metrics.jsonl`` (and TensorBoard where it imports), and training
stops after 5 skipped (non-finite) steps. After each epoch the checkpoint
``MODEL.PRETRAINED`` (``<LOG_DIR>/pose_estimation.ckpt`` when empty) is
written, with a snapshot ``<ckpt>.epoch<e>`` before each learning-rate step,
and the validation loss is logged.

As in ``tools/train.py``, the learning-rate schedule counts
``--steps-per-epoch`` (or 1000) updates an epoch also on a real set, whose
epochs have ``len(loader)`` steps. Runs on CUDA unless given ``--device
cpu``. At the end rank 0 prints one JSON line ``{"train": {...}}``: steps,
skipped steps, the last epoch's device ms a step and, under data
parallelism, the gradients' packing and all-reduce ms a step, peak GiB
and the kernels' launches.

Launched by torchrun, Slurm or MPI (parallel.distributed), it trains data
parallel, one process per card, as tools/train.py's sharded step:

    torchrun --nproc_per_node=8 -m pemp_tpu_torch.train <config> [...]

Every rank draws the same permutation (or synthetic scenes) and takes its
rows of each global batch of ``TRAIN.BATCH_SIZE`` (which the world must
divide); an epoch still has ``len(loader)`` global batches. Rank 0 logs,
prints and writes the checkpoints; every rank loads ``TRAIN.CONTINUE``
onto its card, and rank 0's weights are broadcast before the first step.
The augmentation draws of a rank's rows are not those one process would
draw for them (with loader threads they follow thread order already).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from pemp_tpu_torch import ops
from pemp_tpu_torch.config import load_config, update_config_command
from pemp_tpu_torch.data.datasets import CocoKeypoints, CrowdPoseKeypoints, DataLoader
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.data.targets import HeatmapGenerator, JointsGenerator
from pemp_tpu_torch.data.transforms import transforms_hr_train
from pemp_tpu_torch.parallel import distributed
from pemp_tpu_torch.train.checkpoint import load_checkpoint, load_params_only, save_checkpoint
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
from pemp_tpu_torch.utils.logger import Logger

# skipped (non-finite) steps after which training stops (the reference's
# oom_counter, src/train.py:276-299)
MAX_FAILED_STEPS = 5


class SyntheticLoader:
    """``steps`` batches of generated scenes an epoch, drawn from one
    ``RandomState(seed)`` across epochs (tools/train.py's
    make_synthetic_loader); under data parallelism each rank draws the
    global batch and keeps its rows."""

    def __init__(self, config, steps: int, seed: int = 0):
        self.rng = np.random.RandomState(seed)
        self.steps = steps
        d = config.DATASET
        self.args = (config.TRAIN.BATCH_SIZE, d.INPUT_SIZE, tuple(d.OUTPUT_SIZE), d.NUM_JOINTS,
                     d.MAX_NUM_PEOPLE)

    def __len__(self):
        return self.steps

    def __iter__(self):
        for _ in range(self.steps):
            yield distributed.shard_rows(make_batch(self.rng, *self.args))


def make_coco_loaders(config):
    """The training loader and the per-epoch validation loader (None for
    CrowdPose, or when COCO's val2017 annotations are missing); tools/
    train.py's make_coco_loaders (reference: train.py:20-102). The
    augmentation draws from the global ``np.random``. Under data
    parallelism each rank loads its rows of every global batch."""
    out_sizes = list(config.DATASET.OUTPUT_SIZE)
    nj = config.DATASET.NUM_JOINTS
    hm = [HeatmapGenerator(s, nj) for s in out_sizes]
    jg = [JointsGenerator(config.DATASET.MAX_NUM_PEOPLE, nj, s, True) for s in out_sizes]
    tf = transforms_hr_train(config)
    mini = "mini" in config.TRAIN.SPLIT
    bs, workers = config.TRAIN.BATCH_SIZE, config.WORKERS
    val_loader = None
    if config.DATASET.DATASET == "crowd_pose":
        train_set = CrowdPoseKeypoints(config.DATASET.ROOT, mini=mini, mode="trainval",
                                       transforms=tf, heatmap_generator=hm, joint_generator=jg)
    else:
        train_set = CocoKeypoints(config.DATASET.ROOT, mini=mini, mode="train", transforms=tf,
                                  heatmap_generator=hm, joint_generator=jg, num_joints=nj)
        try:
            val_set = CocoKeypoints(config.DATASET.ROOT, mini=True, mode="val", transforms=tf,
                                    heatmap_generator=hm, joint_generator=jg, num_joints=nj)
            val_loader = DataLoader(val_set, bs, shuffle=False, num_workers=workers,
                                    shard=(distributed.rank(), distributed.world()))
        except FileNotFoundError:
            val_loader = None
    return DataLoader(train_set, bs, shuffle=True, num_workers=workers,
                      shard=(distributed.rank(), distributed.world())), val_loader


class _Silent:
    """The logger of a rank other than 0."""

    def log_loss(self, *args, **kwargs):
        pass

    log_vars = log_loss
    close = log_loss


def train(config, loader, val_loader=None, log_dir=None, *, schedule_steps: int = 1000,
          epochs=None, device="cuda", seed: int = 0, on_step=None) -> dict:
    """tools/train.py's main after its loaders are built.

    ``loader`` gives numpy batches (data.datasets.default_collate's dict)
    and has a ``len``; ``val_loader`` is one too or None. ``schedule_steps``
    is the updates an epoch of the learning-rate schedule; ``epochs``
    overrides ``TRAIN.END_EPOCH``; ``on_step(trainer, it, loss, logging)``
    is called after each step. Logs and checkpoints go to ``log_dir``
    (``LOG_DIR`` when None) unless ``MODEL.PRETRAINED`` names the
    checkpoint. Under data parallelism each rank calls it with a loader of
    its rows of the global batches and its ``device``; the losses are the
    global batch's on every rank, and only rank 0 logs, prints and writes.

    Returns a summary: ``start_epoch``, ``end_epoch``, ``aborted``,
    ``ckpt_path``, the per-step ``losses``, ``val_losses`` by epoch,
    ``fail_count``, ``steps`` (the trainer's, resumed ones included), and
    ``epochs``, one dict of timings an epoch: its
    ``steps``, the seconds of its step loop (``seconds``, ending in a
    synchronise), of waiting for batches (``loader_s``: the loader and the
    copy to the device) and in the steps (``step_s``), and on CUDA the
    device time between the start and end of each step summed
    (``device_s``), and under data parallelism that of packing the
    gradients into one buffer (``pack_s``) and of its all-reduce
    (``allreduce_s``).
    """
    main = distributed.is_main()
    say = print if main else (lambda *args, **kwargs: None)
    log_dir = log_dir or config.LOG_DIR or "log"
    os.makedirs(log_dir, exist_ok=True)
    logger = Logger(log_dir) if main else _Silent()
    rows = distributed.local_rows(config.TRAIN.BATCH_SIZE)
    trainer = build_trainer(config, device=device, seed=seed, steps_per_epoch=schedule_steps)
    model = trainer.model
    dev = next(model.parameters()).device
    say(f"model params: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M")

    start_epoch = config.TRAIN.START_EPOCH
    ckpt_path = config.MODEL.PRETRAINED or os.path.join(log_dir, "pose_estimation.ckpt")
    if config.TRAIN.CONTINUE:
        if config.TRAIN.FINETUNE:
            load_params_only(config.TRAIN.CONTINUE, model)
        else:
            # the loop runs again from the saved epoch, as tools/train.py's
            # range(start_epoch, end_epoch) does
            start_epoch, trainer.steps = load_checkpoint(config.TRAIN.CONTINUE, model,
                                                         trainer.optimizer)
    distributed.broadcast_state(model)

    end_epoch = epochs if epochs is not None else config.TRAIN.END_EPOCH
    steps_per_epoch = len(loader)
    summary = {"start_epoch": start_epoch, "end_epoch": end_epoch, "aborted": False,
               "ckpt_path": ckpt_path, "losses": [], "val_losses": {}, "epochs": []}
    cuda = dev.type == "cuda"
    say("#####Begin Training#####")
    for epoch in range(start_epoch, end_epoch):
        if summary["aborted"]:
            break
        t_epoch = time.time()
        timing = {"epoch": epoch, "steps": 0, "loader_s": 0.0, "step_s": 0.0}
        events = []
        trainer.reduce_events = [] if cuda else None
        t_loop = time.perf_counter()
        batches = iter(loader)
        i = 0
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            if distributed.active() and len(batch["imgs"]) != rows:
                raise ValueError(f"rank {distributed.rank()} got a batch of {len(batch['imgs'])} "
                                 f"rows; it holds {rows} of each global batch")
            batch = batch_to_torch(batch, dev)
            t1 = time.perf_counter()
            if cuda:
                events.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            loss, logging = trainer.step(batch)
            if cuda:
                events[-1][1].record()
            timing["loader_s"] += t1 - t0
            timing["step_s"] += time.perf_counter() - t1
            timing["steps"] += 1
            it = i + steps_per_epoch * epoch
            summary["losses"].append(float(loss))
            if on_step is not None:
                on_step(trainer, it, loss, logging)
            if i % config.PRINT_FREQ == 0:
                parts = {k: float(v) for k, v in logging.items()}
                logger.log_loss(float(loss), "Loss/train", it)
                logger.log_vars("Loss/parts", it, **parts)
                text = " ".join(f"{k}:{v:.4f}" for k, v in parts.items())
                say(f"Iter: {it}, loss: {float(loss):.6f} | {text}", flush=True)
                if trainer.fail_count >= MAX_FAILED_STEPS:
                    say("Stopping training due to large amount of failed (non-finite) "
                        f"steps: {trainer.fail_count}")
                    summary["aborted"] = True
                    break
            i += 1
        if cuda:
            torch.cuda.synchronize()
            timing["device_s"] = sum(a.elapsed_time(b) for a, b in events) / 1e3
            if distributed.active():
                timing["pack_s"] = sum(a.elapsed_time(b)
                                       for a, b, _ in trainer.reduce_events) / 1e3
                timing["allreduce_s"] = sum(b.elapsed_time(c)
                                            for _, b, c in trainer.reduce_events) / 1e3
        trainer.reduce_events = None
        timing["seconds"] = time.perf_counter() - t_loop
        summary["epochs"].append(timing)

        if main:
            save_checkpoint(ckpt_path, model, trainer.optimizer, epoch, trainer.steps)
            if epoch + 1 in list(config.TRAIN.LR_STEP):
                save_checkpoint(f"{ckpt_path}.epoch{epoch}", model, trainer.optimizer, epoch,
                                trainer.steps)
        distributed.barrier()
        # per-epoch validation with the same loss plumbing, no gradients
        # (reference: train.py:351-495)
        if val_loader is not None:
            val_losses = [float(trainer.eval_step(batch_to_torch(vb, dev))[0])
                          for vb in val_loader]
            if val_losses:
                summary["val_losses"][epoch] = float(np.mean(val_losses))
                logger.log_loss(summary["val_losses"][epoch], "Loss/valid", epoch)
                say(f"epoch {epoch} val loss: {summary['val_losses'][epoch]:.5f}")
        say(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s -> {ckpt_path}", flush=True)
    logger.close()
    summary["fail_count"] = trainer.fail_count
    summary["steps"] = trainer.steps
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Train the pose-estimation MPN")
    p.add_argument("config", help="experiment config name under configs/ (no .yaml)")
    p.add_argument("--synthetic", action="store_true", help="train on synthetic scenes")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--msg-pass", help="TPU.MSG_PASS (the config's value by default)")
    args, options = p.parse_known_args(argv)

    with distributed.process_group(args.device) as device:
        config = update_config_command(load_config(args.config), options)
        if args.msg_pass:
            config.TPU.MSG_PASS = args.msg_pass
        distributed.local_rows(config.TRAIN.BATCH_SIZE)
        np.random.seed(args.seed)
        log_dir = config.LOG_DIR or f"log/{args.config.replace('/', '_')}"
        schedule_steps = args.steps_per_epoch or 1000
        if args.synthetic:
            loader, val_loader = SyntheticLoader(config, schedule_steps, args.seed), None
        else:
            loader, val_loader = make_coco_loaders(config)
        t0 = time.perf_counter()
        summary = train(config, loader, val_loader, log_dir, schedule_steps=schedule_steps,
                        epochs=args.epochs, device=device, seed=args.seed)
        if distributed.is_main():
            steps = sum(e["steps"] for e in summary["epochs"])
            print(f"{steps} steps in {time.perf_counter() - t0:.3f} s (batch "
                  f"{config.TRAIN.BATCH_SIZE} over {distributed.world()} rank(s)); skipped steps "
                  f"{summary['fail_count']}")
            last = summary["epochs"][-1] if summary["epochs"] else {}
            per_step = 1e3 / max(last.get("steps", 0), 1)
            print(json.dumps({"train": {
                "world": distributed.world(), "steps": steps,
                "skipped": summary["fail_count"], "losses": summary["losses"],
                "device_ms_a_step": last.get("device_s", float("nan")) * per_step,
                "pack_ms_a_step": last.get("pack_s", float("nan")) * per_step,
                "allreduce_ms_a_step": last.get("allreduce_s", float("nan")) * per_step,
                "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                             if device.type == "cuda" else None),
                "launches": ops.launch_counts()}}), flush=True)
    return 1 if summary["aborted"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
