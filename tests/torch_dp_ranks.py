"""What the ranks of the data-parallel tests run: each function runs in a
fresh process spawned by ``pemp_tpu_torch.parallel.distributed.run_ranks``
as one rank of a gloo group on the CPU, so this module imports neither
jax nor pemp_tpu (a spawned process imports the module of the function it
runs)."""

from __future__ import annotations

import sys

import torch

from pemp_tpu_torch.parallel import distributed


def no_tensorboard():
    """The training logger's JSON lines only: TensorBoard's import (which
    pulls in TensorFlow here) would cost each rank 0 about 15 s."""
    sys.modules["torch.utils.tensorboard"] = None


def to_f64(trainer, batch):
    """The trainer's model and a torch batch in float64."""
    trainer.model.double()
    trainer.model.dtype = torch.float64
    return {k: [x.double() for x in v] if isinstance(v, list) else
            (v.double() if v.is_floating_point() else v) for k, v in batch.items()}


def step_record(trainer, loss, logging, grads: bool) -> dict:
    """One step's loss, parts, labels and (where asked) every parameter's
    gradient and the running statistics after it."""
    out = {"loss": float(loss), "logging": {k: float(v) for k, v in logging.items()},
           "labels": {k: (v[0] if isinstance(v, list) else v).clone()
                      for k, v in trainer.last_output["labels"].items()
                      if k in ("node", "class", "person", "edge")}}
    if grads:
        out["grads"] = {k: p.grad.clone() for k, p in trainer.model.named_parameters()
                        if p.grad is not None}
        out["stats"] = {k: b.clone() for k, b in trainer.model.named_buffers()
                        if "running" in k}
    return out


def train_steps(cfg, state, batches, f64=False) -> dict:
    """TrainStep on this rank's rows of each global batch (numpy), from
    ``state``: a record of each step (gradients and statistics of the
    first), the state after the last and the skipped-step count."""
    from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer

    trainer = build_trainer(cfg, device="cpu", seed=0)
    trainer.model.load_state_dict(state)
    distributed.broadcast_state(trainer.model)
    records = []
    for i, batch in enumerate(batches):
        tbatch = batch_to_torch(distributed.shard_rows(batch), "cpu")
        if f64:
            tbatch = to_f64(trainer, tbatch)
        loss, logging = trainer.step(tbatch)
        records.append(step_record(trainer, loss, logging, grads=i == 0))
    return {"records": records, "fail_count": trainer.fail_count,
            "state": {k: v.clone() for k, v in trainer.model.state_dict().items()}}


def run_jobs(jobs) -> list:
    """Each ``(function name, args)`` of ``jobs`` in turn, on the group."""
    return [globals()[name](*args) for name, args in jobs]


def train_entry(cfg, batches, val_batches, log_dir) -> dict:
    """``train()`` over this rank's rows of the global batches, with a
    validation loader; its summary."""
    from pemp_tpu_torch.train.__main__ import train

    no_tensorboard()
    shard = [distributed.shard_rows(b) for b in batches]
    val = [distributed.shard_rows(b) for b in val_batches]
    summary = train(cfg, shard, val, log_dir, epochs=1, device="cpu")
    return {k: summary[k] for k in ("losses", "val_losses", "fail_count", "ckpt_path")}


def entry_point(module: str, argv: list):
    """``main(argv)`` of the entry point ``pemp_tpu_torch.<module>``."""
    import importlib

    return importlib.import_module(f"pemp_tpu_torch.{module}").main(argv)


def sleep(seconds: float):
    """A rank that does not end in time."""
    import time

    time.sleep(seconds)
