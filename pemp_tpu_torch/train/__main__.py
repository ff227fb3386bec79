"""Trains a configuration for a few steps on synthetic batches.

    python -m pemp_tpu_torch.train hybrid_class_agnostic_end2end/model_58_4 \
        --synthetic --steps 3 [--device cpu] [--seed 0] [--msg-pass hybrid]

The counterpart of ``tools/train.py --synthetic`` for a few steps: the
configuration is read from ``configs/<name>.yaml`` (model_58_4 comes from
its Python preset, so no PyYAML is needed), the weights are seeded random
ones, and each step's batch comes from ``data.synthetic`` with a numpy
``RandomState(seed)``. ``--msg-pass`` sets ``TPU.MSG_PASS`` (the
message-passing route: ``pallas``, ``hybrid``, ``einsum`` or ``dots``; the
file's own value by default). Runs on CUDA unless given ``--device cpu``; prints
each step's loss parts and the steps per second.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from pemp_tpu_torch.config import load_config
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Train the pose-estimation MPN for a few steps")
    p.add_argument("config", help="experiment config name under configs/ (no .yaml)")
    p.add_argument("--synthetic", action="store_true", required=True,
                   help="train on synthetic scenes (no COCO loader is ported)")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--msg-pass", help="TPU.MSG_PASS (the file's value by default)")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    if args.msg_pass:
        cfg.TPU.MSG_PASS = args.msg_pass
    trainer = build_trainer(cfg, device=args.device, seed=args.seed)
    device = next(trainer.model.parameters()).device
    rng = np.random.RandomState(args.seed)
    size, outs = cfg.DATASET.INPUT_SIZE, tuple(cfg.DATASET.OUTPUT_SIZE)
    t0 = time.perf_counter()
    for it in range(args.steps):
        batch = batch_to_torch(make_batch(rng, cfg.TRAIN.BATCH_SIZE, size, outs,
                                          cfg.DATASET.NUM_JOINTS,
                                          cfg.DATASET.MAX_NUM_PEOPLE), device)
        loss, logging = trainer.step(batch)
        parts = " ".join(f"{k}:{float(v):.4f}" for k, v in logging.items())
        print(f"step {it}: loss {float(loss):.6f} | {parts}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{args.steps} steps in {dt:.3f} s ({args.steps / dt:.3f} steps/s, batch "
          f"{cfg.TRAIN.BATCH_SIZE}, synthetic data made inside the loop) on {where}; "
          f"skipped steps {trainer.fail_count}")
    return 1 if trainer.fail_count else 0


if __name__ == "__main__":
    raise SystemExit(main())
