"""A data-parallel dry run on the CPU (counterpart of
``__graft_entry__.dryrun_multichip``):

    python -m pemp_tpu_torch.parallel.dryrun N

N gloo ranks, each a fresh process: one data-parallel training step of the
small model_58_4 cut on a global batch of N synthetic scenes (one a rank),
then the sharded eval (one scale, no flip, threshold decode) of N images,
each rank running its share through the TTA pipeline. Prints the loss,
whether the ranks' parameters are bit-identical after the step, and the
persons' shapes; exits non-zero when a rank fails or the ranks disagree.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import tempfile

import numpy as np
import torch

from pemp_tpu_torch.parallel import distributed
from pemp_tpu_torch.parallel.eval_shard import shard_indices


def _rank(seed: int) -> dict:
    from pemp_tpu_torch.config import small_train
    from pemp_tpu_torch.data.synthetic import make_batch
    from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
    from pemp_tpu_torch.tta.multi_scale import TTAPipeline

    world, rank = distributed.world(), distributed.rank()
    cfg = small_train()
    cfg.TRAIN.BATCH_SIZE = world
    trainer = build_trainer(cfg, device="cpu", seed=seed)
    distributed.broadcast_state(trainer.model)
    rng = np.random.RandomState(seed)
    batch = make_batch(rng, world, 64, (16, 32), 17, 30, scale_range=(0.4, 0.9))
    loss, logging = trainer.step(batch_to_torch(distributed.shard_rows(batch), "cpu"))
    digest = hashlib.sha256()
    for t in trainer.model.state_dict().values():
        digest.update(t.numpy().tobytes())

    cfg.TEST.SCALE_FACTOR = [1.0]
    cfg.TEST.FLIP_TEST = False
    cfg.TEST.PROJECT2IMAGE = True
    pipe = TTAPipeline(trainer.model.eval(), cfg, with_decode=True)
    images = [(rng.rand(64, 48, 3) * 255).astype(np.uint8) for _ in range(world)]
    mine = shard_indices(len(images), world, rank)
    outs = pipe.run_batched([images[i] for i in mine], batch_size=len(mine))
    return {"loss": float(loss), "skipped": float(logging["skipped"]),
            "digest": digest.hexdigest(), "images": mine,
            "persons": [tuple(out["persons"].shape) for out in outs],
            "finite": all(bool(torch.isfinite(out["persons"]).all()) for out in outs)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Data-parallel dry run on the CPU")
    p.add_argument("n", type=int, help="ranks (gloo processes)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deadline", type=float, default=300.0, help="seconds the ranks may take")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as workdir:
        results = distributed.run_ranks(_rank, args.n, workdir, args.seed,
                                        deadline_s=args.deadline)
    losses = {r["loss"] for r in results}
    same = len({r["digest"] for r in results}) == 1
    print(f"dryrun({args.n}): one data-parallel training step, loss {sorted(losses)}, "
          f"skipped {[r['skipped'] for r in results]}, parameters bit-identical across ranks "
          f"{same}")
    for rank, r in enumerate(results):
        print(f"dryrun({args.n}): rank {rank} evaluated images {r['images']}: persons shapes "
              f"{r['persons']}, finite {r['finite']}")
    ok = (len(losses) == 1 and np.isfinite(next(iter(losses))) and same
          and all(r["finite"] and r["skipped"] == 0 for r in results))
    print(f"dryrun({args.n}): {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
