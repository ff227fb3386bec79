"""Overfits one fixed batch: can the model learn at all.

    python -m pemp_tpu_torch.overfit --config C [--iters 200] [--print-freq 20] \
        [--device cpu] [KEY VALUE ...]

The counterpart of ``tools/overfit.py`` (reference:
src/test/test_train_loop.py:121-216). One synthetic batch of
``TRAIN.BATCH_SIZE`` scenes (``data.synthetic.make_batch`` from
``RandomState(0)``), the training step of ``train.train_step.build_trainer``
on it again and again, and every ``--print-freq`` iterations and at the
last one a pass in eval mode on the training route whose edge and node
precision and recall (``sigmoid(logit) > 0.5`` on the last edge output and
the node output, under their masks) are printed beside the step's loss.

``--config`` resolves as the other entry points' (a preset, or
``configs/<name>.yaml``); weights are seeded random ones. Runs on CUDA
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from pemp_tpu_torch.config import load_config, update_config_command
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.eval.writer import calc_metrics
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer


def overfit_batch(config) -> dict:
    """The fixed batch (tools/overfit.py:43-47), numpy."""
    return make_batch(np.random.RandomState(0), config.TRAIN.BATCH_SIZE,
                      config.DATASET.INPUT_SIZE, tuple(config.DATASET.OUTPUT_SIZE),
                      config.DATASET.NUM_JOINTS)


def eval_metrics(output) -> tuple[dict, dict]:
    """Edge and node metrics of a forward's output (preds, labels, masks):
    ``sigmoid(logit) > 0.5`` on the last edge output and on the node
    output, against the labels under the masks ({} where a mask keeps
    nothing)."""
    host = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    preds, labels, masks = output["preds"], output["labels"], output["masks"]
    em = calc_metrics(host(torch.sigmoid(preds["edge"][-1])) > 0.5, host(labels["edge"][-1]),
                      host(masks["edge"][-1]))
    nm = calc_metrics(host(torch.sigmoid(preds["node"][-1])) > 0.5, host(labels["node"]),
                      host(masks["node"]))
    return em or {}, nm or {}


def overfit(config, batch, device="cuda", iters: int = 200, print_freq: int = 20,
            model=None) -> list[dict]:
    """Trains ``model`` (a training-path build_pose_model with its weights;
    seeded random ones when None) on the numpy ``batch`` for ``iters``
    steps and prints tools/overfit.py's line at every ``print_freq``-th
    iteration and the last. Returns one row a printed line: ``iter``,
    ``loss``, the ``edge`` and ``node`` metrics, ``line``, the eval pass's
    last ``edge_logit`` and ``node_logit`` (numpy), and ``seconds`` since
    the first step began (host clock; the metrics wait for the device)."""
    # keep the learning-rate steps out of reach, as tools/overfit.py:58
    trainer = build_trainer(config, device, steps_per_epoch=10**6, model=model)
    tb = batch_to_torch(batch, next(trainer.model.parameters()).device)
    rows = []
    t0 = time.perf_counter()
    for i in range(iters):
        loss, _ = trainer.step(tb)
        if i % print_freq == 0 or i == iters - 1:
            _, _, output = trainer.eval_step(tb, with_output=True)
            em, nm = eval_metrics(output)
            line = (f"iter {i}: loss {float(loss):.5f} | "
                    f"edge prec {em.get('prec', 0):.3f} rec {em.get('rec', 0):.3f} | "
                    f"node prec {nm.get('prec', 0):.3f} rec {nm.get('rec', 0):.3f}")
            print(line, flush=True)
            rows.append(dict(
                iter=i, loss=float(loss), edge=em, node=nm, line=line,
                edge_logit=output["preds"]["edge"][-1].float().cpu().numpy(),
                node_logit=output["preds"]["node"][-1].float().cpu().numpy(),
                seconds=time.perf_counter() - t0))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description="Overfit one fixed batch")
    p.add_argument("--config", required=True)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--print-freq", type=int, default=20)
    p.add_argument("--device", default="cuda")
    args, options = p.parse_known_args(argv)
    config = update_config_command(load_config(args.config), options)
    return overfit(config, overfit_batch(config), args.device, args.iters, args.print_freq)


if __name__ == "__main__":
    main()
