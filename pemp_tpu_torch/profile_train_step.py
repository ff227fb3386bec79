"""Where a model_58_4 training step's time goes on the card, stage by stage.

    python -m pemp_tpu_torch.profile_train_step [--msg-pass ROUTE] [--variant NAME]

Trains model_58_4 (HigherHRNet-w32 at 512, batch 8, f32, seeded random
weights, synthetic batches made before timing), with ``TPU.MSG_PASS`` set
to ROUTE (auto, fused_step, pallas, hybrid, einsum or dots; default auto, the typed
message kernel), with CUDA events between the stages of each step:
backbone (with the feature gather), graph (detection, kNN graph and edge
features), labels (the auction matcher and the method-6 labels), MPN
(embeddings, the 10 steps and the heads), losses, backward and optimizer.
Prints each stage's median over 3 steps after a warm-up and their peak
device memory, then ``torch.profiler``'s device time per kernel over one
step and per autograd backward node (``IndexBackward0``: the plain
gathers' backward). Needs a CUDA card; it does not run on the CPU.
``--variant`` merges one of config.VARIANTS (the JAX package's MPN and
graph variants) over the configuration.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from pemp_tpu_torch.config import variant, w32_512_train
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.graph import constructor
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer

STEPS = 3
STAGES = ("start", "backbone", "graph", "labels", "mpn", "losses", "backward", "optimizer")


def _step(trainer, batch):
    """One training step with CUDA events at the stage boundaries (module
    hooks and a wrapped label builder, so the step's code runs unchanged);
    returns {stage: ms}. The graph stage is what lies between the backbone
    and the MPN, less the labels."""
    model = trainer.model
    ev = {k: torch.cuda.Event(enable_timing=True) for k in STAGES}
    ev_lab0 = torch.cuda.Event(enable_timing=True)
    mark = lambda key: (lambda *_: ev[key].record())  # noqa: E731
    real = constructor._construct_labels

    def labels(*args, **kw):
        ev_lab0.record()
        out = real(*args, **kw)
        ev["labels"].record()
        return out

    hooks = [
        model.backbone.register_forward_pre_hook(mark("start")),
        model.feature_gather.register_forward_hook(mark("backbone")),
        model.mpn.register_forward_pre_hook(mark("graph")),
        model.mpn.register_forward_hook(mark("mpn")),
    ]
    constructor._construct_labels = labels
    try:
        trainer.optimizer.zero_grad()
        loss, _, _ = trainer.loss(batch)
        ev["losses"].record()
        loss.backward()
        ev["backward"].record()
        trainer.optimizer.step()
        ev["optimizer"].record()
        torch.cuda.synchronize()
    finally:
        constructor._construct_labels = real
        for h in hooks:
            h.remove()
    lab = ev_lab0.elapsed_time(ev["labels"])
    out = {
        "backbone": ev["start"].elapsed_time(ev["backbone"]),
        "graph": ev["backbone"].elapsed_time(ev["graph"]) - lab,
        "labels": lab,
    }
    for a, k in zip(STAGES[3:], STAGES[4:]):
        out[k] = ev["graph" if a == "labels" else a].elapsed_time(ev[k])
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Stage times of a model_58_4 training step")
    p.add_argument("--msg-pass", default="auto", help="TPU.MSG_PASS for the MPN")
    p.add_argument("--variant", default=None, help="a key of config.VARIANTS to merge")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    cfg = w32_512_train() if args.variant is None else variant(args.variant, w32_512_train())
    cfg.TPU.MSG_PASS = args.msg_pass
    bs, size = cfg.TRAIN.BATCH_SIZE, cfg.DATASET.INPUT_SIZE
    rng = np.random.RandomState(0)
    batches = [batch_to_torch(make_batch(rng, bs, size, tuple(cfg.DATASET.OUTPUT_SIZE), 17,
                                         cfg.DATASET.MAX_NUM_PEOPLE), "cuda")
               for _ in range(STEPS + 2)]
    trainer = build_trainer(cfg, device="cuda", seed=0)
    _step(trainer, batches[0])
    torch.cuda.reset_peak_memory_stats()
    runs = [_step(trainer, b) for b in batches[1:STEPS + 1]]
    total = [sum(r.values()) for r in runs]
    print(f"card: {card}; model_58_4 w32/{size} batch {bs} f32, MSG_PASS {args.msg_pass}, "
          f"variant {args.variant}, "
          f"median of {STEPS} steps")
    for k in runs[0]:
        ms = float(np.median([r[k] for r in runs]))
        print(f"  {k:9s} {ms:9.3f} ms  {100 * ms / np.median(total):5.1f} %")
    print(f"  {'total':9s} {np.median(total):9.3f} ms  "
          f"({bs / np.median(total) * 1e3:.2f} img/s, stages back to back)")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.step(batches[-1])
        torch.cuda.synchronize()
    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=25,
                         max_name_column_width=60))
    nodes = sorted((ev for ev in averages if ev.key.endswith(("Backward", "Backward0"))),
                   key=lambda ev: -ev.device_time_total)
    print("autograd backward nodes by device time, one step (torch.profiler):")
    for ev in nodes[:12]:
        print(f"  {ev.key:32s} {ev.device_time_total / 1e3:9.3f} ms in {ev.count} calls")


if __name__ == "__main__":
    main()
