"""Where the main path's time goes on the card, stage by stage.

    python -m pemp_tpu_torch.profile_main_path [--msg-pass ROUTE] [--variant NAME]

Runs the w48/640 eval pipeline at batch 8 (bf16, seeded random weights),
with ``TPU.MSG_PASS`` set to ROUTE (auto, fused_step, pallas, hybrid,
einsum or dots; default auto, the fused step), as ``BENCH_MSG_PASS`` sets it
for bench.py, with CUDA events between its stages (backbone + feature
gather, graph construction, MPN, decode; the heatmap resize and slicing
count to the graph stage) and prints each stage's median time over 5
forwards and their peak device memory, then ``torch.profiler``'s device
time per kernel over one forward. Needs a CUDA
card; it does not run on the CPU. ``--variant`` merges one of
config.VARIANTS (the JAX package's MPN and graph variants) over the
configuration.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from pemp_tpu_torch.config import variant, w48_640
from pemp_tpu_torch.pipeline import BATCH, INPUT_SIZE, build_pipeline

ITERS = 5


def _stages(pipe, images):
    """One forward, with CUDA events at the stage boundaries (module hooks,
    so the pipeline's own code runs unchanged); returns {stage: ms}."""
    model = pipe.model
    ev = {k: torch.cuda.Event(enable_timing=True)
          for k in ("start", "backbone", "graph", "mpn", "decode")}
    mark = lambda key: (lambda *_: ev[key].record())  # noqa: E731
    hooks = [
        model.backbone.register_forward_pre_hook(mark("start")),
        model.feature_gather.register_forward_hook(mark("backbone")),
        model.mpn.register_forward_pre_hook(mark("graph")),
        model.mpn.register_forward_hook(mark("mpn")),
    ]
    try:
        pipe(images)
        ev["decode"].record()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    names = list(ev)
    return {k: ev[a].elapsed_time(ev[k]) for a, k in zip(names, names[1:])}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Stage times of the w48/640 eval path on the card")
    p.add_argument("--msg-pass", default="auto", help="TPU.MSG_PASS for the MPN")
    p.add_argument("--variant", default=None, help="a key of config.VARIANTS to merge")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    cfg = w48_640() if args.variant is None else variant(args.variant, w48_640())
    cfg.TPU.MSG_PASS = args.msg_pass
    pipe = build_pipeline(BATCH, INPUT_SIZE, dtype=torch.bfloat16, device="cuda", cfg=cfg)
    gen = torch.Generator().manual_seed(0)
    images = torch.rand(BATCH, INPUT_SIZE, INPUT_SIZE, 3, generator=gen).cuda()
    with torch.no_grad():
        pipe(images)
        torch.cuda.reset_peak_memory_stats()
        runs = [_stages(pipe, images) for _ in range(ITERS)]
        total = [sum(r.values()) for r in runs]
        print(f"card: {card}; w48/{INPUT_SIZE} batch {BATCH} bf16, MSG_PASS "
              f"{args.msg_pass}, variant {args.variant}, median of {ITERS}")
        for k in runs[0]:
            ms = float(np.median([r[k] for r in runs]))
            print(f"  {k:9s} {ms:9.3f} ms  {100 * ms / np.median(total):5.1f} %")
        print(f"  {'total':9s} {np.median(total):9.3f} ms  "
              f"({BATCH / np.median(total) * 1e3:.2f} img/s, stages back to back)")
        print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            pipe(images)
            torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25,
                                    max_name_column_width=60))


if __name__ == "__main__":
    main()
