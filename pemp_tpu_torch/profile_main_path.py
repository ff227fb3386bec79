"""Where the main path's time goes on the card, stage by stage.

    python -m pemp_tpu_torch.profile_main_path

Runs the w48/640 eval pipeline at batch 8 (bf16, seeded random weights)
with CUDA events between its stages (backbone + feature gather, graph
construction, MPN, decode; the heatmap resize and slicing count to the
graph stage) and prints each stage's median time over 5 forwards, then
``torch.profiler``'s device time per kernel over one forward. Needs a CUDA
card; it does not run on the CPU.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    pipe = build_pipeline(BATCH, INPUT_SIZE, dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator().manual_seed(0)
    images = torch.rand(BATCH, INPUT_SIZE, INPUT_SIZE, 3, generator=gen).cuda()
    with torch.no_grad():
        pipe(images)
        runs = [_stages(pipe, images) for _ in range(ITERS)]
        total = [sum(r.values()) for r in runs]
        print(f"card: {card}; w48/{INPUT_SIZE} batch {BATCH} bf16, median of {ITERS}")
        for k in runs[0]:
            ms = float(np.median([r[k] for r in runs]))
            print(f"  {k:9s} {ms:9.3f} ms  {100 * ms / np.median(total):5.1f} %")
        print(f"  {'total':9s} {np.median(total):9.3f} ms  "
              f"({BATCH / np.median(total) * 1e3:.2f} img/s, stages back to back)")

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            pipe(images)
            torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25,
                                    max_name_column_width=60))


if __name__ == "__main__":
    main()
