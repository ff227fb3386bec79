"""Drives the PyTorch port's eval main path on one NVIDIA card and checks it.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: a CUDA card is required; prints its name and power limit.
2. build: compiles every kernel of the path from ``pemp_tpu_torch/csrc``
   (one nvcc per source, all started together).
3. K1 (``fused_mpn_step``) against its plain PyTorch version on the card,
   TF32 off: at the flagship eval shapes on seeded random inputs (f32 and
   bf16), and on the inputs the w48/640 main path feeds it at MPN steps 0
   and 9. Prints max abs error, kernel and plain ms per launch (CUDA events,
   median of 25 launches) and the bound.
4. small slice: the narrow test configuration with the same seeded weights
   on the CPU (plain versions) and on the card (kernels); MPN outputs and
   persons must agree. Then decode alone on hand-built scenes that form
   persons (random weights form none), CPU against card.
5. main path: HigherHRNet-w48 at 640, batch 8, bf16, seeded random weights:
   backbone -> detection -> kNN graph -> 10-step MPN -> decode. Launch
   counts are zeroed just before and read just after; K1 must launch 10
   times per forward. Prints img/s, peak memory and graph sizes.

Prints a JSON line of per-kernel numbers, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no sparsity
TIMED_LAUNCHES = 25


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, n=TIMED_LAUNCHES) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def k1_bound_ms(args):
    """Least time for K1's work on these inputs: each input read once and
    each output written once at the memory rate, against the matmul work
    these inputs need at the peak rate of their type; the larger."""
    q, cur, a, valid, w_e1 = args[2], args[3], args[4], args[7], args[9]
    e, dc = cur.shape
    h, de, d = q.shape[1], w_e1.shape[1], a.shape[-1]
    out_bytes = e * de * cur.element_size() + a.numel() * 4
    nbytes = sum(t.numel() * t.element_size() for t in args) + out_bytes
    n_valid = int(valid.sum())
    flops = e * (2 * dc * h + 2 * h * de + 2 * de) + n_valid * 2 * de * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[cur.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def random_k1_inputs(dtype, seed=0, b=8, j=17, k=40, c=80, w=64):
    rng = np.random.RandomState(seed)
    n_img = j * k
    n = b * n_img
    e = n * c
    dev = "cuda"
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev, dtype)  # noqa: E731
    i = lambda x: torch.from_numpy(x.astype(np.int32)).to(dev)  # noqa: E731
    args = (f(n, w), f(n, w), f(e, w), f(e, w), f(n, j, w),
            i(rng.randint(0, n_img, e)), i(rng.randint(0, j, e)), i(rng.rand(e) > 0.2),
            f(w, w) * 0.2, f(w, w) * 0.2, f(w) * 0.1, f(w, j * w) * 0.2, f(w, 1) * 0.2)
    return args, (n, j, n_img)


def check_k1(label, args, dims, tol, fused_step):
    got = fused_step.fused_mpn_step(*args, *dims)
    want = fused_step.fused_mpn_step_plain(*args, *dims)
    torch.cuda.synchronize()
    err = max((got[0] - want[0]).abs().max().item(),
              (got[1].float() - want[1].float()).abs().max().item())
    scale = max(want[0].abs().max().item(), want[1].float().abs().max().item())
    if not (np.isfinite(err) and err <= tol):
        raise SystemExit(f"K1 {label}: max abs error {err} exceeds {tol}")
    ms = median_ms(lambda: fused_step.fused_mpn_step(*args, *dims))
    plain_ms = median_ms(lambda: fused_step.fused_mpn_step_plain(*args, *dims))
    bound, bound_by, nbytes, flops = k1_bound_ms(args)
    log(f"K1 {label}: max_abs_err={err:.3e} (tol {tol}; max |plain| {scale:.3e}) "
        f"kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} by {bound_by} "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return err, ms, plain_ms, bound, bound_by


def capture_k1_inputs(pipe, images, steps=(0, 9)):
    """Runs one forward and keeps K1's inputs at the given MPN steps."""
    from pemp_tpu_torch.models.mpn import layers

    real = layers.fused_mpn_step
    seen = []
    kept = {}

    def recording(*args):
        if len(seen) in steps:
            kept[len(seen)] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        seen.append(1)
        return real(*args)

    layers.fused_mpn_step = recording
    try:
        pipe(images)
    finally:
        layers.fused_mpn_step = real
    torch.cuda.synchronize()
    return kept


def phase_small_slice():
    """The narrow test configuration, same weights, CPU against card."""
    from pemp_tpu_torch.config import small
    from pemp_tpu_torch.pipeline import build_pipeline

    cfg = small()
    imgs = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    runs = {}
    for dev in ("cpu", "cuda"):
        pipe = build_pipeline(2, dtype=torch.float32, device=dev, cfg=cfg, seed=3)
        persons, valid, _, out = pipe.forward(imgs.to(dev))
        runs[dev] = (persons.cpu(), valid.cpu(),
                     {k: v.cpu() for k, v in out["graph"].items()},
                     {k: v[-1].cpu() for k, v in out["preds"].items()})
    (pc, vc, gc, mc), (pg, vg, gg, mg) = runs["cpu"], runs["cuda"]
    for key in ("nodes", "edge_index", "edge_valid", "node_valid"):
        if not torch.equal(gc[key], gg[key]):
            raise SystemExit(f"small slice: graph field {key} differs between CPU and card")
    ev = gc["edge_valid"]
    errs = {"edge": (mc["edge"] - mg["edge"])[ev].abs().max().item(),
            "node": (mc["node"] - mg["node"]).abs().max().item(),
            "class": (mc["class"] - mg["class"]).abs().max().item()}
    # f32 on both sides (TF32 off); cuDNN and the kernel sum in other orders
    # than the CPU: the JAX package's MPN parity tolerance
    bad = {k: v for k, v in errs.items() if not v <= 2e-3}
    if bad:
        raise SystemExit(f"small slice: MPN outputs differ: {bad}")
    if not (torch.equal(vc, vg) and torch.equal(pc[..., :2], pg[..., :2])
            and (pc[..., 2] - pg[..., 2]).abs().max().item() <= 1e-5):
        raise SystemExit("small slice: persons differ between CPU and card")
    log(f"small slice: CPU vs card MPN max abs err {errs}; graph exact; "
        f"persons equal ({int(vc.sum())} found); valid edges {int(ev.sum())}")


def decode_scene(rng, j=17, k=6, c=10, h=24, w=28, persons=3):
    """One image's decode inputs, built by hand so that persons form:
    random MPN weights put every sigmoid near 0.5, below the 0.8 edge
    threshold. Each person's joints are chained by edges far above it."""
    n = j * k
    det = np.stack([rng.randint(0, w, n), rng.randint(0, h, n), np.arange(n) // k], -1)
    person = np.full(n, -1)
    for p in range(persons):
        person[np.arange(j) * k + p] = np.where(rng.rand(j) < 0.85, p, -1)
    node_valid = (rng.rand(n) > 0.1) | (person >= 0)
    node_scores = np.where(person >= 0, rng.uniform(0.6, 0.99, n), rng.uniform(0.0, 0.05, n))
    src = rng.randint(0, n, (n, c))
    for i in np.flatnonzero(person >= 0):
        mates = np.flatnonzero(person == person[i])
        src[i, 0] = mates[(np.searchsorted(mates, i) + 1) % len(mates)]
    dst = np.repeat(np.arange(n), c).reshape(n, c)
    ev = (rng.rand(n, c) > 0.2) | (np.arange(c) == 0)
    same = (person[src] == person[dst]) & (person[src] >= 0)
    edge_pred = np.where(same, rng.uniform(0.85, 0.99, (n, c)), rng.uniform(0.0, 0.6, (n, c)))
    logits = rng.randn(n, j) + 8.0 * np.eye(j)[det[:, 2]]
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (f32(rng.rand(h, w, j)), f32(rng.randn(h, w, j)), det.astype(np.int32),
            f32(node_scores), np.stack([src.ravel(), dst.ravel()]).astype(np.int32),
            ev.ravel(), f32(edge_pred.ravel()), node_valid,
            f32(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)))


def phase_decode():
    """decode_poses on hand-built scenes that form persons, CPU against card."""
    from pemp_tpu_torch.decode.assembly import decode_poses

    rng = np.random.RandomState(4)
    scenes = [decode_scene(rng) for _ in range(2)]
    batch = [torch.from_numpy(np.stack(parts)) for parts in zip(*scenes)]
    runs = {}
    for dev in ("cpu", "cuda"):
        *args, class_probs = (t.to(dev) for t in batch)
        persons, valid = decode_poses(*args, node_threshold=0.1, num_joints=17,
                                      blocked_c=10, class_probs=class_probs)
        runs[dev] = (persons.cpu(), valid.cpu())
    (pc, vc), (pg, vg) = runs["cpu"], runs["cuda"]
    if int(vc.sum(dim=1).min()) < 2:
        raise SystemExit(f"decode: the hand-built scenes formed {vc.sum(dim=1).tolist()} persons")
    # coordinates are integers plus quarter offsets: exact; scores at 1e-6
    if not (torch.equal(vc, vg) and torch.equal(pc[..., :2], pg[..., :2])
            and (pc[..., 2] - pg[..., 2]).abs().max().item() <= 1e-6):
        raise SystemExit("decode: persons differ between CPU and card")
    log(f"decode: hand-built scenes, persons per image {vc.sum(dim=1).tolist()}, "
        f"equal on CPU and card")


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"capability {torch.cuda.get_device_capability(0)})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    from pemp_tpu_torch.ops import _build, fused_step

    t0 = time.perf_counter()
    report = _build.build_all()
    log(f"build: {sorted(report)} in {time.perf_counter() - t0:.1f} s "
        f"(into {_build.build_dir()})")
    for name, entry in sorted(report.items()):
        for line in entry["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name} ptxas: {line.strip()}")

    # 3. K1 against its plain version
    from pemp_tpu_torch.pipeline import BATCH, INPUT_SIZE, build_pipeline

    errs = []
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        args, dims = random_k1_inputs(dtype)
        errs.append(check_k1(f"random {str(dtype)[6:]}", args, dims, tol, fused_step)[0])
        del args
    batch, size = BATCH, INPUT_SIZE
    pipe = build_pipeline(batch, size, dtype=torch.bfloat16, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(0)
    images = torch.rand(batch, size, size, 3, generator=gen).cuda()
    captured = capture_k1_inputs(pipe, images)
    main_numbers = None
    for step in (0, 9):
        args = captured[step][:13]
        dims = captured[step][13:]
        numbers = check_k1(f"main path step {step} bf16", args, dims, 2e-2, fused_step)
        errs.append(numbers[0])
        if step == 0:
            main_numbers = numbers[1:]
    del captured, args

    # 4. small slice and decode, CPU against card
    phase_small_slice()
    phase_decode()

    # 5. main path at full width
    pipe(images)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    fused_step.LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(iters):
        persons, valid, scoremaps, out = pipe.forward(images)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fused_step.LAUNCHES
    steps = pipe.model.mpn.cfg["STEPS"]
    if launches != steps * iters:
        raise SystemExit(f"main path: K1 launched {launches} times in {iters} forwards, "
                         f"expected {steps * iters}")
    n = 17 * pipe.model.gc.nodes_per_type
    if tuple(persons.shape) != (batch, 30, 17, 3) or tuple(scoremaps.shape) != (
        batch, size // 2, size // 2, 17
    ):
        raise SystemExit(f"main path: unexpected shapes {tuple(persons.shape)}, "
                         f"{tuple(scoremaps.shape)}")
    for name, t in (("persons", persons), ("scoremaps", scoremaps),
                    ("edge logits", out["preds"]["edge"][-1]),
                    ("node logits", out["preds"]["node"][-1])):
        if not bool(torch.isfinite(t.float()).all()):
            raise SystemExit(f"main path: non-finite {name}")
    g = out["graph"]
    log(f"main path: w48/{size} batch {batch} bf16, {iters} forwards in {dt:.3f} s: "
        f"{batch * iters / dt:.2f} img/s on {card}; K1 launches {launches} "
        f"({launches // iters} per forward); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; valid nodes "
        f"{int(g['node_valid'].sum())}/{batch * n}; valid edges "
        f"{int(g['edge_valid'].sum())}/{g['edge_valid'].numel()}; persons found "
        f"{int(valid.sum())}")

    ms, plain_ms, bound, bound_by = main_numbers
    print(json.dumps({"kernels": [{
        "name": "fused_mpn_step", "route": "cuda",
        "source": "pemp_tpu_torch/csrc/fused_step.cu",
        "replaces": "pemp_tpu/ops/pallas/fused_step.py:252",
        "launches": launches, "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
