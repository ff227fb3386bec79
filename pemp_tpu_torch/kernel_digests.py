"""Digests of the kernels' outputs on seeded inputs, to compare two builds
of the port bit for bit on one card.

    python pemp_tpu_torch/kernel_digests.py
    PYTHONPATH=<other checkout> python pemp_tpu_torch/kernel_digests.py

Runs K2 and K2b (``ops.typed_message``), K2's bf16 form on the same
inputs rounded to bf16, K3 and K3b (``ops.attn_aggregate``) and K4 in f32
and bf16 (``ops.blocked_attn``, forward) at the model_58_4 training shapes
(B = 8: N = 5440, T = 17, C = 80, widths 64) on inputs made from seed 1;
then K1's f32 form (``ops.fused_step``: out, ne), K1b on that ne and
seeded cotangents (its six outputs), K1's bf16 form on the same inputs
rounded to bf16 (out, ne) and K1's autograd Function (K2b, K1b and G1:
its ten gradients) on inputs made from seed 21 as
``chip_smoke.random_k1_inputs`` makes them. Prints the package it
imported, then one line per output: its name and the first 16 hex digits
of the sha256 of its float32 bytes. Two checkouts whose lines agree
computed the same bits on this card. The digests depend on the card and
the toolchain, so they are compared within one run, never kept. Needs a
CUDA card.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

import pemp_tpu_torch
from pemp_tpu_torch.ops import attn_aggregate, blocked_attn, fused_step, gather_mm, typed_message

K1_GRADS = ("dp", "dh_node", "dq", "dcur", "da", "dw_cur", "dw_e1", "db_e1", "dwe", "dw_attn")
K1B_OUTPUTS = ("dq", "dcur", "dh_node", "dw_cur", "dw_e1", "db_e1")


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_digests needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(1)
    n, t, c, w = 5440, 17, 80, 64
    e = n * c
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()  # noqa: E731
    i = lambda x: torch.from_numpy(x.astype(np.int32)).cuda()  # noqa: E731
    ef, a = f(e, w), f(n, t, w)
    types, valid = i(rng.randint(0, t, e)), i(rng.rand(e) > 0.3)
    we, wa = f(w, t * w) * 0.2, f(w, 1) * 0.2
    g, logits = f(n, t, w), f(e)

    print("package", pemp_tpu_torch.__file__)
    leaves = [x.clone().requires_grad_() for x in (ef, a, we, wa)]
    out = typed_message.fused_typed_message_aggregate(leaves[0], leaves[1], types, valid,
                                                      leaves[2], leaves[3], n, t)
    print("K2", _digest(out))
    print("K2b", _digest(*torch.autograd.grad(out, leaves, g)))
    with torch.no_grad():
        bf = [x.bfloat16() for x in (ef, a, we, wa)]
        print("K2 bf16", _digest(typed_message.fused_typed_message_aggregate(
            bf[0], bf[1], types, valid, bf[2], bf[3], n, t)))
    leaves = [x.clone().requires_grad_() for x in (ef, a, logits)]
    out = attn_aggregate.fused_attn_aggregate(leaves[0], leaves[1], types, valid, leaves[2], n, t)
    print("K3", _digest(out))
    print("K3b", _digest(*torch.autograd.grad(out, leaves, g)))
    with torch.no_grad():
        print("K4", _digest(blocked_attn.blocked_attn_aggregate(ef, logits, types, n, t, valid)))
        print("K4 bf16", _digest(blocked_attn.blocked_attn_aggregate(ef.bfloat16(), logits,
                                                                     types, n, t, valid)))
    del ef, a, g, logits, leaves, out
    _k1_digests()


def _k1_inputs(seed=21, b=8, j=17, k=40, c=80, w=64):
    """K1's inputs as chip_smoke.random_k1_inputs makes them (f32)."""
    rng = np.random.RandomState(seed)
    n_img = j * k
    n = b * n_img
    e = n * c
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()  # noqa: E731
    i = lambda x: torch.from_numpy(x.astype(np.int32)).cuda()  # noqa: E731
    args = (f(n, w), f(n, w), f(e, w), f(e, w), f(n, j, w),
            i(rng.randint(0, n_img, e)), i(rng.randint(0, j, e)), i(rng.rand(e) > 0.2),
            f(w, w) * 0.2, f(w, w) * 0.2, f(w) * 0.1, f(w, j * w) * 0.2, f(w, 1) * 0.2)
    return args, (n, j, n_img)


def _k1_digests() -> None:
    args, dims = _k1_inputs()
    n, t, n_img = dims
    rng = np.random.RandomState(22)
    g_out = torch.from_numpy(rng.randn(n, t, 64).astype(np.float32)).cuda()
    g_ne = torch.from_numpy(rng.randn(args[3].shape[0], 64).astype(np.float32)).cuda()
    g_agg = torch.from_numpy(rng.randn(args[3].shape[0], 64).astype(np.float32)).cuda()
    with torch.no_grad():
        out, ne = fused_step.fused_mpn_step(*args, *dims)
        print("K1 f32 out", _digest(out))
        print("K1 f32 ne", _digest(ne))
        p, h_node, q, cur, _, src, _, _, w_cur, w_e1 = args[:10]
        k1b = fused_step._launch_backward(p, h_node, q, cur, src, w_cur, w_e1, ne, g_ne, g_agg,
                                          n, n_img)
        for name, x in zip(K1B_OUTPUTS, k1b):
            print(f"K1b {name}", _digest(x))
        bf = [x.bfloat16() if x.is_floating_point() else x for x in args]
        for name, x in zip(("out", "ne"), fused_step.fused_mpn_step(*bf, *dims)):
            print(f"K1 bf16 {name}", _digest(x))
    del out, ne, k1b, bf
    floats = (0, 1, 2, 3, 4, 8, 9, 10, 11, 12)
    leaves = [x.clone().requires_grad_() if i in floats else x for i, x in enumerate(args)]
    plan = gather_mm.gather_plan(args[5], n_img, n)
    outs = fused_step.fused_mpn_step(*leaves, *dims, plan=plan)
    grads = torch.autograd.grad(outs, [leaves[i] for i in floats], (g_out, g_ne))
    for name, x in zip(K1_GRADS, grads):
        print(f"K1 backward {name}", _digest(x))


if __name__ == "__main__":
    main()
