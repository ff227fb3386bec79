"""Digests of the f32 kernels' outputs on seeded inputs, to compare two
builds of the port bit for bit on one card.

    python pemp_tpu_torch/kernel_digests.py
    PYTHONPATH=<other checkout> python pemp_tpu_torch/kernel_digests.py

Runs K2 and K2b (``ops.typed_message``), K3 and K3b
(``ops.attn_aggregate``) and K4 in f32 and bf16 (``ops.blocked_attn``,
forward) at the model_58_4 training shapes (B = 8: N = 5440, T = 17,
C = 80, widths 64) on inputs made from seed 1, and prints the package it
imported, then one line per kernel: its name and the first 16 hex digits
of the sha256 of its outputs' float32 bytes. Two checkouts whose lines
agree computed the same bits on this card. The digests depend on the card
and the toolchain, so they are compared within one run, never kept. Needs
a CUDA card.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

import pemp_tpu_torch
from pemp_tpu_torch.ops import attn_aggregate, blocked_attn, typed_message


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
    leaves = [x.clone().requires_grad_() for x in (ef, a, logits)]
    out = attn_aggregate.fused_attn_aggregate(leaves[0], leaves[1], types, valid, leaves[2], n, t)
    print("K3", _digest(out))
    print("K3b", _digest(*torch.autograd.grad(out, leaves, g)))
    with torch.no_grad():
        print("K4", _digest(blocked_attn.blocked_attn_aggregate(ef, logits, types, n, t, valid)))
        print("K4 bf16", _digest(blocked_attn.blocked_attn_aggregate(ef.bfloat16(), logits,
                                                                     types, n, t, valid)))


if __name__ == "__main__":
    main()
