"""K2 and K2b, the typed message aggregation of the training path: the
port's plain version against the JAX Pallas kernel (interpret mode) and its
custom VJP. The CUDA kernels are held against the plain version in
tests/test_torch_cuda_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pemp_tpu.ops.pallas.fused_typed_message import (
    fused_typed_message_aggregate as jax_typed_message,
)
from pemp_tpu_torch.ops import typed_message


def _make(seed, n=8, c=10, t=4, d=8, de=6, attn_scale=1.0, all_valid=False):
    """The shapes of tests/test_fused_kernel.py, plus an empty (node, type)
    group and a node without a valid slot."""
    rng = np.random.RandomState(seed)
    ef = rng.randn(n * c, de).astype(np.float32)
    a = rng.randn(n, t, d).astype(np.float32)
    types = rng.randint(0, t, n * c).astype(np.int32)
    types[:c] = 0                       # node 0 sees type 0 only
    valid = np.ones(n * c, np.int32) if all_valid else (rng.rand(n * c) > 0.3).astype(np.int32)
    if not all_valid:
        valid[2 * c:3 * c] = 0          # node 2 has no valid slot
    we = rng.randn(de, t * d).astype(np.float32)
    wa = (rng.randn(de, 1) * attn_scale).astype(np.float32)
    g = rng.randn(n, t, d).astype(np.float32)
    return (ef, a, types, valid, we, wa), g, n, t


GRAD_CASES = {
    "seed0": dict(seed=0), "seed1": dict(seed=1), "seed2": dict(seed=2),
    # the CUDA kernels' widths (d = de = 64, T = 17, C = 80) over two of the
    # JAX kernel's 8-node tiles: the plain version, the card tests' oracle
    # for K2b, against the custom VJP at the shapes K2b runs
    "kernel_widths": dict(seed=4, n=16, c=80, t=17, d=64, de=64),
}
CASES = {
    **GRAD_CASES,
    # attention logits spanning far more than f32 exp's range: the per-row
    # max shift must keep every group's softmax alive (a forward check, as
    # tests/test_fused_kernel.py:118; its near one-hot softmax leaves the
    # logit gradients as cancellation noise)
    "wide_logit_spread": dict(seed=7, attn_scale=200.0, all_valid=True),
    # K2's bf16 form (the pallas eval path) at the CUDA kernels' widths: the
    # same numpy inputs rounded to bf16 go through the JAX kernel's bf16
    # branch (sel_dt) and the plain version; then ragged, C = 77 and
    # T = 14 (model_81_1_2's types)
    "kernel_widths_bf16": dict(seed=4, n=16, c=80, t=17, d=64, de=64, bf16=True),
    "ragged_bf16": dict(seed=5, n=16, c=77, t=14, d=64, de=64, bf16=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_matches_jax_kernel(case):
    kw = dict(CASES[case])
    bf16 = kw.pop("bf16", False)
    args, _, n, t = _make(**kw)
    floats = (0, 1, 4, 5)  # ef, a, we, w_attn
    jargs = [jnp.asarray(x, jnp.bfloat16 if bf16 and i in floats else None)
             for i, x in enumerate(args)]
    targs = [torch.from_numpy(x).to(torch.bfloat16) if bf16 and i in floats
             else torch.from_numpy(x) for i, x in enumerate(args)]
    want = np.asarray(jax_typed_message(*jargs, n, t, interpret=True))
    got = typed_message.fused_typed_message_plain(*targs, n, t)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    # tests/test_fused_kernel.py:39's tolerance (f32, another summation
    # order); in bf16 too: both sides take the same bf16 values, whose
    # products are exact in f32, and sum them in f32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    if case == "seed0":
        assert np.all(got.numpy()[2] == 0.0)          # no valid slot: all zero
        assert np.all(got.numpy()[0, 1:] == 0.0)      # empty groups give 0


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_plain_gradients_match_jax_custom_vjp(case):
    args, g, n, t = _make(**GRAD_CASES[case])
    ef, a, types, valid, we, wa = args

    def f_kernel(ef, a, we, wa):
        out = jax_typed_message(ef, a, jnp.asarray(types), jnp.asarray(valid), we, wa, n, t,
                                interpret=True)
        return jnp.sum(out * g)

    want = jax.grad(f_kernel, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (ef, a, we, wa)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (ef, a, we, wa)]
    out = typed_message.fused_typed_message_plain(
        leaves[0], leaves[1], torch.from_numpy(types), torch.from_numpy(valid),
        leaves[2], leaves[3], n, t)
    (out * torch.from_numpy(g)).sum().backward()
    # tests/test_fused_kernel.py:114's tolerance against the kernel's VJP
    for name, w_, x in zip(("ef", "a", "we", "wa"), want, leaves):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w_), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    # invalid slots get no gradient
    assert np.all(leaves[0].grad.numpy()[valid == 0] == 0.0)


def test_wrapper_routes_cpu_tensors_to_plain():
    args, _, n, t = _make(3)
    before = (typed_message.LAUNCHES_FWD, typed_message.LAUNCHES_BWD)
    ef = torch.from_numpy(args[0]).requires_grad_()
    tens = [torch.from_numpy(x) for x in args[1:]]
    got = typed_message.fused_typed_message_aggregate(ef, *tens, n, t)
    got.sum().backward()
    want = typed_message.fused_typed_message_plain(torch.from_numpy(args[0]), *tens, n, t)
    assert torch.equal(got.detach(), want)
    assert ef.grad is not None
    # the plain version launches nothing, forward or backward
    assert (typed_message.LAUNCHES_FWD, typed_message.LAUNCHES_BWD) == before
