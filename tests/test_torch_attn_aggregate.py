"""K3, K3b, K4 and K4b, the aggregations of the hybrid, einsum and dots
message paths: the port's plain versions against the JAX Pallas kernels
(interpret mode), K3's custom VJP and the JAX package's jnp aggregate and
its gradient. The CUDA kernels are held against the plain versions in
tests/test_torch_cuda_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pemp_tpu.ops.pallas.blocked_attn import blocked_per_type_attention_aggregate_pallas
from pemp_tpu.ops.pallas.fused_typed_message import fused_attn_aggregate as jax_attn_aggregate
from pemp_tpu.ops.segment import blocked_per_type_attention_aggregate as jax_segment_aggregate
from pemp_tpu_torch.ops import attn_aggregate, blocked_attn
from pemp_tpu_torch.ops.segment import blocked_per_type_attention_aggregate


def _make(seed, n=16, c=10, t=4, d=8, logit_scale=1.0, all_valid=False, full_node=None,
          empty_type=None):
    """Random inputs with an empty (node, type) group and a node without a
    valid slot; n * t and n * c multiples of 8 (the TPU kernels' tiling).
    ``full_node``: a node whose C slots are all valid and of type 1;
    ``empty_type``: a type with no valid slot."""
    rng = np.random.RandomState(seed)
    b = rng.randn(n * c, d).astype(np.float32)
    a = rng.randn(n, t, d).astype(np.float32)
    types = rng.randint(0, t, n * c).astype(np.int32)
    types[:c] = 0                       # node 0 sees type 0 only
    valid = np.ones(n * c, np.int32) if all_valid else (rng.rand(n * c) > 0.3).astype(np.int32)
    if not all_valid:
        valid[2 * c:3 * c] = 0          # node 2 has no valid slot
    if full_node is not None:
        types[full_node * c:(full_node + 1) * c] = 1
        valid[full_node * c:(full_node + 1) * c] = 1
    if empty_type is not None:
        valid[types == empty_type] = 0
    logits = (rng.randn(n * c) * logit_scale).astype(np.float32)
    g = rng.randn(n, t, d).astype(np.float32)
    return (b, a, types, valid, logits), g, n, t


GRAD_CASES = {"seed0": dict(seed=0), "seed1": dict(seed=1), "seed2": dict(seed=2)}
CASES = {
    **GRAD_CASES,
    # logits spanning far more than f32 exp's range: the per-group max
    # shift must keep every group's softmax alive (a forward check: the
    # near one-hot softmax leaves the logit gradients as cancellation noise)
    "wide_logit_spread": dict(seed=7, logit_scale=200.0, all_valid=True),
}


# K3b's factored backward: GRAD_CASES and one case at the kernel's widths
# (d = 64, T = 17, C = 80, 16 nodes; node 5's group fills all C slots)
BWD_CASES = {**GRAD_CASES, "kernel_widths": dict(seed=4, n=16, c=80, t=17, d=64, full_node=5)}


def _torch(args):
    return [torch.from_numpy(x) for x in args]


@pytest.mark.parametrize("case", sorted(CASES))
def test_k3_plain_forward_matches_jax_kernel(case):
    args, _, n, t = _make(**CASES[case])
    want = np.asarray(jax_attn_aggregate(*map(jnp.asarray, args), n, t, interpret=True))
    got = attn_aggregate.fused_attn_aggregate_plain(*_torch(args), n, t)
    # f32 on both sides, another summation order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if case == "seed0":
        assert np.all(got.numpy()[2] == 0.0)          # no valid slot: all zero
        assert np.all(got.numpy()[0, 1:] == 0.0)      # empty groups give 0


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_k3_plain_gradients_match_jax_custom_vjp(case):
    """db, da and dlogit: autograd through the plain version against the
    JAX kernel's backward kernel (K3b's TPU form)."""
    args, g, n, t = _make(**GRAD_CASES[case])
    b, a, types, valid, logits = args

    def f_kernel(b, a, logits):
        out = jax_attn_aggregate(b, a, jnp.asarray(types), jnp.asarray(valid), logits, n, t,
                                 interpret=True)
        return jnp.sum(out * g)

    want = jax.grad(f_kernel, argnums=(0, 1, 2))(*map(jnp.asarray, (b, a, logits)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (b, a, logits)]
    out = attn_aggregate.fused_attn_aggregate_plain(
        leaves[0], leaves[1], torch.from_numpy(types), torch.from_numpy(valid), leaves[2], n, t)
    (out * torch.from_numpy(g)).sum().backward()
    # tests/test_typed_einsum.py:173's tolerance for the kernel's VJP
    for name, w_, x in zip(("db", "da", "dlogit"), want, leaves):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w_), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    # invalid slots get no gradient
    assert np.all(leaves[0].grad.numpy()[valid == 0] == 0.0)
    assert np.all(leaves[2].grad.numpy()[valid == 0] == 0.0)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_k3b_factored_backward_matches_jax_custom_vjp_and_autograd(case):
    """fused_attn_aggregate_bwd_plain (K3b's one-pass math: scalars, then
    db, u, da, q, dlogit) against the JAX kernel's backward kernel and
    against autograd through the plain forward."""
    args, g, n, t = _make(**BWD_CASES[case])
    b, a, types, valid, logits = args

    def f_kernel(b, a, logits):
        out = jax_attn_aggregate(b, a, jnp.asarray(types), jnp.asarray(valid), logits, n, t,
                                 interpret=True)
        return jnp.sum(out * g)

    want = jax.grad(f_kernel, argnums=(0, 1, 2))(*map(jnp.asarray, (b, a, logits)))
    got = attn_aggregate.fused_attn_aggregate_bwd_plain(*_torch(args), torch.from_numpy(g), n, t)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (b, a, logits)]
    out = attn_aggregate.fused_attn_aggregate_plain(
        leaves[0], leaves[1], torch.from_numpy(types), torch.from_numpy(valid), leaves[2], n, t)
    autograd = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    # f32 on all sides, sums in other orders: 1e-5 of each output's largest
    for name, x, jx, ax in zip(("db", "da", "dlogit"), got, want, autograd):
        assert x.dtype == torch.float32 and x.shape == ax.shape, name
        for ref in (np.asarray(jx), ax.numpy()):
            err = np.abs(x.numpy() - ref).max()
            assert err <= 1e-5 * np.abs(ref).max(), (name, err, np.abs(ref).max())
    db, da, dlogit = (x.numpy() for x in got)
    # the slots of no group and the empty groups give exactly 0
    assert np.all(db[valid == 0] == 0.0) and np.all(dlogit[valid == 0] == 0.0)
    c = b.shape[0] // n
    sizes = np.bincount((np.arange(n * c) // c * t + types)[valid != 0],
                        minlength=n * t).reshape(n, t)
    assert (sizes == 0).any() and np.all(da[sizes == 0] == 0.0)
    if case == "kernel_widths":
        assert sizes.max() == c                     # a group holds all C slots


@pytest.mark.parametrize("seed", range(3))
def test_k4_plain_matches_jax_kernel_and_jnp_f32(seed):
    """f32: the plain version against the TPU kernel (interpret) and
    against the jnp aggregate the JAX einsum path runs."""
    (m, _, types, valid, attn), _, n, t = _make(seed + 10, d=64)
    jargs = (jnp.asarray(m), jnp.asarray(attn), jnp.asarray(types), n, t, jnp.asarray(valid))
    got = blocked_per_type_attention_aggregate(*_torch((m, attn, types)), n, t,
                                               torch.from_numpy(valid)).numpy()
    kernel = np.asarray(blocked_per_type_attention_aggregate_pallas(*jargs, interpret=True))
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_segment_aggregate(*jargs)), rtol=1e-5,
                               atol=1e-5)
    assert np.all(got[2] == 0.0) and np.all(got[0, 1:] == 0.0)


def test_k4_plain_matches_jax_kernel_bf16():
    """bf16 messages: both compute in f32 and round the output to bf16 once,
    so they agree to one bf16 rounding (2**-8 of the value). The jnp
    aggregate computes its softmax in bf16 itself and is further off; that
    gap is the JAX package's, not the port's."""
    (m, _, types, valid, attn), _, n, t = _make(21, d=64)
    mb = torch.from_numpy(m).to(torch.bfloat16)
    jm = jnp.asarray(mb.float().numpy()).astype(jnp.bfloat16)
    jargs = (jm, jnp.asarray(attn), jnp.asarray(types), n, t, jnp.asarray(valid))
    got = blocked_per_type_attention_aggregate(mb, torch.from_numpy(attn),
                                               torch.from_numpy(types), n, t,
                                               torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    kernel = np.asarray(blocked_per_type_attention_aggregate_pallas(*jargs, interpret=True),
                        np.float32)
    np.testing.assert_allclose(got.float().numpy(), kernel, rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_plain_matches_jax_kernel_at_kernel_widths(dtype):
    """At K4's widths (T = 17, C = 80, D = 64; 16 nodes): node 5's group
    holds all C slots and type 4 has no valid slot. f32: within 1e-5 (sums
    in another order); bf16 messages: both compute in f32 and round the
    output once, so they agree to one bf16 rounding, as
    test_k4_plain_matches_jax_kernel_bf16."""
    (m, _, types, valid, attn), _, n, t = _make(22, n=16, c=80, t=17, d=64, full_node=5,
                                                empty_type=4)
    c = m.shape[0] // n
    sizes = np.bincount((np.arange(n * c) // c * t + types)[valid != 0],
                        minlength=n * t).reshape(n, t)
    assert sizes.max() == c and np.all(sizes[:, 4] == 0)
    mt = torch.from_numpy(m).to(getattr(torch, dtype))
    jm = jnp.asarray(mt.float().numpy()).astype(dtype)
    got = blocked_per_type_attention_aggregate(mt, *_torch((attn, types)), n, t,
                                               torch.from_numpy(valid))
    assert got.dtype == mt.dtype
    kernel = np.asarray(blocked_per_type_attention_aggregate_pallas(
        jm, jnp.asarray(attn), jnp.asarray(types), n, t, jnp.asarray(valid), interpret=True),
        np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), kernel, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), kernel, rtol=2 ** -8, atol=1e-6)
    assert np.all(got.float().numpy()[sizes == 0] == 0.0)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_k4b_factored_backward_matches_jax_vjp_and_autograd(case):
    """blocked_attn_aggregate_bwd_plain (K4b's math: the weights from the
    logits, then dm, u, q, dlogit) against jax.vjp of the JAX package's jnp
    aggregate, which the JAX einsum and dots routes differentiate, and
    against autograd through the port's plain forward. The jnp aggregate
    lets the gradient through the group max and the port's plain version
    holds it constant; the max's gradient cancels, so all three give the
    factored formula: 1e-5 of each output's largest (f32, sums in other
    orders)."""
    (m, _, types, valid, attn), g, n, t = _make(**BWD_CASES[case])
    jtypes, jvalid = jnp.asarray(types), jnp.asarray(valid)
    _, vjp = jax.vjp(lambda m, attn: jax_segment_aggregate(m, attn, jtypes, n, t, jvalid),
                     jnp.asarray(m), jnp.asarray(attn))
    want = vjp(jnp.asarray(g))
    got = blocked_attn.blocked_attn_aggregate_bwd_plain(
        *_torch((m, attn, types, valid, g)), n, t)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (m, attn)]
    out = blocked_per_type_attention_aggregate(leaves[0], leaves[1], torch.from_numpy(types), n,
                                               t, torch.from_numpy(valid))
    autograd = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    for name, x, jx, ax in zip(("dm", "dlogit"), got, want, autograd):
        assert x.dtype == torch.float32 and x.shape == ax.shape, name
        for ref in (np.asarray(jx), ax.numpy()):
            err = np.abs(x.numpy() - ref).max()
            assert err <= 1e-5 * np.abs(ref).max(), (name, err, np.abs(ref).max())
    dm, dlogit = (x.numpy() for x in got)
    # the slots of no group give exactly 0
    assert np.all(dm[valid == 0] == 0.0) and np.all(dlogit[valid == 0] == 0.0)


def test_k4_wrapper_differentiates_cpu_tensors_through_the_plain_version():
    """On CPU tensors blocked_attn_aggregate is the plain version, and
    autograd through it gives K4b's factored math; nothing launches."""
    (m, _, types, valid, attn), g, n, t = _make(5, d=64)
    before = (blocked_attn.LAUNCHES, blocked_attn.LAUNCHES_BWD)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (m, attn)]
    out = blocked_attn.blocked_attn_aggregate(leaves[0], leaves[1], torch.from_numpy(types), n,
                                              t, torch.from_numpy(valid))
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    factored = blocked_attn.blocked_attn_aggregate_bwd_plain(
        *_torch((m, attn, types, valid, g)), n, t)
    for x, ref in zip(grads, factored):
        assert (x - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert (blocked_attn.LAUNCHES, blocked_attn.LAUNCHES_BWD) == before


def test_wrappers_route_cpu_tensors_to_plain():
    args, g, n, t = _make(3)
    before = (attn_aggregate.LAUNCHES_FWD, attn_aggregate.LAUNCHES_BWD, blocked_attn.LAUNCHES)
    b = torch.from_numpy(args[0]).requires_grad_()
    rest = _torch(args[1:])
    got = attn_aggregate.fused_attn_aggregate(b, *rest, n, t)
    (got * torch.from_numpy(g)).sum().backward()
    assert torch.equal(got.detach(), attn_aggregate.fused_attn_aggregate_plain(
        torch.from_numpy(args[0]), *rest, n, t))
    assert b.grad is not None
    m, attn, types, valid = (torch.from_numpy(x) for x in (args[0], args[4], args[2], args[3]))
    assert torch.equal(blocked_attn.blocked_attn_aggregate(m, attn, types, n, t, valid),
                       blocked_per_type_attention_aggregate(m, attn, types, n, t, valid))
    # the plain versions launch nothing, forward or backward
    assert (attn_aggregate.LAUNCHES_FWD, attn_aggregate.LAUNCHES_BWD,
            blocked_attn.LAUNCHES) == before
