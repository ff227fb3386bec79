"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from pemp_tpu_torch.ops import (
    attn_aggregate,
    blocked_attn,
    fused_step,
    gather_mm,
    launch_counts,
    typed_message,
)
from pemp_tpu_torch.ops.segment import blocked_per_type_attention_aggregate


def _k1_inputs(seed=2, imgs=2, n_img=16, c=8, t=4, w=64, one_type_nodes=3, empty_type=None):
    rng = np.random.RandomState(seed)
    n = imgs * n_img
    e = n * c
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    types = rng.randint(0, t, e).astype(np.int32)
    types[: one_type_nodes * c] = 0   # nodes 0-2 see one type only: empty groups
    valid = (rng.rand(e) > 0.2).astype(np.int32)
    valid[5 * c: 6 * c] = 0           # node 5 (where there is one) has no valid slot at all
    if empty_type is not None:        # no valid slot of this type anywhere
        valid[types == empty_type] = 0
    args = (
        f(n, w), f(n, w), f(e, w), f(e, w), f(n, t, w),
        rng.randint(0, n_img, e).astype(np.int32), types, valid,
        f(w, w) * 0.3, f(w, w) * 0.3, f(w) * 0.1, f(w, t * w) * 0.3, f(w, 1) * 0.3,
    )
    return args, n, t, n_img


K1_CASES = {
    # dtype, tolerance, _k1_inputs arguments
    "f32": (torch.float32, 1e-4, {}),
    "bf16": (torch.bfloat16, 2e-2, {}),
    # the flagship widths: 800 nodes fill 267 of the f32 form's 3-node
    # tiles, more than one launch's blocks, so blocks take several
    "f32_c80_t17": (torch.float32, 1e-4, dict(seed=13, imgs=4, n_img=200, c=80, t=17)),
    # ragged: C = 77 is no multiple of 16, and 100 nodes no multiple of the
    # 3-node tile
    "f32_c77_t14_ragged": (torch.float32, 1e-4, dict(seed=14, imgs=2, n_img=50, c=77, t=14)),
    # type 3 has no valid slot (and node 5 none at all)
    "f32_empty_type": (torch.float32, 1e-4,
                       dict(seed=15, imgs=2, n_img=20, c=80, t=17, empty_type=3)),
    # 3 nodes in all: one tile, one block
    "f32_n3": (torch.float32, 1e-4, dict(seed=16, imgs=1, n_img=3, c=80, t=17,
                                         one_type_nodes=0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_kernel_matches_plain_on_card(case):
    # f32 (the CUDA-core form): out and ne within 1e-4 absolute (sums in
    # another order than cuBLAS); in bf16 the edge carry rounds at the same
    # points but may land one ulp apart (2e-2, as tests/test_fused_step.py).
    # Empty groups give exactly 0, and, with no float atomics, a second call
    # the same bits.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype, tol, kw = K1_CASES[case]
    args, n, t, n_img = _k1_inputs(**kw)
    tens = [torch.from_numpy(a).cuda() for a in args]
    tens = [x.to(dtype) if x.is_floating_point() else x for x in tens]
    before = fused_step.LAUNCHES
    out_k, ne_k = fused_step.fused_mpn_step(*tens, n, t, n_img)
    out_2, ne_2 = fused_step.fused_mpn_step(*tens, n, t, n_img)
    out_p, ne_p = fused_step.fused_mpn_step_plain(*tens, n, t, n_img)
    torch.cuda.synchronize()
    assert fused_step.LAUNCHES == before + 2
    assert torch.equal(out_k, out_2) and torch.equal(ne_k, ne_2)
    if dtype == torch.float32:
        assert (out_k - out_p).abs().max().item() <= tol
        assert (ne_k - ne_p).abs().max().item() <= tol
    else:
        torch.testing.assert_close(out_k, out_p, atol=tol, rtol=tol)
        torch.testing.assert_close(ne_k.float(), ne_p.float(), atol=tol, rtol=tol)
    c = args[3].shape[0] // n
    cnt = np.zeros((n, t), np.int64)
    np.add.at(cnt, (np.arange(n * c) // c, args[6]), args[7])
    assert bool((out_k.cpu().numpy()[cnt == 0] == 0).all())


@pytest.mark.cuda
def test_bf16_kernel_ragged_and_repeatable():
    # the bf16 form (tensor cores) at a ragged shape: C = 77 is no multiple
    # of 16, T = 17, and 100 nodes of 50 per image fill no whole number of
    # its 3-node tiles. Its products add within a k16 step in another order
    # than cuBLAS, so an h or ef value may land one bf16 step (2^-8 of the
    # value) apart and move out with it: each output within 2e-2 of its
    # own largest value. No float atomics: a second call gives the same bits.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, n, t, n_img = _k1_inputs(seed=7, imgs=2, n_img=50, c=77, t=17)
    tens = [torch.from_numpy(a).cuda() for a in args]
    tens = [x.to(torch.bfloat16) if x.is_floating_point() else x for x in tens]
    before = fused_step.LAUNCHES
    out_k, ne_k = fused_step.fused_mpn_step(*tens, n, t, n_img)
    out_p, ne_p = fused_step.fused_mpn_step_plain(*tens, n, t, n_img)
    torch.cuda.synchronize()
    assert fused_step.LAUNCHES == before + 1
    for got, want in ((out_k, out_p), (ne_k.float(), ne_p.float())):
        assert bool(torch.isfinite(got).all())
        assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()
    out_2, ne_2 = fused_step.fused_mpn_step(*tens, n, t, n_img)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_2) and torch.equal(ne_k, ne_2)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    args, n, t, n_img = _k1_inputs(w=16)
    tens = [torch.from_numpy(a).cuda() for a in args]
    with pytest.raises(ValueError, match="row width"):
        fused_step.fused_mpn_step(*tens, n, t, n_img)


def _k2_inputs(seed=3, n=40, c=80, t=17, w=64, full_node=None, empty_type=None,
               gt_persons=None):
    rng = np.random.RandomState(seed)
    e = n * c
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    types = rng.randint(0, t, e).astype(np.int32)
    types[: 2 * c] = 0            # nodes 0-1 see one type only: empty groups
    valid = (rng.rand(e) > 0.3).astype(np.int32)
    valid[3 * c: 4 * c] = 0       # node 3 (where there is one) has no valid slot at all
    if gt_persons is not None:
        # the USE_GT layout, two images: gt_persons * t person-major GT
        # nodes (type = index mod t), then an invalid padded tail; each
        # valid node's slots name sources among its image's GT nodes
        n_img, m = n // 2, gt_persons * t
        node = np.arange(e) // c
        local = node % n_img
        src = node - local + rng.randint(0, m, e)
        types = (src % n_img % t).astype(np.int32)
        valid = ((local < m) & (rng.rand(e) > 0.3)).astype(np.int32)
    if full_node is not None:     # every slot valid and of type 1: a group of C rows
        types[full_node * c: (full_node + 1) * c] = 1
        valid[full_node * c: (full_node + 1) * c] = 1
    if empty_type is not None:    # no valid slot of this type anywhere
        valid[types == empty_type] = 0
    args = (f(e, w), f(n, t, w), types, valid, f(w, t * w) * 0.2, f(w, 1) * 0.3)
    return [torch.from_numpy(a).cuda() for a in args], f(n, t, w), n, t


K2_CASES = {
    # the flagship widths
    "c80": dict(),
    # K2b's batching at its edges: C = 77 is no multiple of 16 (nor of 4:
    # the scan's scalar loads), 150 nodes are no multiple of its 64-node
    # chunks (three blocks of 50 a type), and node 5's group holds all 77
    # slots, the most a batch of whole nodes must take at once
    "c77_ragged": dict(seed=8, n=150, c=77, full_node=5),
    # C > 128: batches of 256 rows, two register-tiled passes each; node 2's
    # group of 256 rows fills a whole batch
    "c256_full_batch": dict(seed=9, n=70, c=256, t=5, full_node=2),
    # type 4 has no valid slot: its three blocks (150 nodes, chunks of 50)
    # list zero rows and write only zeros
    "empty_type": dict(seed=10, n=150, empty_type=4),
    # fewer nodes than one chunk: one block a type, of 3 nodes
    "n3_one_chunk": dict(seed=11, n=3),
    # the USE_GT layout: 2 images of 17 * 8 nodes, 5 persons' GT joints
    # person-major (types cycling 0-16), then 51 invalid padded nodes each
    "use_gt_layout": dict(seed=12, n=272, gt_persons=5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_typed_message_kernels_match_plain_on_card(case):
    # K2 against the plain version, and K2b against autograd through it;
    # f32 sums in another order (1e-4, the JAX package's kernel tolerance,
    # of each output's own largest value)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    (ef, a, types, valid, we, wa), g, n, t = _k2_inputs(**K2_CASES[case])
    g = torch.from_numpy(g).cuda()
    c = types.numel() // n
    node = torch.arange(types.numel(), device="cuda") // c
    sizes = torch.bincount((node * t + types.long())[valid != 0], minlength=n * t)
    empty = (sizes == 0).view(n, t)
    leaves = [x.clone().requires_grad_() for x in (ef, a, we, wa)]
    before = (typed_message.LAUNCHES_FWD, typed_message.LAUNCHES_BWD)
    out_k = typed_message.fused_typed_message_aggregate(
        leaves[0], leaves[1], types, valid, leaves[2], leaves[3], n, t)
    grads_k = torch.autograd.grad((out_k * g).sum(), leaves)
    plain = [x.clone().requires_grad_() for x in (ef, a, we, wa)]
    out_p = typed_message.fused_typed_message_plain(
        plain[0], plain[1], types, valid, plain[2], plain[3], n, t)
    grads_p = torch.autograd.grad((out_p * g).sum(), plain)
    torch.cuda.synchronize()
    assert (typed_message.LAUNCHES_FWD, typed_message.LAUNCHES_BWD) == (before[0] + 1,
                                                                       before[1] + 1)
    for name, got, want in zip(("out", "ef", "a", "we", "w_attn"), (out_k, *grads_k),
                               (out_p, *grads_p)):
        if case == "c80":
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4, msg=name)
        assert bool(torch.isfinite(got).all()), name
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item(), name
    assert bool((grads_k[0][valid == 0] == 0).all())
    assert bool(empty.any())
    # an empty (node, type) group: out and da exactly 0 (node 3: no group at all)
    assert bool((out_k[empty] == 0).all()) and bool((grads_k[1][empty] == 0).all())
    # no float atomics, the sums across blocks in a fixed order: the same bits again
    out_2 = typed_message.fused_typed_message_aggregate(
        leaves[0], leaves[1], types, valid, leaves[2], leaves[3], n, t)
    again = torch.autograd.grad((out_2 * g).sum(), leaves)
    assert torch.equal(out_k, out_2)
    for first, second in zip(grads_k, again):
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_typed_message_bf16_kernel_matches_plain_on_card(case):
    # K2's bf16 form (the pallas eval path, on the tensor cores) against the
    # plain version on the same bf16 inputs: both take exact bf16 products
    # and sum them in f32, in another order, so 1e-4 of the largest output.
    # Empty groups give exactly 0 over memory a NaN-filled tensor left; a
    # second call gives the same bits; a gradient is refused (K2b is f32).
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    (ef, a, types, valid, we, wa), _, n, t = _k2_inputs(**K2_CASES[case])
    ef, a, we, wa = (x.to(torch.bfloat16) for x in (ef, a, we, wa))
    c = types.numel() // n
    node = torch.arange(types.numel(), device="cuda") // c
    sizes = torch.bincount((node * t + types.long())[valid != 0], minlength=n * t)
    empty = (sizes == 0).view(n, t)
    before = typed_message.LAUNCHES_FWD
    _nan_garbage(a.float())                    # out: (N, T, 64) float32
    out_k = typed_message.fused_typed_message_aggregate(ef, a, types, valid, we, wa, n, t)
    out_p = typed_message.fused_typed_message_plain(ef, a, types, valid, we, wa, n, t)
    torch.cuda.synchronize()
    assert typed_message.LAUNCHES_FWD == before + 1 and out_k.dtype == torch.float32
    assert bool(torch.isfinite(out_k).all())
    assert (out_k - out_p).abs().max().item() <= 1e-4 * out_p.abs().max().item()
    assert bool(empty.any()) and bool((out_k[empty] == 0).all())
    assert torch.equal(out_k, typed_message.fused_typed_message_aggregate(
        ef, a, types, valid, we, wa, n, t))
    with pytest.raises(ValueError, match="forward only"):
        typed_message.fused_typed_message_aggregate(ef.clone().requires_grad_(), a, types,
                                                    valid, we, wa, n, t)


def _k3_inputs(dtype, seed=4, n=40, c=80, t=17, w=64, full_node=None, empty_type=None):
    """K3's inputs, with empty groups and a node without a valid slot (node
    3, where there is one); ``full_node``: a node whose C slots are all valid
    and of type 1; ``empty_type``: a type with no valid slot. And a
    cotangent."""
    rng = np.random.RandomState(seed)
    e = n * c
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()  # noqa: E731
    types = rng.randint(0, t, e).astype(np.int32)
    types[: 2 * c] = 0
    valid = (rng.rand(e) > 0.3).astype(np.int32)
    valid[3 * c: 4 * c] = 0
    if full_node is not None:
        types[full_node * c: (full_node + 1) * c] = 1
        valid[full_node * c: (full_node + 1) * c] = 1
    if empty_type is not None:
        valid[types == empty_type] = 0
    i = lambda x: torch.from_numpy(x).cuda()  # noqa: E731
    return (f(e, w).to(dtype), f(n, t, w).to(dtype), i(types), i(valid), f(e)), f(n, t, w), n, t


K3_CASES = {
    # the flagship widths
    "c80": dict(),
    # C = 77 is no multiple of 32 (the scalars' slot chunks) nor of 8 (the
    # rows in flight); node 5's group holds all 77 slots
    "c77_ragged": dict(seed=8, n=150, c=77, full_node=5),
    # C = 256, the most a warp takes: 8 slots a lane; node 2 is one group of
    # 256 rows, 32 batches of rows
    "c256_full_node": dict(seed=9, n=70, c=256, t=5, full_node=2),
    # type 4 has no valid slot anywhere: its rows are zeros in every node
    "empty_type": dict(seed=10, n=150, empty_type=4),
    # fewer nodes than one block's warps
    "n3": dict(seed=11, n=3),
}


def _nan_garbage(*like):
    """Fills and frees tensors shaped as ``like`` with NaN, so that the
    caching allocator hands that memory to the next torch.empty of the same
    size: outputs the kernels leave unwritten would show as NaN."""
    junk = [torch.full_like(x, float("nan")) for x in like]
    torch.cuda.synchronize()
    del junk


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_attn_aggregate_kernels_match_plain_on_card(case):
    # K3 (f32 and bf16) against the plain version, both computing in f32:
    # f32 within 1e-4 of each output's largest (sums in another order), bf16
    # within 2e-2 (the inputs are rounded to bf16 alike; 2e-2 as the other
    # bf16 kernels); K3b against autograd through the plain version and
    # against its factored plain form, 1e-4 of each largest. The slots of no
    # group and the empty groups give exactly 0, over memory a NaN-filled
    # tensor left behind; a second call gives the same bits.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    kw = K3_CASES[case]
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        (b, a, types, valid, logits), g, n, t = _k3_inputs(dtype, **kw)
        c = types.numel() // n
        node = torch.arange(types.numel(), device="cuda") // c
        sizes = torch.bincount((node * t + types.long())[valid != 0], minlength=n * t)
        empty = (sizes == 0).view(n, t)
        assert bool(empty.any())
        if "full_node" in kw:
            assert int(sizes.max()) == c
        before = (attn_aggregate.LAUNCHES_FWD, attn_aggregate.LAUNCHES_BWD)
        _nan_garbage(a.float())                # out: (N, T, 64) float32
        out_k = attn_aggregate.fused_attn_aggregate(b, a, types, valid, logits, n, t)
        out_p = attn_aggregate.fused_attn_aggregate_plain(b, a, types, valid, logits, n, t)
        torch.cuda.synchronize()
        assert attn_aggregate.LAUNCHES_FWD == before[0] + 1
        assert bool(torch.isfinite(out_k).all())
        assert (out_k - out_p).abs().max().item() <= tol * out_p.abs().max().item()
        assert bool((out_k[empty] == 0).all())
        assert torch.equal(out_k, attn_aggregate.fused_attn_aggregate(b, a, types, valid,
                                                                      logits, n, t))
        if dtype != torch.float32:
            leaves = [x.clone().requires_grad_() for x in (b, a, logits)]
            out = attn_aggregate.fused_attn_aggregate(leaves[0], leaves[1], types, valid,
                                                      leaves[2], n, t)
            with pytest.raises(ValueError, match="float32 only"):
                out.sum().backward()
            continue

        def kernel_grads():
            leaves = [x.clone().requires_grad_() for x in (b, a, logits)]
            out = attn_aggregate.fused_attn_aggregate(leaves[0], leaves[1], types, valid,
                                                      leaves[2], n, t)
            _nan_garbage(b, a, logits)
            return torch.autograd.grad(out, leaves, g)

        grads_k = kernel_grads()
        plain = [x.clone().requires_grad_() for x in (b, a, logits)]
        grads_p = torch.autograd.grad(attn_aggregate.fused_attn_aggregate_plain(
            plain[0], plain[1], types, valid, plain[2], n, t), plain, g)
        factored = attn_aggregate.fused_attn_aggregate_bwd_plain(b, a, types, valid, logits, g,
                                                                 n, t)
        torch.cuda.synchronize()
        assert attn_aggregate.LAUNCHES_BWD == before[1] + 1
        for name, gk, gp, gf in zip(("db", "da", "dlogit"), grads_k, grads_p, factored):
            assert bool(torch.isfinite(gk).all()), name
            for ref in (gp, gf):
                assert (gk - ref).abs().max().item() <= 1e-4 * ref.abs().max().item(), name
        db, da, dlogit = grads_k
        assert bool((db[valid == 0] == 0).all() and (dlogit[valid == 0] == 0).all())
        assert bool((da[empty] == 0).all())
        for first, second in zip(grads_k, kernel_grads()):
            assert torch.equal(first, second)


@pytest.mark.cuda
def test_attn_aggregate_rejects_what_it_does_not_take():
    # lane t of a warp keeps type t's scalars: T <= 32
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    (b, a, types, valid, logits), _, n, t = _k3_inputs(torch.float32, n=4, t=33)
    with pytest.raises(ValueError, match="types"):
        attn_aggregate.fused_attn_aggregate(b, a, types, valid, logits, n, t)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K3_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_blocked_attn_kernel_matches_plain_on_card(case, dtype, tol):
    # K4 against the plain version, both computing in f32: within 1e-4 of
    # the largest output in f32 (sums in another order); in bf16 the output
    # rounds once and may land one step apart (2e-2). The empty groups give
    # exactly 0, over memory a NaN-filled tensor left behind; a second call
    # gives the same bits. In f32, K4 on relu(a_sel + b) equals K3 on
    # (b, a) bit for bit: the same weights and the same fused multiply-adds
    # in the same order (the card shows it).
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    kw = K3_CASES[case]
    (b, a, types, valid, logits), _, n, t = _k3_inputs(dtype, **kw)
    c = b.shape[0] // n
    node = torch.arange(b.shape[0], device="cuda") // c
    sizes = torch.bincount((node * t + types.long())[valid != 0], minlength=n * t)
    empty = (sizes == 0).view(n, t)
    assert bool(empty.any())
    if "full_node" in kw:
        assert int(sizes.max()) == c
    m = torch.relu(a[node, types.long()].float() + b.float()).to(dtype)
    before = blocked_attn.LAUNCHES
    _nan_garbage(a)                            # out: (N, T, 64) in m's dtype
    out_k = blocked_attn.blocked_attn_aggregate(m, logits, types, n, t, valid)
    out_p = blocked_per_type_attention_aggregate(m, logits, types, n, t, valid)
    torch.cuda.synchronize()
    assert blocked_attn.LAUNCHES == before + 1 and out_k.dtype == dtype
    if case == "c80":
        torch.testing.assert_close(out_k.float(), out_p.float(), atol=tol, rtol=tol)
    assert bool(torch.isfinite(out_k).all())
    got, want = out_k.float(), out_p.float()
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()
    assert bool((out_k[empty] == 0).all())
    assert torch.equal(out_k, blocked_attn.blocked_attn_aggregate(m, logits, types, n, t, valid))
    if dtype == torch.float32:
        assert torch.equal(out_k, attn_aggregate.fused_attn_aggregate(b, a, types, valid,
                                                                      logits, n, t))
    # K4b, the backward (f32 only): against its factored plain form and
    # against autograd through the plain version, 1e-4 of each output's
    # largest; the slots of no group exactly 0 over NaN-filled memory; the
    # same bits again
    g = torch.randn(n, t, 64, generator=torch.Generator().manual_seed(len(case))).cuda()

    def kernel_grads():
        leaves = [m.clone().requires_grad_(), logits.clone().requires_grad_()]
        out = blocked_attn.blocked_attn_aggregate(leaves[0], leaves[1], types, n, t, valid)
        _nan_garbage(m.float(), logits)
        return torch.autograd.grad(out, leaves, g.to(out.dtype))

    if dtype != torch.float32:
        with pytest.raises(ValueError, match="float32 only"):
            kernel_grads()
        return
    before = blocked_attn.LAUNCHES_BWD
    grads_k = kernel_grads()
    plain = [m.clone().requires_grad_(), logits.clone().requires_grad_()]
    grads_p = torch.autograd.grad(blocked_per_type_attention_aggregate(
        plain[0], plain[1], types, n, t, valid), plain, g)
    factored = blocked_attn.blocked_attn_aggregate_bwd_plain(m, logits, types, valid, g, n, t)
    torch.cuda.synchronize()
    assert blocked_attn.LAUNCHES_BWD == before + 1
    for name, gk, gp, gf in zip(("dm", "dlogit"), grads_k, grads_p, factored):
        assert bool(torch.isfinite(gk).all()), name
        for ref in (gp, gf):
            assert (gk - ref).abs().max().item() <= 1e-4 * ref.abs().max().item(), name
    dm, dlogit = grads_k
    assert bool((dm[valid == 0] == 0).all() and (dlogit[valid == 0] == 0).all())
    for first, second in zip(grads_k, kernel_grads()):
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_blocked_attn_rejects_what_it_does_not_take():
    # lane t of a warp keeps type t's scalars: T <= 32; a lane loads two
    # values of a row at once: m aligned to two of its values
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    (b, _, types, valid, logits), _, n, t = _k3_inputs(torch.float32, n=4, t=33)
    with pytest.raises(ValueError, match="types"):
        blocked_attn.blocked_attn_aggregate(b, logits, types, n, t, valid)
    (b, _, types, valid, logits), _, n, t = _k3_inputs(torch.float32, n=4)
    shifted = torch.empty(b.numel() + 1, device="cuda")[1:].view_as(b).copy_(b)
    with pytest.raises(ValueError, match="aligned"):
        blocked_attn.blocked_attn_aggregate(shifted, logits, types, n, t, valid)


G1_CASES = {
    # (images, nodes an image, slots an image, width, dtype, slots naming
    # each image's node 0); the kNN layout points every invalid slot at it
    "c80": (2, 136, 136 * 80, 64, torch.float32, 2000),
    # a row of 5000 slots: 79 pieces of at most 64
    "heavy_row": (1, 40, 9000, 64, torch.float32, 5000),
    # 130 columns: a lane owns column pairs 2l and 64 + 2l, and only lane 0
    # the last pair
    "wide_ragged": (3, 30, 700, 130, torch.float32, 0),
    # bf16 rows and cotangent: summed in f32, rounded once
    "bf16": (2, 136, 136 * 80, 64, torch.bfloat16, 2000),
    # most rows named by no slot: zeros
    "sparse": (2, 500, 60, 64, torch.float32, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(G1_CASES))
def test_gather_backward_kernel_matches_plain_on_card(case):
    # G1 against its plain version on the CPU: the same sums in the same
    # order (each piece in slot order, then a row's pieces), so the same
    # bits; against the plain version on the card (index_add_, whose
    # atomics add in no fixed order) within 1e-5 of the largest (bf16: the
    # f32 sums may round to neighbouring bf16 values, 2^-8). Rows no
    # slot names are exactly 0 over NaN-filled memory; a second call gives
    # the same bits.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    imgs, n_img, e_img, d, dtype, heavy = G1_CASES[case]
    rng = np.random.RandomState(sorted(G1_CASES).index(case))
    local = rng.randint(0, n_img, (imgs, e_img))
    local[:, :heavy] = 0
    j = torch.from_numpy((local + np.arange(imgs)[:, None] * n_img).ravel())
    n = imgs * n_img
    g = torch.from_numpy(rng.randn(j.numel(), d).astype(np.float32)).to(dtype)
    plan_cpu = gather_mm.gather_plan(j, n_img, n)
    want = gather_mm.gather_rows_bwd_plain(g, plan_cpu, n, dtype)
    jc, gc = j.cuda(), g.cuda()
    plan = gather_mm.gather_plan(jc, n_img, n)
    for key in plan:
        assert torch.equal(plan[key].cpu(), plan_cpu[key]), key
    before = gather_mm.LAUNCHES
    _nan_garbage(torch.empty(n, d, dtype=dtype, device="cuda"))
    got = gather_mm.gather_rows_bwd(gc, plan, n, dtype)
    on_card = gather_mm.gather_rows_bwd_plain(gc, plan, n, dtype)
    torch.cuda.synchronize()
    assert gather_mm.LAUNCHES == before + 1 and got.dtype == dtype
    assert torch.equal(got.cpu(), want)
    err = (got.float() - on_card.float()).abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2 ** -8      # bf16: one rounding step
    assert err <= tol * on_card.float().abs().max().item()
    named = torch.zeros(n, dtype=torch.bool)
    named[j] = True
    assert bool((got.cpu()[~named] == 0).all())
    assert torch.equal(got, gather_mm.gather_rows_bwd(gc, plan, n, dtype))
    # through the autograd Function: forward x[j], backward G1
    x = torch.randn(n, d, device="cuda").to(dtype).requires_grad_()
    out = gather_mm.gather_rows_mm_or_plain(x, jc, n_img, plan)
    assert torch.equal(out, x.detach()[jc])
    (dx,) = torch.autograd.grad(out, x, gc)
    assert gather_mm.LAUNCHES == before + 3 and torch.equal(dx, got)


K1B_COTANGENTS = ("both", "ne only", "out only")
K1B_GRADS = ("dp", "dh_node", "dq", "dcur", "da", "dw_cur", "dw_e1", "db_e1", "dwe", "dw_attn")
K1B_CASES = {
    "c24_t5": dict(seed=9, n_img=20, c=24, t=5),
    # the flagship widths over 800 nodes: more nodes than one launch's
    # blocks, so blocks take several
    "c80_t17": dict(seed=17, imgs=4, n_img=200, c=80, t=17),
    # ragged: C = 77 is no multiple of 16, 100 nodes no multiple of K1's
    # 3-node tile
    "c77_t14_ragged": dict(seed=18, imgs=2, n_img=50, c=77, t=14),
    # type 3 has no valid slot (and node 5 none at all)
    "empty_type": dict(seed=19, imgs=2, n_img=20, c=80, t=17, empty_type=3),
    # 3 nodes in all
    "n3": dict(seed=20, imgs=1, n_img=3, c=80, t=17, one_type_nodes=0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("which", K1B_COTANGENTS)
@pytest.mark.parametrize("case", sorted(K1B_CASES))
def test_fused_step_backward_matches_autograd_on_card(case, which):
    # K1's autograd Function on the card (forward K1's f32 form; backward
    # K2b on the tail, K1b on the edge MLP, G1 on the source gather) against
    # autograd through the plain version, TF32 off: each of the ten
    # gradients within 1e-4 of its own largest value (sums in other orders),
    # a second backward with the same bits. With no cotangent on out (a
    # pass whose nodes reach no head) K2b does not launch and a, we and
    # w_attn get no gradient; with none on ne, K1b takes K2b's d_ef alone.
    # Then K1b alone against its plain factored form on the same inputs:
    # each output within 1e-4 of its largest, a second call the same bits.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, n, t, n_img = _k1_inputs(**K1B_CASES[case])
    rng = np.random.RandomState(19)
    g_out = torch.from_numpy(rng.randn(n, t, 64).astype(np.float32)).cuda()
    g_ne = torch.from_numpy(rng.randn(args[3].shape[0], 64).astype(np.float32)).cuda()
    g_out = None if which == "ne only" else g_out
    g_ne = None if which == "out only" else g_ne
    tens = [torch.from_numpy(a).cuda() for a in args]
    plan = gather_mm.gather_plan(tens[5], n_img, n)

    def grads(fn, **kw):
        leaves = [x.clone().requires_grad_() if x.is_floating_point() else x for x in tens]
        outs = fn(*leaves, n, t, n_img, **kw)
        pairs = [(o, g) for o, g in zip(outs, (g_out, g_ne)) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs],
                                   [x for x in leaves if x.is_floating_point()],
                                   [g for _, g in pairs], allow_unused=True)

    before = launch_counts()
    got = grads(fused_step.fused_mpn_step, plan=plan)
    again = grads(fused_step.fused_mpn_step, plan=plan)
    want = grads(fused_step.fused_mpn_step_plain)
    torch.cuda.synchronize()
    after = launch_counts()
    k2b = 0 if g_out is None else 2
    assert {k: after[k] - before[k] for k in after} == {
        **{k: 0 for k in after}, "K1": 2, "K1b": 2, "K2b": k2b, "G1": 2}
    for name, x, x2, y in zip(K1B_GRADS, got, again, want):
        if y is None:
            assert x is None and g_out is None and name in ("da", "dwe", "dw_attn"), name
            continue
        assert torch.equal(x, x2), name
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item(), name

    p, h_node, q, cur, a, src, types, valid, w_cur, w_e1, b_e1, we, w_attn = tens
    with torch.no_grad():
        _, ne = fused_step.fused_mpn_step(*tens, n, t, n_img)
        g_agg = None
        if g_out is not None:
            g_agg = typed_message._launch_backward(ne, a, types, valid, we, w_attn, g_out, n,
                                                   t)[0]
        k1b_args = (p, h_node, q, cur, src, w_cur, w_e1, ne, g_ne, g_agg, n, n_img)
        got = fused_step._launch_backward(*k1b_args)
        again = fused_step._launch_backward(*k1b_args)
        want = fused_step.fused_step_bwd_plain(*k1b_args)
    torch.cuda.synchronize()
    for name, x, x2, y in zip(("dq", "dcur", "dh_node", "dw_cur", "dw_e1", "db_e1"), got, again,
                              want):
        assert torch.equal(x, x2), name
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item(), name


@pytest.mark.cuda
def test_fused_step_backward_refuses_what_it_does_not_take():
    # bf16 inputs that need a gradient (K1b runs in float32 only), and a
    # gradient to p without the forward's gather plan
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    args, n, t, n_img = _k1_inputs()
    tens = [torch.from_numpy(a).cuda() for a in args]
    half = [x.to(torch.bfloat16) if x.is_floating_point() else x for x in tens]
    half[3].requires_grad_()
    with pytest.raises(ValueError, match="forward only"):
        fused_step.fused_mpn_step(*half, n, t, n_img)
    tens[0].requires_grad_()
    with pytest.raises(ValueError, match="gather_plan"):
        fused_step.fused_mpn_step(*tens, n, t, n_img)
