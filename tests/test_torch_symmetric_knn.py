"""The symmetric target-major kNN layout and the reverse-edge permutation of
the hybrid and einsum message paths: the port against the JAX package,
exactly, on tie-heavy integer positions, and the involution itself."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pemp_tpu.graph.constructor import GCConfig as JaxGCConfig
from pemp_tpu.graph.constructor import construct_graph_batch as jax_construct
from pemp_tpu.ops.knn import knn_edges_target_major as jax_knn
from pemp_tpu.ops.knn import reverse_edge_perm as jax_reverse_edge_perm
from pemp_tpu_torch.config import small
from pemp_tpu_torch.graph.constructor import GCConfig, construct_graph_batch
from pemp_tpu_torch.ops.knn import knn_edges_target_major, reverse_edge_perm


def _graphs(cap, trials=3, n=40, k=8, seed=1):
    """Symmetric layouts on a 6x6 grid (many equal distances) with a quarter
    of the nodes invalid: JAX's and the port's, per trial."""
    rng = np.random.RandomState(seed)
    for _ in range(trials):
        pos = rng.randint(0, 6, (n, 2)).astype(np.float32)
        valid = rng.rand(n) > 0.25
        want = jax_knn(jnp.asarray(pos), jnp.asarray(valid), k, cap, symmetric=True)
        got = knn_edges_target_major(torch.from_numpy(pos), torch.from_numpy(valid), k, cap,
                                     symmetric=True)
        yield want, got, n


@pytest.mark.parametrize("cap", [2, 3, None])
def test_symmetric_layout_and_reverse_perm_exact(cap):
    """Every slot, invalid ones included: edge ids, validity and R (an
    invalid slot's R is src * C, the first candidate, on both sides)."""
    for (ei_w, ev_w), (ei_g, ev_g), n in _graphs(cap):
        np.testing.assert_array_equal(ei_g.numpy(), np.asarray(ei_w))
        np.testing.assert_array_equal(ev_g.numpy(), np.asarray(ev_w))
        c = ei_g.shape[1] // n
        want = np.asarray(jax_reverse_edge_perm(ei_w[0], ev_w, n, c))
        got = reverse_edge_perm(ei_g[0], ev_g, n, c)
        assert got.dtype == ei_g.dtype
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cap", [2, 3, None])
def test_reverse_perm_is_an_involution(cap):
    """On the port's own layout: the edge set is symmetric, and R maps each
    valid slot to a valid slot with the endpoints swapped, R(R(e)) = e."""
    for _, (ei, ev), n in _graphs(cap, seed=2):
        ei, ev = ei.numpy(), ev.numpy()
        edges = {(int(s), int(d)) for s, d in zip(ei[0][ev], ei[1][ev])}
        assert edges == {(d, s) for s, d in edges}
        r = reverse_edge_perm(torch.from_numpy(ei[0]), torch.from_numpy(ev), n,
                              ei.shape[1] // n).numpy()
        idx = np.flatnonzero(ev)
        assert len(idx) > 0 and ev[r[idx]].all()
        np.testing.assert_array_equal(ei[0][r[idx]], ei[1][idx])
        np.testing.assert_array_equal(ei[1][r[idx]], ei[0][idx])
        np.testing.assert_array_equal(r[r[idx]], idx)


def test_graph_config_picks_the_layout():
    """hybrid and einsum build the symmetric layout, the other routes the
    asymmetric one; the batched graph matches the JAX constructor's."""
    cfg = small()
    for msg_pass, symmetric in (("auto", False), ("fused_step", False), ("pallas", False),
                                ("hybrid", True), ("einsum", True)):
        cfg.TPU.MSG_PASS = msg_pass
        assert GCConfig.from_config(cfg).knn_symmetric is symmetric, msg_pass
    rng = np.random.RandomState(3)
    b, h, w, j, f, kpt = 2, 16, 20, 17, 12, 4
    levels = np.array([0.0, 0.05, 0.1, 0.5, 1.0], np.float32)
    sm = levels[rng.randint(0, len(levels), (b, h, w, j))]
    feats = rng.randn(b, h, w, f).astype(np.float32)
    tags = rng.randn(b, h, w, j).astype(np.float32)
    kw = dict(num_joints=j, nodes_per_type=kpt, knn_k=10, knn_cap_in=3, norm_node_distance=True)
    want = jax_construct(JaxGCConfig(**kw, knn_symmetric=True), jnp.asarray(sm),
                         jnp.asarray(feats), jnp.asarray(tags), testing=True)
    got = construct_graph_batch(GCConfig(**kw, knn_symmetric=True), torch.from_numpy(sm),
                                torch.from_numpy(feats), torch.from_numpy(tags))
    for name in ("edge_index", "edge_valid", "edge_src_local"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    asym = construct_graph_batch(GCConfig(**kw), torch.from_numpy(sm),
                                 torch.from_numpy(feats), torch.from_numpy(tags))
    # the cap of 3 binds, so the symmetric layout drops A-side edges
    assert int(asym.edge_valid.sum()) > int(got.edge_valid.sum())
