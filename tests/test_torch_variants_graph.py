"""The graph variants of config.VARIANTS, port against the JAX package: the
kNN edge list (``TPU.TARGET_MAJOR`` false), the per-type top-k graph and
kNN among the node features, and the angle and tag-distance edge-feature
sets, on tie-heavy detections (integer pixels on a small grid, so equal
distances are common; scores from few levels).

The kNN edge list and the top-k graph are held exactly. kNN among the
features sums F float32 products, in another order than XLA's: where two
candidate distances lie within float32 rounding of each other they may
trade places, so the feature kNN graph is held exactly wherever the two
sides pick the same neighbour, and where they do not, the swapped
neighbours' distances (in float64) must be equal within 1e-5 of the
larger. The draws hold exact duplicates of features too (detections on
one pixel), which both sides order by index. The feature sets are held
within 1e-6 of each column's largest (the angle's arccos and the tag
distance's root may differ in the last place), on the blocked layout and
on an edge list, with one tag channel and with two (flip). Graph
construction with labels on the new edge lists is held through the pose
model and the trainer in test_torch_variants_model.py (the top-k graph's
labels and masks exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pemp_tpu.graph.constructor import GCConfig as JaxGCConfig
from pemp_tpu.graph.constructor import _edge_features as jax_edge_features
from pemp_tpu.ops import knn as jknn
from pemp_tpu_torch.graph.constructor import GCConfig, _edge_features
from pemp_tpu_torch.ops import knn

J, K = 5, 6                 # types, detections per type: N = 30 type-blocked nodes
N = J * K


def _scene(seed, b=2, f=8):
    """Type-blocked detections on a 7x7 grid, a quarter invalid, scores
    from few levels, f-wide features (every third node a copy of another's,
    as detections on one pixel read one feature) and 2-channel tags."""
    rng = np.random.RandomState(seed)
    pos = rng.randint(0, 7, (b, N, 2)).astype(np.float32)
    valid = rng.rand(b, N) > 0.25
    scores = rng.choice(np.array([0.05, 0.2, 0.5, 0.9], np.float32), (b, N))
    types = np.tile(np.arange(N) // K, (b, 1)).astype(np.int32)
    feats = rng.randn(b, N, f).astype(np.float32)
    feats[:, ::3] = feats[:, rng.randint(0, N, N // 3 + (N % 3 > 0))]
    tags = (rng.randn(b, N, 2) * 2).astype(np.float32)
    return pos, valid, scores, types, feats, tags


def _exact(name, port_fn, jax_fn, seeds=range(4)):
    for seed in seeds:
        pos, valid, scores, types, feats, _ = _scene(seed)
        args = (pos, valid, types, feats)
        ei, ev = port_fn(*(torch.from_numpy(a) for a in args))
        for i in range(pos.shape[0]):
            wi, wv = jax_fn(*(jnp.asarray(a[i]) for a in args))
            np.testing.assert_array_equal(ei[i].numpy(), np.asarray(wi), err_msg=f"{name} {seed}")
            np.testing.assert_array_equal(ev[i].numpy(), np.asarray(wv), err_msg=f"{name} {seed}")
        assert ev.any() and not ev.all()


@pytest.mark.parametrize("k", [4, 50])
def test_knn_edge_list_exact(k):
    """The kNN edge list (k clamped to N - 1 at 50), forward block and
    mutual-masked reverse block, against pemp_tpu.ops.knn.knn_edges."""
    _exact("knn", lambda p, v, t, f: knn.knn_edges(p, v, k),
           lambda p, v, t, f: jknn.knn_edges(p, v, k))


@pytest.mark.parametrize("k", [2, 10])
def test_top_k_per_type_exact(k):
    """The k nearest of every type (10 as the constructor builds it, more
    than some types hold valid), against top_k_per_type_edges."""
    _exact("topk", lambda p, v, t, f: knn.top_k_per_type_edges(p, v, t, J, k),
           lambda p, v, t, f: jknn.top_k_per_type_edges(p, v, t, J, k))


@pytest.mark.parametrize("f", [8, 128])
def test_feature_knn_exact_but_rounding_swaps(f):
    """kNN among the node features (8 wide, and 128 as NODE_INPUT_DIM),
    against feature_knn_edges: the same graph but where two candidates'
    distances tie within float32 rounding (module docstring)."""
    swapped = 0
    for seed in range(3):
        pos, valid, _, _, feats, _ = _scene(seed, f=f)
        ei, ev = knn.feature_knn_edges(torch.from_numpy(feats), torch.from_numpy(valid), 5)
        for i in range(pos.shape[0]):
            wi, wv = (np.asarray(a) for a in jknn.feature_knn_edges(
                jnp.asarray(feats[i]), jnp.asarray(valid[i]), 5))
            gi, gv = ei[i].numpy(), ev[i].numpy()
            if np.array_equal(gi, wi) and np.array_equal(gv, wv):
                continue
            fwd = N * 5
            differ = np.nonzero(gi[1, :fwd] != wi[1, :fwd])[0]
            assert len(differ), "only the neighbours may differ"
            x = feats[i].astype(np.float64)
            src = gi[0, differ]
            d_got = ((x[src] - x[gi[1, differ]]) ** 2).sum(-1)
            d_want = ((x[src] - x[wi[1, differ]]) ** 2).sum(-1)
            np.testing.assert_allclose(d_got, d_want, rtol=1e-5)
            swapped += len(differ)
    assert swapped <= 4


FEATURE_SETS = [("position", "angle", "connection_type"), ("ae",), ("ae_normed",),
                ("ae_tracking_1",), ("position", "connection_type", "ae_normed")]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("layout", ["blocked", "edge_list"])
@pytest.mark.parametrize("feats", FEATURE_SETS, ids="+".join)
def test_edge_feature_sets_match(feats, layout, channels):
    """The angle set and the four tag-distance sets against the JAX
    package's _edge_features, the tags at the detections one channel or
    two (the norm over both)."""
    pos, valid, scores, _, _, tags = _scene(4, b=1)
    if layout == "blocked":
        ei, _ = jknn.knn_edges_target_major(jnp.asarray(pos[0]), jnp.asarray(valid[0]), 4, 3)
        graph = dict(graph_type="knn")
    else:
        ei, _ = jknn.knn_edges(jnp.asarray(pos[0]), jnp.asarray(valid[0]), 4)
        graph = dict(graph_type="knn", target_major=False)
    det = np.concatenate([pos[0], (np.arange(N) // K)[:, None]], 1).astype(np.int32)
    t = tags[0, :, 0] if channels == 1 else tags[0]
    kw = dict(num_joints=J, nodes_per_type=K, edge_features=feats, norm_node_distance=True,
              **graph)
    want = np.asarray(jax_edge_features(JaxGCConfig(**kw), jnp.asarray(det),
                                        jnp.asarray(scores[0]), jnp.asarray(t), ei, (20, 24)))
    got = _edge_features(GCConfig(**kw), torch.from_numpy(det), torch.from_numpy(scores[0]),
                         torch.from_numpy(np.ascontiguousarray(t)),
                         torch.from_numpy(np.asarray(ei)), (20, 24)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())))
