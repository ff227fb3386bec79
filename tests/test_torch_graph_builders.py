"""The graph builders, edge-feature sets and segment ops of the edge-list
graphs that the files of configs/ run, port against JAX package: the
builders and features exactly on tie-heavy detections (integer pixels,
repeated scores), the segment ops within 1e-6 with their gradients,
connected components on an edge list, and graph construction with labels
on an edge list exactly. The graphs and feature sets no file of configs/
runs, held against the JAX package in test_torch_variants_graph.py, load
and build here; a graph type or feature set that neither package builds
is refused by name."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pemp_tpu.graph.constructor import GCConfig as JaxGCConfig
from pemp_tpu.graph.constructor import _edge_features as jax_edge_features
from pemp_tpu.graph.constructor import construct_graph_batch as jax_construct
from pemp_tpu.ops import knn as jknn
from pemp_tpu.ops import segment as jseg
from pemp_tpu.ops.components import connected_components as jax_components
from pemp_tpu_torch.graph.constructor import GCConfig, _edge_features, construct_graph_batch
from pemp_tpu_torch.ops import knn, segment
from pemp_tpu_torch.ops.components import connected_components

J, K = 5, 6                 # types, detections per type: N = 30 type-blocked nodes
N = J * K


def _scene(seed, b=2):
    """Type-blocked detections on a 7x7 grid (equal distances), scores
    from few levels (equal scores), a quarter invalid, 8-wide features and
    2-channel tags."""
    rng = np.random.RandomState(seed)
    pos = rng.randint(0, 7, (b, N, 2)).astype(np.float32)
    valid = rng.rand(b, N) > 0.25
    scores = rng.choice(np.array([0.05, 0.2, 0.5, 0.9], np.float32), (b, N))
    types = np.tile(np.arange(N) // K, (b, 1)).astype(np.int32)
    feats = rng.randn(b, N, 8).astype(np.float32)
    tags = rng.randn(b, N, 2).astype(np.float32)
    return pos, valid, scores, types, feats, tags


BUILDERS = {
    "fully": (lambda p, v, s, t, f: jknn.fully_connected_edges(v),
              lambda p, v, s, t, f: knn.fully_connected_edges(v)),
    "score_based": (lambda p, v, s, t, f: jknn.score_based_edges(p, v, s, 7),
                    lambda p, v, s, t, f: knn.score_based_edges(p, v, s, 7)),
    "score_based_per_type": (
        lambda p, v, s, t, f: jknn.score_based_per_type_edges(p, v, t, s, J, 2, K, 0.3),
        lambda p, v, s, t, f: knn.score_based_per_type_edges(p, v, t, s, J, 2, K, 0.3)),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_exact(name):
    """edge_index and edge_valid of each image, batched on the port's
    side, equal the JAX builder's, three scenes each."""
    jax_fn, port_fn = BUILDERS[name]
    for seed in range(3):
        pos, valid, scores, types, feats, _ = _scene(seed)
        t = torch.from_numpy
        ei, ev = port_fn(t(pos), t(valid), t(scores), t(types), t(feats))
        for i in range(pos.shape[0]):
            wi, wv = jax_fn(jnp.asarray(pos[i]), jnp.asarray(valid[i]), jnp.asarray(scores[i]),
                            jnp.asarray(types[i]), jnp.asarray(feats[i]))
            np.testing.assert_array_equal(ei[i].numpy(), np.asarray(wi), err_msg=f"{seed} {i}")
            np.testing.assert_array_equal(ev[i].numpy(), np.asarray(wv), err_msg=f"{seed} {i}")
        assert ev.any() and not ev.all()


FEATURE_SETS = [("position", "connection_type"), ("connection_type",), ("position",),
                ("nothing",)]


def _feature_inputs(layout):
    """One scene's detections and edges on the blocked layout or an edge
    list, with the graph settings of each package's GCConfig."""
    pos, valid, scores, _, _, tags = _scene(4, b=1)
    if layout == "blocked":
        ei, _ = jknn.knn_edges_target_major(jnp.asarray(pos[0]), jnp.asarray(valid[0]), 4, 3)
        graph = dict(graph_type="knn")
    else:
        ei, _ = jknn.score_based_edges(jnp.asarray(pos[0]), jnp.asarray(valid[0]),
                                       jnp.asarray(scores[0]), 7)
        graph = dict(graph_type="score_based")
    det = np.concatenate([pos[0], (np.arange(N) // K)[:, None]], 1).astype(np.int32)
    return det, scores[0], tags[0], ei, graph


@pytest.mark.parametrize("feats", FEATURE_SETS, ids="+".join)
@pytest.mark.parametrize("layout", ["score_based", "blocked"])
def test_edge_features_exact(feats, layout):
    """Each edge-feature set of the files of configs/ on an edge list (the
    target row a gather) and on the blocked layout (a repeat), exactly as
    the JAX package computes it."""
    det, scores, tags, ei, graph = _feature_inputs(layout)
    kw = dict(num_joints=J, nodes_per_type=K, edge_features=feats, norm_node_distance=True,
              **graph)
    want = jax_edge_features(JaxGCConfig(**kw), jnp.asarray(det), jnp.asarray(scores),
                             jnp.asarray(tags), ei, (20, 24))
    got = _edge_features(GCConfig(**kw), torch.from_numpy(det), torch.from_numpy(scores),
                         torch.from_numpy(tags), torch.from_numpy(np.asarray(ei)), (20, 24))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("feats", [("position", "angle", "connection_type"), ("ae",),
                                   ("ae_normed",), ("ae_tracking_1",),
                                   ("position", "connection_type", "ae_normed")],
                         ids="+".join)
def test_edge_feature_sets_no_config_uses_are_refused(feats):
    """The angle and tag-distance sets, which no file of configs/ uses, now
    build (one column each but the hot vector's J; held against the JAX
    package in test_torch_variants_graph.py); the same names in a set the
    JAX package does not build (here with ``nothing`` added) raise by name,
    and nothing falls back to another set."""
    det, scores, tags, ei, graph = _feature_inputs("score_based")
    args = (torch.from_numpy(det), torch.from_numpy(scores), torch.from_numpy(tags),
            torch.from_numpy(np.asarray(ei)), (20, 24))
    cfg = GCConfig(num_joints=J, nodes_per_type=K, edge_features=feats, **graph)
    width = len(feats) + (J - 1 if "connection_type" in feats else 0) + ("position" in feats)
    assert tuple(_edge_features(cfg, *args).shape) == (ei.shape[1], width)
    cfg = GCConfig(num_joints=J, nodes_per_type=K, edge_features=feats + ("nothing",), **graph)
    with pytest.raises(NotImplementedError, match="EDGE_FEATURES_TO_USE"):
        _edge_features(cfg, *args)


def _segment_case(seed=0, e=200, s=13, d=5):
    rng = np.random.RandomState(seed)
    data = rng.randn(e, d).astype(np.float32)
    ids = rng.randint(0, s - 2, e).astype(np.int32)     # the last two segments empty
    valid = rng.rand(e) > 0.2
    scores = rng.randn(e).astype(np.float32)
    return data, ids, valid, scores, s


SEGMENT_OPS = {
    "sum": (lambda d, i, v, sc, s: jseg.segment_sum(d, i, s, v),
            lambda d, i, v, sc, s: segment.segment_sum(d, i, s, v)),
    "max": (lambda d, i, v, sc, s: jseg.segment_max(d, i, s, v),
            lambda d, i, v, sc, s: segment.segment_max(d, i, s, v)),
    "mean": (lambda d, i, v, sc, s: jseg.segment_mean(d, i, s, v),
             lambda d, i, v, sc, s: segment.segment_mean(d, i, s, v)),
    "softmax": (lambda d, i, v, sc, s: jseg.segment_softmax(sc, i, s, v),
                lambda d, i, v, sc, s: segment.segment_softmax(sc, i, s, v)),
    "per_type_attention": (
        lambda d, i, v, sc, s: jseg.per_type_attention_aggregate(d, sc, i // 3, i % 3, s, 3, v),
        lambda d, i, v, sc, s: segment.per_type_attention_aggregate(d, sc, i // 3, i % 3, s, 3,
                                                                    v)),
    "blocked_mean": (lambda d, i, v, sc, s: jseg.blocked_aggregate(d, 20, "mean", v),
                     lambda d, i, v, sc, s: segment.blocked_aggregate(d, 20, "mean", v)),
    "blocked_max": (lambda d, i, v, sc, s: jseg.blocked_aggregate(d, 20, "max", v),
                    lambda d, i, v, sc, s: segment.blocked_aggregate(d, 20, "max", v)),
}


@pytest.mark.parametrize("name", list(SEGMENT_OPS))
def test_segment_op_and_gradient(name):
    """Each op and its gradient (of a fixed random projection of the
    output) with respect to the data and the scores within 1e-6; empty
    segments and invalid rows give exactly 0."""
    jax_fn, port_fn = SEGMENT_OPS[name]
    data, ids, valid, scores, s = _segment_case()
    want = jax_fn(jnp.asarray(data), jnp.asarray(ids), jnp.asarray(valid),
                  jnp.asarray(scores), s)
    d_t = torch.from_numpy(data).requires_grad_()
    sc_t = torch.from_numpy(scores).requires_grad_()
    got = port_fn(d_t, torch.from_numpy(ids), torch.from_numpy(valid), sc_t, s)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
    proj = np.random.RandomState(1).randn(*got.shape).astype(np.float32)

    def jax_loss(d, sc):
        return jnp.sum(jax_fn(d, jnp.asarray(ids), jnp.asarray(valid), sc, s) * proj)

    gd, gs = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(data), jnp.asarray(scores))
    (got * torch.from_numpy(proj)).sum().backward()
    for g, w in ((d_t.grad, gd), (sc_t.grad, gs)):
        g = np.zeros_like(np.asarray(w)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=0)
    if name in ("sum", "max", "mean"):
        assert not got[-2:].detach().any()


def test_components_on_an_edge_list():
    """Connected components of a score-based graph (an edge list, no
    blocks) equal the JAX package's, with node_valid masking."""
    pos, valid, scores, *_ = _scene(5)
    ei, ev = knn.score_based_edges(*(torch.from_numpy(a) for a in (pos, valid, scores)), 3)
    rng = np.random.RandomState(0)
    ev = ev & torch.from_numpy(rng.rand(*ev.shape) > 0.6)   # confident edges only
    keep = torch.from_numpy(valid & (rng.rand(*valid.shape) > 0.2))
    got = connected_components(ei, ev, N, 0, keep)
    for i in range(pos.shape[0]):
        want = jax_components(jnp.asarray(ei[i].numpy()), jnp.asarray(ev[i].numpy()), N,
                              jnp.asarray(keep[i].numpy()))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    assert 1 < len(set(got[0].tolist())) < N


@pytest.mark.parametrize("graph", [dict(graph_type="fully"), dict(graph_type="score_based"),
                                   dict(graph_type="score_based_per_type")],
                         ids=lambda g: g["graph_type"])
def test_construct_graph_batch_on_edge_lists(graph):
    """Graph construction with method-6 labels and the neighbour pass on
    each edge-list graph: graph, features and labels exactly."""
    rng = np.random.RandomState(3)
    b, h, w, j, f, kpt = 2, 16, 20, 17, 8, 6
    levels = np.array([0.0, 0.05, 0.2, 0.6, 1.0], np.float32)
    sm = levels[rng.randint(0, len(levels), (b, h, w, j))]
    feats = rng.randn(b, h, w, f).astype(np.float32)
    tags = rng.randn(b, h, w, j).astype(np.float32)
    joints = np.concatenate([rng.randint(0, 16, (b, 3, j, 2)), rng.rand(b, 3, j, 1) > 0.3],
                            -1).astype(np.float32)
    factors = rng.uniform(2.0, 8.0, (b, 3, j)).astype(np.float32)
    kw = dict(num_joints=j, nodes_per_type=kpt, knn_k=10, knn_cap_in=6,
              norm_node_distance=True, use_neighbours=True, edge_label_method=6, **graph)
    want = jax_construct(JaxGCConfig(**kw, matcher="greedy"), jnp.asarray(sm),
                         jnp.asarray(feats), jnp.asarray(tags), joints_gt=jnp.asarray(joints),
                         factors=jnp.asarray(factors), testing=False)
    got = construct_graph_batch(GCConfig(**kw, matcher="greedy"), torch.from_numpy(sm),
                                torch.from_numpy(feats), torch.from_numpy(tags),
                                joints_gt=torch.from_numpy(joints),
                                factors=torch.from_numpy(factors))
    for name in ("edge_index", "edge_valid", "joint_det", "edge_src_local", "node_valid",
                 "edge_attr", "edge_labels", "node_labels", "node_classes", "node_persons",
                 "label_mask", "label_mask_node", "class_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert np.asarray(want.edge_labels).sum() > 0


@pytest.mark.parametrize("opts", [["MODEL.GC.GRAPH_TYPE", "topk"],
                                  ["MODEL.GC.GRAPH_TYPE", "feature_knn"],
                                  ["TPU.TARGET_MAJOR", "False"]], ids=lambda o: o[1])
def test_graphs_no_config_runs_are_refused(opts):
    """The per-type top-k graph, kNN in feature space and the kNN edge list,
    which no file of configs/ runs, now load (held against the JAX package
    in test_torch_variants_graph.py) and take the segment route; a graph
    type neither package builds is refused when the config is set."""
    from pemp_tpu_torch.config import update_config_command, w32_512_train
    from pemp_tpu_torch.config.defaults import plain_route

    cfg = update_config_command(w32_512_train(), opts)
    assert not GCConfig.from_config(cfg).blocked
    assert plain_route(cfg) == "segment"
    with pytest.raises(NotImplementedError, match="MODEL.GC.GRAPH_TYPE"):
        update_config_command(w32_512_train(), ["MODEL.GC.GRAPH_TYPE", f"{opts[1]}_2"])
