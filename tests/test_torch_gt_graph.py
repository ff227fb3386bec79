"""Graphs on the GT joints, port against the JAX package, exactly: the GT
joints as the node set (``USE_GT``), method 7's injection of the GT joints
into the free padded slots, label methods 1, 2 and 7 under both matchers,
method 7 in eval mode, and the class weights of ``WEIGHT_CLASS_LOSS``. The
JAX side runs with no graph key, as its trainer does: method 7 injects
without jitter.

Scenes are synthetic (data.synthetic.make_batch), their score maps the GT
heatmaps plus noise, so detections and near misses mix. The non-square
cases put GT joints past the shorter axis: both packages clamp them to
``max(H, W) - 1``, and the map lookups at them clamp each index into its
own axis, as XLA clamps a gather.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pemp_tpu.graph import constructor as jc
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.graph import constructor as tc

J, K, P = 17, 8, 30
N = J * K
# graph and labels held exactly; the edge features to float32 rounding
# (XLA divides by the norm as a product with its reciprocal)
EXACT = ("edge_labels", "node_labels", "node_classes", "node_persons", "label_mask",
         "label_mask_node", "class_mask", "edge_index", "edge_valid", "node_valid",
         "joint_det", "joint_scores", "x", "joint_tags", "batch_index", "edge_src_local")


def _scene(seed, hw=(32, 32), people=None):
    """Two images at map size ``hw`` (with ``people`` persons each, 1-4
    when None): score maps, features, tags, crowd masks, GT heatmaps, GT
    joints and their factors. A square 32 map is padded to ``hw`` with
    noise; on a non-square map a few visible joints move past the shorter
    axis."""
    rng = np.random.RandomState(seed)
    b, (h, w) = 2, hw
    batch = make_batch(rng, b, 64, (16, 32), J, P, n_people=people, scale_range=(0.4, 0.9))
    heat = np.zeros((b, h, w, J), np.float32)
    heat[:, :32, :32] = batch["heatmaps"][-1]
    sm = heat + rng.rand(b, h, w, J).astype(np.float32) * 0.05
    joints = batch["keypoints"].copy()
    if h != w:
        vis = np.argwhere(joints[..., 2] > 0)[:6]
        axis = 0 if w < h else 1              # x past a narrow map, y past a flat one
        for (bi, pi, ji), extra in zip(vis, (3, 7, 9, 12, 14, 20)):
            joints[bi, pi, ji, axis] = min(w, h) - 1 + extra
    return dict(sm=sm, feats=rng.randn(b, h, w, 8).astype(np.float32),
                tags=rng.randn(b, h, w, J).astype(np.float32),
                masks=(rng.rand(b, h, w) > 0.05).astype(np.float32),
                heat=heat, joints=joints, factors=batch["factors"])


def _configs(**kw):
    kw = dict(num_joints=J, nodes_per_type=K, knn_k=50, knn_cap_in=30,
              norm_node_distance=True, matching_radius=0.5, **kw)
    return tc.GCConfig(**kw), jc.GCConfig(**kw, knn_symmetric=False)


def _graphs(scene, with_jax=True, testing=False, **kw):
    """The JAX batch graph (None without ``with_jax``) and the port's, with
    the GT joints given: training labels on unless ``testing``."""
    cfg, jcfg = _configs(**kw)
    s = scene
    names = ("sm", "feats", "tags", "joints", "factors", "masks", "heat")
    want = None
    if with_jax:
        want = jax.jit(lambda sm, f, t, g, fa, m, hm: jc.construct_graph_batch(
            jcfg, sm, f, t, joints_gt=g, factors=fa, masks=m, testing=testing,
            gt_heatmaps=hm))(*(jnp.asarray(s[k]) for k in names))
    t = {k: torch.from_numpy(s[k]) for k in names}
    got = tc.construct_graph_batch(cfg, t["sm"], t["feats"], t["tags"], t["masks"],
                                   joints_gt=t["joints"], factors=t["factors"],
                                   gt_heatmaps=t["heat"], testing=testing)
    return got, want


def _assert_graphs_equal(got, want):
    for name in EXACT:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.edge_attr.numpy(), np.asarray(want.edge_attr), rtol=0,
                               atol=1e-6)


# ------------------------------------------------------------ the node sets


@pytest.mark.parametrize("hw,persons", [((32, 32), P), ((48, 32), P), ((32, 48), P),
                                        ((32, 32), 5)])
def test_gt_as_detections_exact(hw, persons):
    """P*J person-major nodes, clamped to max(H, W) - 1 on both axes, score
    1 where visible; padded to J*K (5 persons) or cut (30)."""
    s = _scene(0, hw)
    joints = s["joints"][:, :persons]
    joints[0, 0, :3, :2] = [[-4.0, 3.0], [70.0, -2.5], [31.5, 47.5]]
    got = tc._gt_as_detections(torch.from_numpy(joints), hw, N)
    want = jc._gt_as_detections(None, jnp.asarray(joints), hw, N)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if persons * J < N:     # the padding: type 0 at (0, 0), invalid
        assert not got[2][:, persons * J:].any() and not got[0][:, persons * J:].any()


@pytest.mark.parametrize("threshold,full,hw", [(0.1, False, (32, 48)), (0.1, True, (32, 48)),
                                              (None, False, (32, 48)), (0.1, False, (48, 32))])
def test_inject_gt_detections_exact(threshold, full, hw):
    """Method 7's injection on the detections of a scene: the GT joints in
    the free slots of their block. With ``full`` every third type block
    has no free slot, and without a threshold every slot is taken: the
    joints of a full block are dropped."""
    s = _scene(1, hw)
    cfg, jcfg = _configs(detect_threshold=threshold, edge_label_method=7)
    sm = np.ascontiguousarray(s["sm"].transpose(0, 3, 1, 2))
    det, scores, valid = tc.joint_det_from_scoremaps(torch.from_numpy(sm), K, threshold)
    if full:
        valid.view(2, J, K)[:, ::3] = True
    got = tc._inject_gt_detections(cfg, det, scores, valid, torch.from_numpy(sm),
                                   torch.from_numpy(s["joints"]))
    want = jc._inject_gt_detections(jcfg, jnp.asarray(det.numpy()), jnp.asarray(scores.numpy()),
                                    jnp.asarray(valid.numpy()), jnp.asarray(sm),
                                    jnp.asarray(s["joints"]), None)
    got = list(got[:3]) + list(got[3])
    for name, g, w in zip(("det", "scores", "valid", "mask", "person", "class"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    injected, visible = int(got[3].sum()), int((s["joints"][..., 2] > 0).sum())
    assert (injected > 0) == (threshold is not None)
    if full or threshold is None:
        assert injected < visible            # full blocks dropped joints


# ------------------------------------------------------------------ labels


@pytest.mark.parametrize("method,matcher,hw", [(2, "auction", (32, 32)), (2, "greedy", (48, 32)),
                                               (1, "auction", (32, 48)), (1, "greedy", (32, 32))])
def test_use_gt_labels_exact(method, matcher, hw):
    """USE_GT with methods 1 and 2: the GT joints as the nodes, every
    label and mask exact, on square and non-square maps."""
    got, want = _graphs(_scene(2, hw), use_gt=True, edge_label_method=method, matcher=matcher)
    _assert_graphs_equal(got, want)
    assert np.asarray(want.node_labels).sum() > 20 and np.asarray(want.edge_labels).sum() > 100


@pytest.mark.parametrize("matcher,hw", [("auction", (32, 32)), ("greedy", (32, 32)),
                                        ("auction", (32, 48)), ("greedy", (48, 32))])
def test_method7_labels_exact(matcher, hw):
    """Method 7: injected slots labelled with their own person and class,
    the real detections matched type-agnostically."""
    got, want = _graphs(_scene(3, hw), edge_label_method=7, matcher=matcher)
    _assert_graphs_equal(got, want)
    assert np.asarray(want.node_labels).sum() > 20 and np.asarray(want.edge_labels).sum() > 100


@pytest.mark.parametrize("method,use_gt", [(6, False), (2, True)])
def test_eval_mode_graph_exact(method, use_gt):
    """Eval mode (``testing``) with the GT joints given, as the validation
    loss builds the graph."""
    got, want = _graphs(_scene(4, (32, 48)), testing=True, edge_label_method=method,
                        use_gt=use_gt)
    _assert_graphs_equal(got, want)


def test_eval_mode_method7_injects_nothing():
    """Method 7 in eval mode injects nothing: the nodes are those of the
    graph without GT joints, labelled by the type-agnostic pass alone. The
    JAX package's eval graph raises here, as its labels read the injected
    persons, None without an injection (pemp_tpu/graph/constructor.py:
    436-439)."""
    scene = _scene(4, (32, 48))
    got, _ = _graphs(scene, with_jax=False, testing=True, edge_label_method=7)
    trained, _ = _graphs(scene, with_jax=False, edge_label_method=7)
    t = {k: torch.from_numpy(v) for k, v in scene.items()}
    cfg, _ = _configs(edge_label_method=7)
    bare = tc.construct_graph_batch(cfg, t["sm"], t["feats"], t["tags"], t["masks"])
    assert torch.equal(got.joint_det, bare.joint_det)
    assert torch.equal(got.node_valid, bare.node_valid)
    assert int(trained.node_valid.sum()) > int(got.node_valid.sum())
    assert int(got.node_labels.sum()) > 0


@pytest.mark.parametrize("method,use_gt", [(6, False), (2, True), (7, False), (1, True)])
def test_class_weights_exact(method, use_gt):
    """WEIGHT_CLASS_LOSS: the class mask times the GT heatmap at each
    node's class, at least 0.1; nothing else changes."""
    got, want = _graphs(_scene(5, (32, 48)), edge_label_method=method, use_gt=use_gt,
                        weight_class_loss=True)
    _assert_graphs_equal(got, want)
    plain, _ = _graphs(_scene(5, (32, 48)), with_jax=False, edge_label_method=method,
                       use_gt=use_gt)
    w = got.class_mask[plain.class_mask > 0] / plain.class_mask[plain.class_mask > 0]
    assert float(w.min()) >= 0.1 - 1e-7 and float(w.max()) > 0.5
