"""The per-node tag loss, the tag, pure-tag, background and node-edge loss
factories, the string dispatch and the background labels, port against
the JAX package on the same numpy inputs.

node_ae_loss within 1e-6 relative (both loss types, an image without a
positive node, a person id with no node, ids past MAX_NUM_PEOPLE); each
factory's loss parts within 1e-5; SYNC_TAGS' bilinear resize of the first
stage's tag map at a growing and a shrinking ratio (where F.interpolate
without antialias would differ); the WITH_BACKGROUND labels exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pemp_tpu.config import get_config as jax_get_config
from pemp_tpu.graph.constructor import GCConfig as JaxGCConfig
from pemp_tpu.graph.constructor import construct_graph_batch as jax_construct
from pemp_tpu.losses import factories as jf
from pemp_tpu_torch.config import get_config
from pemp_tpu_torch.graph.constructor import GCConfig, construct_graph_batch
from pemp_tpu_torch.losses import factories as pf

B, J, P, N_PER = 3, 17, 30, 40
N = B * N_PER


def _persons(rng, n_per_image):
    """Per image node labels, person ids and validity: image 1 has no
    positive node; image 2 uses ids 0 and 3 only (1 and 2 have no node)."""
    labels, persons, valid = [], [], []
    for b in range(B):
        lab = (rng.rand(n_per_image) > 0.4).astype(np.float32)
        if b == 1:
            lab[:] = 0.0
        pid = rng.randint(0, 4, n_per_image)
        if b == 2:
            pid = np.where(rng.rand(n_per_image) > 0.5, 0, 3)
        labels.append(lab)
        persons.append(np.where(lab == 1.0, pid, -1))
        valid.append(rng.rand(n_per_image) > 0.1)
    return (np.concatenate(labels), np.concatenate(persons).astype(np.int32),
            np.concatenate(valid))


@pytest.mark.parametrize("loss_type", ["exp", "max"])
@pytest.mark.parametrize("max_people", [30, 3])
def test_node_ae_loss_matches_jax(loss_type, max_people):
    rng = np.random.RandomState(0)
    labels, persons, valid = _persons(rng, N_PER)
    tags = rng.randn(N).astype(np.float32)
    bi = np.repeat(np.arange(B), N_PER).astype(np.int32)
    sel = (labels == 1.0) & valid
    want = jf.node_ae_loss(jnp.asarray(tags), jnp.asarray(np.where(sel, persons, -1)),
                           jnp.asarray(bi), jnp.asarray(sel), B, max_people, loss_type)
    got = pf.node_ae_loss(torch.from_numpy(tags), torch.from_numpy(np.where(sel, persons, -1)),
                          torch.from_numpy(bi), torch.from_numpy(sel), B, max_people, loss_type)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    # the image without a positive node holds no tag: push and pull 0
    assert float(got[0][1]) == 0.0 and float(got[1][1]) == 0.0
    # image 2's ids 1 and 2 have no node: 4 tags, two of them at mean 0
    assert float(got[0][2]) > 0.0


def _configs(**loss):
    """The JAX and port config trees with the same loss keys."""
    delta = {"MODEL": {"LOSS": loss, "HRNET": {"LOSS": {"WITH_AE_LOSS": [True, False]}}},
             "TRAIN": {"WITH_AE_LOSS": [True, False]}}
    j = jax_get_config()
    j.defrost()
    j.merge_from_other(delta)
    p = get_config()
    p.merge_from_other(delta)
    return j, p


def _inputs(seed, hw0=(16, 16), hw1=(32, 32), edge=True):
    """Outputs, labels, masks and graph of a batch, numpy."""
    rng = np.random.RandomState(seed)
    labels_node, persons, valid = _persons(rng, N_PER)
    e = N * 6
    out = {
        "heatmap": [rng.randn(B, *hw0, 2 * J).astype(np.float32),
                    rng.randn(B, *hw1, J).astype(np.float32)],
        "node": [rng.randn(N).astype(np.float32)],
        "edge": [rng.randn(e).astype(np.float32) if edge else None],
        "class": [rng.randn(N, J + 1).astype(np.float32)],
        "tag": [rng.randn(N).astype(np.float32)],
    }
    ae = np.stack([rng.randint(0, J * hw0[0] * hw0[1], (B, P, J)),
                   (rng.rand(B, P, J) > 0.6).astype(np.int64)], -1).astype(np.int32)
    labels = {
        "heatmap": [rng.rand(B, *hw0, J).astype(np.float32),
                    rng.rand(B, *hw1, J).astype(np.float32)],
        "tag": [ae, ae],
        "node": labels_node,
        "class": rng.randint(0, J + 1, N).astype(np.int32),
        "person": persons,
        "batch_index": np.repeat(np.arange(B), N_PER).astype(np.int32),
        "edge": [(rng.rand(e) > 0.5).astype(np.float32)],
    }
    masks = {
        "heatmap": [(rng.rand(B, *hw0) > 0.1).astype(np.float32),
                    (rng.rand(B, *hw1) > 0.1).astype(np.float32)],
        "node": valid.astype(np.float32),
        "class": (labels_node * valid).astype(np.float32),
        "edge": [(rng.rand(e) > 0.3).astype(np.float32)],
        "node_valid": valid,
    }
    nodes = np.stack([rng.randint(-2, hw1[1] + 2, N), rng.randint(-2, hw1[0] + 2, N),
                      rng.randint(0, J, N)], 1).astype(np.int32)
    return out, labels, masks, {"nodes": nodes}


def _to(tree, conv):
    if isinstance(tree, dict):
        return {k: _to(v, conv) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, conv) for v in tree]
    return tree if tree is None or isinstance(tree, int) else conv(tree)


def _run(factory_name, loss, seed=0, **kw):
    jcfg, pcfg = _configs(**loss)
    out, labels, masks, graph = _inputs(seed, **kw)
    j_factory = jf.dispatch_loss_func(jcfg)
    p_factory = pf.dispatch_loss_func(pcfg)
    assert type(j_factory).__name__ == type(p_factory).__name__ == factory_name
    jl = {**labels, "num_images": B}
    args = [_to(out, jnp.asarray), _to(jl, jnp.asarray), _to(masks, jnp.asarray)]
    if factory_name not in ("ClassMPNLossFactory", "MPNLossFactory"):
        args.append(_to(graph, jnp.asarray))
    want_total, want = j_factory(*args)
    got_total, got = p_factory(_to(out, torch.from_numpy), _to(jl, torch.from_numpy),
                               _to(masks, torch.from_numpy), _to(graph, torch.from_numpy))
    for key, w in want.items():
        if w is None:
            assert key not in got
            continue
        np.testing.assert_allclose(float(got[key]), float(w), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-5)
    return got


FACTORIES = {
    "tag_loss": ("TagMultiLossFactory", {"NAME": "tag_loss", "LOSS_WEIGHTS": [1.0, 0.5, 2.0]}),
    "tag_loss_2": ("TagMultiLossFactory", {"NAME": "tag_loss", "LOSS_WEIGHTS": [0.7, 1.3]}),
    "pure_tag_loss": ("PureTagMultiLossFactory", {"NAME": "pure_tag_loss", "TAG_WEIGHT": 0.5}),
    "heatmap_tag": ("PureTagMultiLossFactory", {"NAME": ["heatmap", "tag"]}),
    "background": ("BackgroundClassMultiLossFactory",
                   {"NAME": "node_with_background_edge_loss", "LOSS_WEIGHTS": [0.5, 2.0]}),
    "node_edge": ("ClassMPNLossFactory", {"NAME": "node_edge_loss",
                                          "LOSS_WEIGHTS": [1.0, 0.5, 0.25]}),
    "node_edge_bce": ("ClassMPNLossFactory", {"NAME": "node_edge_loss", "NODE_USE_FOCAL": False,
                                              "NODE_BCE_POS_WEIGHT": 2.0}),
    "class_multi_tag_loss": ("ClassMultiLossFactory",
                             {"NAME": ["heatmap", "tagmap", "node", "edge", "class", "tag_loss"],
                              "TAG_WEIGHT": 0.3}),
    "edge_loss": ("MPNLossFactory", {"NAME": "edge_loss"}),
}


@pytest.mark.parametrize("case", list(FACTORIES))
def test_factory_matches_jax(case):
    name, loss = FACTORIES[case]
    got = _run(name, loss)
    if case in ("tag_loss", "pure_tag_loss", "class_multi_tag_loss"):
        assert float(got.get("tag", got["loss"])) > 0


@pytest.mark.parametrize("hw0,hw1", [((13, 11), (32, 27)), ((40, 36), (24, 20))],
                         ids=["growing", "shrinking"])
def test_pure_tag_sync_tags_matches_jax(hw0, hw1):
    """SYNC_TAGS: the first stage's tag map resized as jax.image.resize does
    (antialiased where it shrinks), sampled at the detections (clamped),
    pooled with the MPN's tags."""
    got = _run("PureTagMultiLossFactory", {"NAME": "pure_tag_loss", "SYNC_TAGS": True}, seed=3,
               hw0=hw0, hw1=hw1)
    assert float(got["tag"]) > 0


def test_background_factory_skips_edge_less_outputs():
    """An MPN without an edge head (JointTypeClassification) trains on the
    background factory's class loss: its edge term is 0 in both."""
    got = _run("BackgroundClassMultiLossFactory",
               {"NAME": "node_with_background_edge_loss"}, edge=False)
    assert float(got["edge"]) == 0.0


def test_node_head_less_outputs_are_refused_by_name():
    """The node-edge and tag factories read a node head; on an MPN without
    one (node [None]) the JAX package fails (a TypeError in focal_loss) and
    the port refuses by name."""
    for name in ("node_edge_loss", "tag_loss"):
        jcfg, pcfg = _configs(NAME=name, LOSS_WEIGHTS=[1.0, 1.0])
        out, labels, masks, graph = _inputs(0)
        out["node"] = [None]
        labels = {**labels, "num_images": B}
        with pytest.raises(TypeError):
            jf.dispatch_loss_func(jcfg)(_to(out, jnp.asarray), _to(labels, jnp.asarray),
                                        _to(masks, jnp.asarray), *([_to(graph, jnp.asarray)]
                                                                   if name == "tag_loss" else []))
        with pytest.raises(NotImplementedError, match="no node head"):
            pf.dispatch_loss_func(pcfg)(_to(out, torch.from_numpy), _to(labels, torch.from_numpy),
                                        _to(masks, torch.from_numpy), _to(graph, torch.from_numpy))


def test_string_dispatch_routes_every_legacy_name():
    table = {"edge_loss": "MPNLossFactory", "node_edge_loss": "ClassMPNLossFactory",
             "node_with_background_edge_loss": "BackgroundClassMultiLossFactory",
             "tag_loss": "TagMultiLossFactory", "pure_tag_loss": "PureTagMultiLossFactory"}
    for name, cls in table.items():
        jcfg, pcfg = _configs(NAME=name)
        assert type(pf.dispatch_loss_func(pcfg)).__name__ == cls
        assert type(jf.dispatch_loss_func(jcfg)).__name__ == cls
    _, pcfg = _configs(NAME="class_loss")
    with pytest.raises(NotImplementedError, match="legacy names"):
        pf.dispatch_loss_func(pcfg)


@pytest.mark.parametrize("with_background", [False, True])
def test_background_labels_match_jax(with_background):
    """Label method 6 with WITH_BACKGROUND: every node not labelled positive
    takes class J, the class mask is all ones; exactly the JAX labels."""
    rng = np.random.RandomState(5)
    kw = dict(num_joints=J, nodes_per_type=4, knn_k=6, knn_cap_in=6, detect_threshold=0.3,
              edge_label_method=6, matching_radius=0.3, with_background=with_background)
    sm = rng.rand(2, 24, 24, J).astype(np.float32) * 0.6
    feat = rng.randn(2, 24, 24, 4).astype(np.float32)
    tags = rng.randn(2, 24, 24, J).astype(np.float32)
    joints = np.zeros((2, 5, J, 3), np.float32)
    joints[..., :2] = rng.randint(0, 24, (2, 5, J, 2))
    joints[..., 2] = rng.rand(2, 5, J) > 0.3
    factors = np.ones((2, 5, J), np.float32)
    masks = np.ones((2, 24, 24), np.float32)
    want = jax_construct(JaxGCConfig(**kw), jnp.asarray(sm), jnp.asarray(feat),
                         jnp.asarray(tags), joints_gt=jnp.asarray(joints),
                         factors=jnp.asarray(factors), masks=jnp.asarray(masks), testing=False)
    t = torch.from_numpy
    got = construct_graph_batch(GCConfig(**kw), t(sm), t(feat), t(tags), masks=t(masks),
                                joints_gt=t(joints), factors=t(factors), testing=False)
    for key in ("node_labels", "node_classes", "class_mask", "node_persons", "edge_labels"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(want, key)).reshape(-1), err_msg=key)
    classes = got.node_classes.numpy()
    positive = got.node_labels.numpy() == 1.0
    assert positive.any() and (~positive).any()
    if with_background:
        assert (classes[~positive] == J).all() and (got.class_mask.numpy() == 1.0).all()
    else:
        assert (classes < J).all()


def test_upper_bounds_keep_refusing_the_background_class():
    """tools/calc_upper_bounds.py sets label method 2 (:53-54), where
    WITH_BACKGROUND does not act, so neither package's upper bounds run the
    background labels; the port's upper-bound path refuses them by name,
    while its training path takes them."""
    import pathlib

    from pemp_tpu_torch.config import check_path, small_train, upper_bound

    src = (pathlib.Path(__file__).resolve().parent.parent / "tools" /
           "calc_upper_bounds.py").read_text()
    assert "config.MODEL.GC.EDGE_LABEL_METHOD = 2" in src
    cfg = upper_bound("upper_bound/hrnet")
    check_path(cfg, "upper_bound")
    cfg.MODEL.GC.WITH_BACKGROUND = True
    with pytest.raises(NotImplementedError, match="WITH_BACKGROUND"):
        check_path(cfg, "upper_bound")
    train_cfg = small_train()
    train_cfg.MODEL.GC.WITH_BACKGROUND = True
    check_path(train_cfg, "train")
