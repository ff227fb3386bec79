"""config.VARIANTS through the whole port model, against
the JAX model's pieces on the same weights (carried by
weights.from_jax_variables): the deltas over config.small() (the narrow
HigherHRNet at 64x64, K = 8, the flagship MPN widths, 3 steps) whose
plumbing through the pose model the layer tests (test_torch_variants_
layers.py) do not reach (EVAL), the hierarchical update over
config.small_81_1_2() (14 types). The suite runs close to its time
limit: the other deltas (the per-type aggregations, the node-only stack,
the hierarchical update at 17 types, VanillaMPN's) and the small-cut
values of config.VARIANT_CUTS are held where they act, in the layer tests
and in test_torch_variants_graph.py, and every one of them runs on the
small cut CPU against card in chip_smoke.py phase 50.

The backbone is the same for every variant, so the JAX side runs it once
(jitted) on two synthetic images and builds each variant's graph and MPN
outputs from its maps with the JAX package's construct_graph_batch and
PoseEstimationBaseline.mpn_forward, jitted; the port runs its model end to
end (``build_pose_model(path="valid")``, eval mode, ``TPU.MSG_PASS`` auto:
the fused step and the form config.layer_route gives the variant). The
JAX side pins its route as its own CPU tests do: ``pallas`` (the
asymmetric layout, its jnp form with Pallas off). Compared: the graph
(edge index and validity exactly, edge features within 1e-6 of their
largest, the tag distances' sets too), and every head's output within 2e-3
of its largest (the fused step's plain version sums in another order).

Training: one step through the trainer (``build_trainer``,
``TrainStep.loss``) on the top-k graph, the largest edge list, with its
labels (the layer tests, test_torch_variants_layers.py, hold every MPN
variant's gradients, the graph tests, test_torch_variants_graph.py, every
new graph's labels, and test_torch_variants_entry.py ``train()`` on a
kernel-route variant and an edge-list one): labels and masks exactly, the
loss within 1e-4, and every MPN parameter's gradient within 5e-3 of its
largest, against the JAX loss factory's value and gradients on the JAX
graph and MPN in training mode (the edge, node and class losses: the
backbone's heatmap loss reaches no MPN weight, and leaving it out keeps
the JAX side to the graph and MPN). The JAX graph is built from the maps
of the port's backbone, the ones the trainer's step reads: on the JAX
backbone's maps, which differ from them by float32 rounding (node
features within 1.3e-5), one type's message-MLP gradient on this graph
differs from the port's by 7e-3 of its largest, in float64 as in float32:
the step is that sensitive to its inputs here. On the same maps every
gradient agrees within 5e-4.
The backbone is held against the JAX one by the eval tests above.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from test_torch_slice import _seeded_variables
from test_torch_train_opened import jax_config

from pemp_tpu.graph.constructor import construct_graph_batch as jax_construct
from pemp_tpu.losses import dispatch_loss_func as jax_dispatch_loss_func
from pemp_tpu.losses.factories import mask_node_connections as jax_mask_node_connections
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.models.mpn.models import get_mpn_model as jax_get_mpn_model
from pemp_tpu.models.pose_estimation import PoseEstimationBaseline, _and_mask
from pemp_tpu_torch.config import small, small_81_1_2, variant
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.models.mpn.models import mpn_cfg_from_config
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
from pemp_tpu_torch.weights import from_jax_variables, mpn_from_jax_variables

B = 2
# the variants whose model-level plumbing the layer tests do not reach: the
# graphs and an edge-feature set that reads the scores and tags (the
# constructor, EDGE_INPUT_DIM 20), the per-type edge MLP's width and weights
# through the pose model, the hierarchical update at CrowdPose's 14 types
EVAL = [(name, "small") for name in ("knn_list", "topk", "feature_knn", "ae_normed",
                                     "edge_mlp_per_type")] + [
    ("update_hierarch", "small_81_1_2")]
TRAIN = ["topk"]
LOSSES = {"MODEL": {"LOSS": {"NAME": ["edge", "node", "class"]}}}


def _port_cfg(name, base, train=False):
    cfg = variant(name, {"small": small, "small_81_1_2": small_81_1_2}[base]())
    cfg.merge_from_other({"MODEL": {"PRETRAINED": ""}, "DATASET": {"INPUT_SIZE": 64,
                                                                  "OUTPUT_SIZE": [16, 32]}})
    if train:
        cfg.merge_from_other(LOSSES)
    return cfg


@functools.lru_cache(maxsize=None)
def _backbone(base):
    """(JAX variables of the base model, the batch, the JAX backbone's maps)
    for ``base``'s cut: the backbone and its weights are the variants'
    own."""
    cfg = _port_cfg("late_fusion", base)        # any variant: the backbone is the same
    jm = jax_build_pose_model(jax_config(cfg))
    rng = np.random.RandomState(0)
    joints = cfg.DATASET.NUM_JOINTS
    batch = make_batch(rng, B, 64, (16, 32), joints, 30, scale_range=(0.4, 0.9))
    variables = _seeded_variables(jm, jnp.asarray(batch["imgs"]), rng)
    maps = jax.jit(lambda v, x: jm.apply(v, x, method=PoseEstimationBaseline.backbone_forward))(
        variables, jnp.asarray(batch["imgs"]))
    return variables, batch, maps[1:]


def _seeded_mpn(jm, gb, seed):
    """The JAX MPN's variables for this variant, drawn as _seeded_variables
    draws them (shapes from flax, values from numpy)."""
    mpn = jax_get_mpn_model(jm.mpn_cfg)
    shapes = jax.eval_shape(lambda: mpn.init(
        jax.random.PRNGKey(0), gb.x, gb.edge_attr, gb.edge_index, node_types=gb.joint_det[:, 2],
        node_valid=gb.node_valid, edge_valid=gb.edge_valid, joint_tags=gb.joint_tags,
        edge_src_local=gb.edge_src_local, train=False))
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in flatten_dict(shapes).items():
        shape, kind = leaf.shape, path[-1]
        if kind == "kernel":
            fan_in = int(np.prod(shape[:-1])) // (shape[0] if len(shape) == 3 else 1)
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif kind in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.randn(*shape) * 0.1
        out[path] = np.asarray(v, np.float32)
    return unflatten_dict(out)


def _variant_jax(name, base, train):
    """(port config, JAX model, its variables, the batch, the JAX graph)."""
    cfg = _port_cfg(name, base, train)
    jcfg = jax_config(cfg)
    jm = jax_build_pose_model(jcfg)
    base_vars, batch, (sm, feat, tags) = _backbone(base)
    kw = {} if not train else dict(joints_gt=jnp.asarray(batch["keypoints"]),
                                   factors=jnp.asarray(batch["factors"]),
                                   masks=jnp.asarray(batch["masks"][-1]))
    gb = jax.jit(lambda s, f, t: jax_construct(jm.gc, jax.lax.stop_gradient(s), f,
                                               jax.lax.stop_gradient(t), testing=not train,
                                               **kw))(sm, feat, tags)
    mpn = _seeded_mpn(jm, gb, 7)
    params = {**base_vars["params"], "mpn": mpn["params"]}
    stats = {**base_vars["batch_stats"], "mpn": mpn.get("batch_stats", {})}
    return cfg, jm, {"params": params, "batch_stats": stats}, batch, gb


def _load(model, cfg, variables):
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"], cfg))
    return model


@pytest.mark.parametrize("name,base", EVAL, ids=[f"{n}-{b}" for n, b in EVAL])
def test_variant_model_eval_matches_jax(name, base):
    cfg, jm, variables, batch, gb = _variant_jax(name, base, False)
    feat = _backbone(base)[2][1]
    want = jax.jit(lambda v, g, f: jm.apply(v, g, feature_maps=f,
                                            method=PoseEstimationBaseline.mpn_forward))(
        variables, gb, feat)
    model = _load(build_pose_model(cfg, device="cpu", path="valid"), cfg, variables)
    with torch.no_grad():
        _, out = model(torch.from_numpy(batch["imgs"]))
    g = out["graph"]
    np.testing.assert_array_equal(g["edge_index"].numpy(), np.asarray(gb.edge_index))
    np.testing.assert_array_equal(g["edge_valid"].numpy(), np.asarray(gb.edge_valid))
    ev = np.asarray(gb.edge_valid)
    assert ev.sum() > 0
    ea, wa = g["edge_attr"].numpy(), np.asarray(gb.edge_attr)
    assert ea.shape == wa.shape == (ev.shape[0], cfg.MODEL.MPN.EDGE_INPUT_DIM)
    np.testing.assert_allclose(ea, wa, rtol=0, atol=1e-6 * max(1.0, float(np.abs(wa).max())))
    for key in ("edge", "node", "class"):
        if not want[key] or want[key][-1] is None:      # VanillaMPN: no node, no class
            assert not out["preds"][key] or out["preds"][key][-1] is None, key
            continue
        # the final heads (the JAX model also lists the per-step ones)
        got, w = out["preds"][key][-1].numpy(), np.asarray(want[key][-1])
        if key == "edge":
            got, w = got[ev], w[ev]
        np.testing.assert_allclose(got, w, rtol=0, atol=2e-3 * float(np.abs(w).max()),
                                   err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", TRAIN)
def test_variant_training_step_matches_jax(name):
    cfg, jm, variables, batch, _ = _variant_jax(name, "small", True)
    jcfg = jax_config(cfg)
    factory = jax_dispatch_loss_func(jcfg)
    trainer = build_trainer(cfg, device="cpu")
    _load(trainer.model, cfg, variables)
    trainer.model.train()
    tb = batch_to_torch(batch, "cpu")
    with torch.no_grad():           # the maps the trainer's step reads
        sm, feat, tags = (jnp.asarray(m.numpy())
                          for m in trainer.model.backbone_forward(tb["imgs"])[1:])
    p_loss, _, out = trainer.loss(tb)
    p_loss.backward()
    got = dict(trainer.model.mpn.named_parameters())
    jb = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(mpn_params):
        gb = jax_construct(jm.gc, jax.lax.stop_gradient(sm), feat, jax.lax.stop_gradient(tags),
                           joints_gt=jb["keypoints"], factors=jb["factors"],
                           masks=jb["masks"][-1], testing=False)
        preds, _ = jm.apply({"params": {"mpn": mpn_params},
                             "batch_stats": {"mpn": variables["batch_stats"]["mpn"]}},
                            gb, train=True, feature_maps=feat,
                            method=PoseEstimationBaseline.mpn_forward, mutable=["batch_stats"])
        labels = {"edge": gb.edge_labels, "node": gb.node_labels, "class": gb.node_classes,
                  "person": gb.node_persons, "batch_index": gb.batch_index,
                  "num_images": B}
        masks = {"edge": _and_mask(gb.label_mask, gb.edge_valid),
                 "node": _and_mask(gb.label_mask_node, gb.node_valid),
                 "class": _and_mask(gb.class_mask, gb.node_valid),
                 "node_valid": gb.node_valid, "edge_valid": gb.edge_valid}
        edge_masks = [masks["edge"] * jax_mask_node_connections(
            jax.nn.sigmoid(jax.lax.stop_gradient(p)), gb.edge_index,
            jcfg.MODEL.MPN.NODE_THRESHOLD, labels["node"]).astype(jnp.float32)
            for p in preds["node"]]
        labels["edge"] = [labels["edge"]] * len(edge_masks)
        masks["edge"] = edge_masks
        graph = {"edge_index": gb.edge_index, "batch_index": gb.batch_index}
        loss, _ = factory(preds, labels, masks, graph)
        return loss, (labels, masks)

    (loss, (labels, masks)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"]["mpn"])
    for key in ("node", "class", "person"):
        np.testing.assert_array_equal(out["labels"][key].numpy(), np.asarray(labels[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(out["labels"]["edge"][0].numpy(), np.asarray(labels["edge"][0]))
    np.testing.assert_array_equal(out["masks"]["edge"][0].numpy(), np.asarray(masks["edge"][0]))
    assert np.asarray(labels["edge"][0]).sum() > 0
    np.testing.assert_allclose(float(p_loss), float(loss), rtol=1e-4)
    want = mpn_from_jax_variables(grads, variables["batch_stats"]["mpn"],
                                  mpn_cfg_from_config(cfg.MODEL.MPN))
    assert set(got) <= set(want)
    top = max(float(want[k].abs().max()) for k in got)
    for key, p in got.items():
        w = want[key].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        scale = float(np.abs(w).max())
        if scale <= 1e-6 * top:          # the attention bias: zero to rounding
            assert float(np.abs(g).max()) <= 1e-6 * top, key
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-3 * scale, err_msg=key)
