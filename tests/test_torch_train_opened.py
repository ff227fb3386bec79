"""What this slice opened on the training path, port against the JAX
package at the small model_58_4 cut (narrow HigherHRNet at 64x64, batch 2,
K = 8, 3 MPN steps, ``pallas`` with the typed message kernel in interpret
mode on the JAX side):

* the associative-embedding loss and the tag-map branch (1e-6);
* one training step with the backbone's BatchNorm in training mode
  (``FREEZE_BN: false``), label method 4 with the neighbour pass, the
  greedy matcher and the tag-map loss: labels exact, loss parts (1e-4),
  running statistics within 1e-5, gradients within 5e-3 of each tensor's
  largest with the backbone in float64 on both sides (see opened_step);
* the validation step's loss parts against ``make_eval_step`` (1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_slice import _seeded_variables

from pemp_tpu.config import get_config
from pemp_tpu.losses import dispatch_loss_func as jax_dispatch_loss_func
from pemp_tpu.losses import factories as jf
from pemp_tpu.losses.factories import mask_node_connections
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.train import make_eval_step
from pemp_tpu.train.convert import convert_composite_state_dict
from pemp_tpu_torch.config import small_train
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.losses import factories as tf
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
from pemp_tpu_torch.weights import from_jax_variables

# configuration (b) of the slice: what it opened, in one training step
OPENED = {"MODEL": {"GC": {"EDGE_LABEL_METHOD": 4, "USE_NEIGHBOURS": True},
                    "LOSS": {"NAME": ["edge", "node", "class", "heatmap", "tagmap"]}},
          "TRAIN": {"WITH_AE_LOSS": [True, False], "FREEZE_BN": False},
          "TPU": {"MATCHER": "greedy"}}


def jax_config(port_cfg):
    """The JAX tree with the port's values, on the training path's
    asymmetric layout ("auto" picks the symmetric one away from a TPU)."""
    cfg = get_config()
    cfg.defrost()
    cfg.merge_from_other(port_cfg.to_dict())
    cfg.TPU.MSG_PASS = "pallas"
    cfg.freeze()
    return cfg


def jax_model(jcfg, dtype=jnp.float32):
    jmodel = jax_build_pose_model(jcfg, dtype=dtype)
    # interpret mode runs the typed message kernel and its backward on the CPU
    jmodel.mpn_cfg["_USE_PALLAS"] = True
    jmodel.mpn_cfg["_PALLAS_INTERPRET"] = True
    return jmodel


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("loss_type", ["exp", "max"])
def test_ae_loss_matches(loss_type):
    """ae_loss on random tags and the AE targets of random scenes (persons
    with and without visible joints), push and pull per image."""
    rng = np.random.RandomState(0)
    batch = make_batch(rng, 3, 64, (16, 32), 17, 30)
    tags = (rng.randn(3, 17 * 16 * 16) * 2).astype(np.float32)
    joints = batch["ae_targets"][0]
    joints[1] = 0                                  # an image with no person
    push, pull = tf.ae_loss(torch.from_numpy(tags), torch.from_numpy(joints), loss_type)
    jpush, jpull = jf.ae_loss(jnp.asarray(tags), jnp.asarray(joints), loss_type)
    for got, want in ((push, jpush), (pull, jpull)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert float(push.abs().sum()) > 0 and float(pull.abs().sum()) > 0


def test_tagmap_branch_matches():
    """ClassMultiLossFactory with ``tagmap`` and WITH_AE_LOSS [true, false]:
    the tags of the first stage's J extra channels, flattened (J, H, W),
    push and pull weighted by their factors; every logged part."""
    cfg = small_train()
    cfg.merge_from_other(OPENED)
    cfg.MODEL.HRNET.LOSS.PUSH_LOSS_FACTOR = [0.01, 0.001]
    jcfg = jax_config(cfg)
    rng = np.random.RandomState(1)
    batch = make_batch(rng, 2, 64, (16, 32), 17, 30)
    n = 2 * 17 * 8
    outputs = {"heatmap": [rng.randn(2, 16, 16, 34).astype(np.float32),
                           rng.randn(2, 32, 32, 17).astype(np.float32)],
               "node": [rng.randn(n).astype(np.float32)],
               "edge": [rng.randn(50).astype(np.float32)],
               "class": [rng.randn(n, 17).astype(np.float32)]}
    labels = {"heatmap": batch["heatmaps"], "tag": batch["ae_targets"],
              "node": (rng.rand(n) > 0.5).astype(np.float32),
              "edge": [(rng.rand(50) > 0.5).astype(np.float32)],
              "class": rng.randint(0, 17, n).astype(np.int32)}
    masks = {"heatmap": batch["masks"], "node": np.ones(n, np.float32),
             "edge": [np.ones(50, np.float32)], "class": np.ones(n, np.float32)}

    def conv(x, f):
        if isinstance(x, dict):
            return {k: conv(v, f) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v, f) for v in x]
        return f(x)

    loss, logging = tf.dispatch_loss_func(cfg)(*conv((outputs, labels, masks),
                                                     torch.from_numpy))
    jloss, jlogging = jax_dispatch_loss_func(jcfg)(*conv((outputs, labels, masks), jnp.asarray),
                                                   None)
    assert set(logging) == set(jlogging)
    for key in jlogging:
        np.testing.assert_allclose(float(logging[key]), float(jlogging[key]), rtol=1e-6,
                                   err_msg=key)
    assert float(logging["tag_loss"]) > 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)


# ------------------------------------------- one step of configuration (b)


def _jax_loss_fn(jmodel, loss_factory, cfg):
    """make_train_step's loss_fn (with the AE targets and train-mode
    backbone BatchNorm), its gradient taken here."""
    def loss_fn(params, batch_stats, batch):
        (_, output), mutated = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, batch["imgs"],
            keypoints_gt=batch["keypoints"], masks=batch["masks"][-1],
            factors=batch["factors"], heatmaps=batch["heatmaps"], train=True,
            backbone_train=not cfg.TRAIN.FREEZE_BN, mutable=["batch_stats"])
        output["masks"]["heatmap"] = batch["masks"]
        output["labels"]["heatmap"] = batch["heatmaps"]
        output["labels"]["tag"] = batch["ae_targets"]
        output["labels"]["num_images"] = batch["imgs"].shape[0]
        edge_masks, edge_labels = [], []
        for pred_node in output["preds"]["node"]:
            m = mask_node_connections(
                jax.nn.sigmoid(jax.lax.stop_gradient(pred_node)),
                output["graph"]["edge_index"], cfg.MODEL.MPN.NODE_THRESHOLD,
                output["labels"]["node"])
            edge_labels.append(output["labels"]["edge"])
            edge_masks.append(output["masks"]["edge"] * m.astype(jnp.float32))
        output["labels"]["edge"] = edge_labels
        output["masks"]["edge"] = edge_masks
        loss, logging = loss_factory(output["preds"], output["labels"], output["masks"],
                                     output["graph"])
        return loss, (mutated["batch_stats"], logging, output["labels"])

    return loss_fn


@pytest.fixture(scope="module")
def opened_step():
    """The step in float32 on both sides (labels, loss parts, statistics,
    the eval step), and its gradients with the backbone in float64.

    With the backbone's BatchNorm in training mode, this random narrow
    network's backbone gradients are ill-conditioned in float32: the JAX
    step's lie up to 42 % of their tensor's largest from its own float64
    evaluation, and so do the port's (the two float32 programs differ from
    each other by up to 10 %, each from the other's rounding), while the
    port with a float64 backbone lies within 5e-5 of the JAX step in
    float64 on every tensor. So the gradients are compared in float64:
    the port's backbone and feature gather in float64 (the MPN's kernels'
    plain versions are float32), the JAX step wholly."""
    port_cfg = small_train()
    port_cfg.merge_from_other(OPENED)
    jcfg = jax_config(port_cfg)
    jmodel = jax_model(jcfg)
    rng = np.random.RandomState(0)
    batch = make_batch(rng, 2, 64, (16, 32), 17, 30, scale_range=(0.4, 0.9))
    variables = _seeded_variables(jmodel, jnp.asarray(batch["imgs"]), rng)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    loss_factory = jax_dispatch_loss_func(jcfg)
    (loss, (stats, logging, labels)), _ = jax.jit(
        jax.value_and_grad(_jax_loss_fn(jmodel, loss_factory, jcfg), has_aux=True))(
            variables["params"], variables["batch_stats"], jbatch)
    _, jeval, _ = jax.jit(make_eval_step(jmodel, loss_factory, jcfg))(
        variables["params"], variables["batch_stats"], jbatch)
    with jax.enable_x64(True):
        jmodel64 = jax_model(jcfg, jnp.float64)
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda x: jnp.asarray(x, jnp.float64), t)
        # the images and weights in float64; the ground truth as it is, so
        # that the labels are the float32 step's
        _, grads = jax.jit(jax.value_and_grad(
            _jax_loss_fn(jmodel64, loss_factory, jcfg), has_aux=True))(
                f64(variables["params"]), f64(variables["batch_stats"]),
                {**jbatch, "imgs": f64(batch["imgs"])})
        grads = jax.tree_util.tree_map(lambda g: np.asarray(g, np.float64), grads)

    trainer = build_trainer(port_cfg, device="cpu")
    trainer.model.load_state_dict(from_jax_variables(
        variables["params"], variables["batch_stats"], port_cfg))
    tbatch = batch_to_torch(batch, "cpu")
    # the validation step first: it must leave the statistics alone
    _, p_eval = trainer.eval_step(tbatch)
    p_loss, p_logging, p_out = trainer.loss(tbatch)

    trainer64 = build_trainer(port_cfg, device="cpu")
    model64 = trainer64.model
    model64.load_state_dict(trainer.model.state_dict())
    model64.backbone.double()
    model64.feature_gather.double()
    model64.dtype = torch.float64
    model64.mpn_forward = lambda gb, route=None, feature_maps=None: model64.mpn(  # in float32
        gb.x, gb.edge_attr, gb.edge_index, gb.edge_valid, gb.edge_src_local, torch.float32,
        node_valid=gb.node_valid, route=route)
    loss64, _, _ = trainer64.loss(tbatch)
    loss64.backward()
    return dict(jcfg=jcfg, jax=(loss, stats, logging, labels, grads, jeval),
                port=(p_loss, p_logging, p_out, p_eval), trainer=trainer, model64=model64)


def test_opened_step_labels_and_loss_parts(opened_step):
    loss, _, logging, labels, _, _ = opened_step["jax"]
    p_loss, p_logging, p_out, _ = opened_step["port"]
    for key in ("node", "class", "person"):
        np.testing.assert_array_equal(p_out["labels"][key].numpy(), np.asarray(labels[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(p_out["labels"]["edge"][0].numpy(),
                                  np.asarray(labels["edge"][0]))
    assert set(p_logging) == set(logging)
    for key in logging:
        np.testing.assert_allclose(float(p_logging[key].detach()), float(logging[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    assert float(logging["tag_loss"]) > 0
    np.testing.assert_allclose(float(p_loss.detach()), float(loss), rtol=1e-4)


def test_opened_step_gradients(opened_step):
    """Every parameter's gradient within 5e-3 of its tensor's largest, the
    backbone in float64 on both sides (opened_step)."""
    grads = opened_step["jax"][4]
    model = opened_step["model64"]
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).double().numpy()
          for k, p in model.named_parameters()}
    sd.update({k: b.double().numpy() for k, b in model.named_buffers()})
    got, _ = convert_composite_state_dict(sd, opened_step["jcfg"])
    want, got = flatten_dict(grads), flatten_dict(got)
    assert set(want) == set(got)
    for key in want:
        w, g = np.asarray(want[key]), np.asarray(got[key])
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-3 * float(np.abs(w).max()),
                                   err_msg=str(key))


def test_opened_step_running_statistics(opened_step):
    """The backbone's statistics moved as flax moves them (biased batch
    variance, momentum 0.9), and the MPN's, within 1e-5."""
    stats = opened_step["jax"][1]
    model = opened_step["trainer"].model
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    _, got = convert_composite_state_dict(sd, opened_step["jcfg"])
    want, got = flatten_dict(stats), flatten_dict(got)
    assert set(want) == set(got) and any(k[0] == "backbone" for k in want)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=str(key))


def test_validation_step_matches_make_eval_step(opened_step):
    """The no-grad validation step (eval mode, the training route) against
    make_eval_step: every loss part within 1e-4."""
    jeval = opened_step["jax"][5]
    p_eval = opened_step["port"][3]
    assert set(p_eval) == set(jeval)
    for key in jeval:
        np.testing.assert_allclose(float(p_eval[key]), float(jeval[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
