"""One training step of the small model_58_4 cut, port against the JAX
package: narrow HigherHRNet at 64x64, batch 2, K = 8, 3 MPN steps on the
``pallas`` path (the typed message kernel in interpret mode on the JAX
side), the same seeded weights and synthetic batch.

Compared: the labels and masks exactly, the loss parts, every parameter's
gradient and the MPN's running statistics after the step; then the
optimizer and the non-finite skip. Gradients are compared, not parameters
after Adam: Adam's first step moves each weight by about the learning rate
whatever the size of its gradient, so parameters would differ on the signs
of near-zero gradients.
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
from pemp_tpu.losses.factories import mask_node_connections as jax_mask_node_connections
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.train.convert import convert_composite_state_dict
from pemp_tpu_torch.config import small_train
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
from pemp_tpu_torch.weights import from_jax_variables


def _jax_config(port_cfg):
    cfg = get_config()
    cfg.defrost()
    cfg.merge_from_other(port_cfg.to_dict())
    # the training path with the asymmetric kNN layout; "auto" would pick
    # the symmetric einsum layout away from a TPU
    cfg.TPU.MSG_PASS = "pallas"
    cfg.freeze()
    return cfg


def _jax_loss_fn(jmodel, loss_factory, cfg):
    """pemp_tpu.train.train_step.make_train_step's loss_fn, with the
    gradient taken here rather than through an optimizer."""
    node_threshold = cfg.MODEL.MPN.NODE_THRESHOLD

    def loss_fn(params, batch_stats, batch):
        (_, output), mutated = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, batch["imgs"],
            keypoints_gt=batch["keypoints"], masks=batch["masks"][-1],
            factors=batch["factors"], heatmaps=batch["heatmaps"], train=True,
            backbone_train=not cfg.TRAIN.FREEZE_BN, mutable=["batch_stats"])
        output["masks"]["heatmap"] = batch["masks"]
        output["labels"]["heatmap"] = batch["heatmaps"]
        output["labels"]["num_images"] = batch["imgs"].shape[0]
        edge_masks, edge_labels = [], []
        for pred_node in output["preds"]["node"]:
            m = jax_mask_node_connections(
                jax.nn.sigmoid(jax.lax.stop_gradient(pred_node)),
                output["graph"]["edge_index"], node_threshold, output["labels"]["node"])
            edge_labels.append(output["labels"]["edge"])
            edge_masks.append(output["masks"]["edge"] * m.astype(jnp.float32))
        output["labels"]["edge"] = edge_labels
        output["masks"]["edge"] = edge_masks
        loss, logging = loss_factory(output["preds"], output["labels"], output["masks"],
                                     output["graph"])
        return loss, (mutated["batch_stats"], logging, output["labels"], output["masks"])

    return loss_fn


@pytest.fixture(scope="module")
def step_run():
    port_cfg = small_train()
    jcfg = _jax_config(port_cfg)
    jmodel = jax_build_pose_model(jcfg, dtype=jnp.float32)
    # build_pose_model turns Pallas off away from a TPU; interpret mode runs
    # the typed message kernel and its backward kernel on the CPU
    jmodel.mpn_cfg["_USE_PALLAS"] = True
    jmodel.mpn_cfg["_PALLAS_INTERPRET"] = True
    rng = np.random.RandomState(0)
    batch = make_batch(rng, 2, 64, (16, 32), 17, 30, scale_range=(0.4, 0.9))
    variables = _seeded_variables(jmodel, jnp.asarray(batch["imgs"]), rng)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    loss_fn = _jax_loss_fn(jmodel, jax_dispatch_loss_func(jcfg), jcfg)
    (loss, (stats, logging, labels, masks)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], jbatch)

    trainer = build_trainer(port_cfg, device="cpu")
    trainer.model.load_state_dict(from_jax_variables(
        variables["params"], variables["batch_stats"], port_cfg))
    trainer.model.train()
    tbatch = batch_to_torch(batch, "cpu")
    p_loss, p_logging, p_out = trainer.loss(tbatch)
    p_loss.backward()
    return dict(jcfg=jcfg, port_cfg=port_cfg, variables=variables, batch=tbatch,
                jax=(loss, stats, logging, labels, masks, grads),
                port=(p_loss, p_logging, p_out), trainer=trainer)


def test_labels_and_masks_exact(step_run):
    _, _, _, labels, masks, _ = step_run["jax"]
    p_out = step_run["port"][2]
    for key in ("node", "class", "person"):
        np.testing.assert_array_equal(p_out["labels"][key].numpy(), np.asarray(labels[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(p_out["labels"]["edge"][0].numpy(),
                                  np.asarray(labels["edge"][0]))
    for key in ("node", "class"):
        np.testing.assert_array_equal(p_out["masks"][key].numpy(), np.asarray(masks[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(p_out["masks"]["edge"][0].numpy(), np.asarray(masks["edge"][0]))
    # the scene has matches, so the labels are not trivially zero
    assert np.asarray(labels["node"]).sum() > 5 and np.asarray(labels["edge"][0]).sum() > 10


def test_loss_parts_match(step_run):
    loss, _, logging, _, _, _ = step_run["jax"]
    p_loss, p_logging, _ = step_run["port"]
    # f32 backbone and MPN sums in another order, through 3 steps
    for key in ("heatmap", "node", "edge", "class_loss", "loss"):
        np.testing.assert_allclose(float(p_logging[key].detach()), float(logging[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(p_loss), float(loss), rtol=1e-4)


# Tolerances from a float64 evaluation of the same step by the port: the
# gradients of both float32 programs sit within a few 1e-3 of each tensor's
# largest |grad| (the port up to 2.1e-3, on the node embedding's first
# layer; the JAX package up to 4.7e-4), so 5e-3 holds the port to the
# reference. The backbone's stem (two stride-2 convolutions and their
# BatchNorms) is where the JAX program is least accurate: 4.4 % off
# float64 inside the jitted train step, where the port's float32 gradients
# stay within 1e-6 of float64; 5e-2 there.
STEM = {("backbone", "conv1"), ("backbone", "bn1"), ("backbone", "conv2"), ("backbone", "bn2")}


def test_gradients_match_per_tensor(step_run):
    """Every parameter's gradient, mapped into the JAX layout with
    pemp_tpu.train.convert, within 5e-3 of that tensor's largest |grad|
    (5e-2 on the stem, see STEM)."""
    grads = step_run["jax"][5]
    model = step_run["trainer"].model
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
          for k, p in model.named_parameters()}
    sd.update({k: b.numpy() for k, b in model.named_buffers()})
    got, _ = convert_composite_state_dict(sd, step_run["jcfg"])
    want, got = flatten_dict(grads), flatten_dict(got)
    assert set(want) == set(got)
    for key in want:
        w, g = np.asarray(want[key]), np.asarray(got[key])
        scale = float(np.abs(w).max())   # 0 only for the dropped attention bias
        tol = 5e-2 if key[:2] in STEM else 5e-3
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale, err_msg=str(key))


def test_running_statistics_after_the_step(step_run):
    stats = step_run["jax"][1]
    model = step_run["trainer"].model
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    _, got = convert_composite_state_dict(sd, step_run["jcfg"])
    want, got = flatten_dict(stats["mpn"]), flatten_dict(got["mpn"])
    assert set(want) == set(got)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-4, atol=1e-5,
                                   err_msg=str(key))
