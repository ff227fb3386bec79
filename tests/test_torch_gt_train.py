"""Training on the GT joints (``MODEL.GC.USE_GT``, label method 2), port
against the JAX package, at the small model_58_4 cut (narrow HigherHRNet
at 64x64, batch 2, K = 8, 3 MPN steps): one step on ``pallas`` (K2, K2b
and G1 on the card; their plain versions here) and on ``dots``, the two
routes that run on person-major nodes. The JAX side runs its plain
per-type layer, which is what it runs without ``_NODES_PER_TYPE``
(pemp_tpu/models/pose_estimation.py:212-218) away from a TPU.

Compared: labels and masks exactly, every head's logits within 2e-4 of
their largest, the loss within 1e-4 and every parameter's gradient within
5e-3 of its tensor's largest (5e-2 on the backbone's stem, as
tests/test_torch_train_step.py explains) against the JAX package's float32
step. Where that gradient is itself more than the limit from the JAX
package's own float64 step (``jax.enable_x64``, the same inputs and
variables widened), the port is held to the float64 one, and those tensors
are named exactly: on the GT joints one type's message weights
(``mlp_node`` type 1). The routes that need type-blocked nodes refuse
USE_GT by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_slice import _seeded_variables
from test_torch_train_opened import jax_config

from pemp_tpu.losses import dispatch_loss_func as jax_dispatch_loss_func
from pemp_tpu.losses.factories import mask_node_connections as jax_mask_node_connections
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu_torch.config import check_path, small_train, update_config_command
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
from pemp_tpu_torch.weights import from_jax_variables

USE_GT = ["MODEL.GC.USE_GT", "True", "MODEL.GC.EDGE_LABEL_METHOD", "2"]
STEM = ("backbone.conv1.", "backbone.bn1.", "backbone.conv2.", "backbone.bn2.")


def setup(opts, steps=1, seed=0):
    """The small cut with ``opts``, the JAX config and model for it, seeded
    variables and ``steps`` synthetic batches."""
    port_cfg = update_config_command(small_train(), opts)
    port_cfg.merge_from_other({"PRINT_FREQ": 1, "WORKERS": 0, "MODEL": {"PRETRAINED": ""}})
    jcfg = jax_config(port_cfg)
    jmodel = jax_build_pose_model(jcfg)
    rng = np.random.RandomState(seed)
    variables = _seeded_variables(jmodel, jnp.zeros((2, 64, 64, 3), jnp.float32), rng)
    batches = [make_batch(rng, 2, 64, (16, 32), 17, 30, scale_range=(0.4, 0.9))
               for _ in range(steps)]
    return port_cfg, jcfg, jmodel, variables, batches


def _jax_step(jcfg, jmodel, variables, batch):
    """make_train_step's loss_fn, gradient taken here; returns (loss,
    grads, (preds, labels, masks))."""
    factory = jax_dispatch_loss_func(jcfg)

    def loss_fn(params, batch):
        (_, output), _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, batch["imgs"],
            keypoints_gt=batch["keypoints"], masks=batch["masks"][-1],
            factors=batch["factors"], heatmaps=batch["heatmaps"], train=True,
            backbone_train=not jcfg.TRAIN.FREEZE_BN, mutable=["batch_stats"])
        output["masks"]["heatmap"] = batch["masks"]
        output["labels"]["heatmap"] = batch["heatmaps"]
        output["labels"]["num_images"] = batch["imgs"].shape[0]
        edge_masks = []
        for pred_node in output["preds"]["node"]:
            m = jax_mask_node_connections(
                jax.nn.sigmoid(jax.lax.stop_gradient(pred_node)), output["graph"]["edge_index"],
                jcfg.MODEL.MPN.NODE_THRESHOLD, output["labels"]["node"])
            edge_masks.append(output["masks"]["edge"] * m.astype(jnp.float32))
        output["labels"]["edge"] = [output["labels"]["edge"]] * len(edge_masks)
        output["masks"]["edge"] = edge_masks
        loss, _ = factory(output["preds"], output["labels"], output["masks"], output["graph"])
        preds = {k: output["preds"][k] for k in ("edge", "node", "class")}
        return loss, (preds, output["labels"], output["masks"])

    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], jbatch)
    return loss, grads, aux


def jax_f64_gradients(jcfg, jmodel, variables, batch):
    """The JAX package's gradients of the same step in float64: variables
    and the batch's float32 arrays widened, under ``jax.enable_x64``."""
    def wide(x):
        x = np.asarray(x)
        return x.astype(np.float64) if x.dtype == np.float32 else x

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda x: jnp.asarray(wide(x)), variables)
        loss, grads, _ = _jax_step(jcfg, jmodel, v64, jax.tree_util.tree_map(wide, batch))
        assert loss.dtype == jnp.float64
        return jax.tree_util.tree_map(np.asarray, grads)


def step_matches(opts, min_positive=(20, 100)):
    """One training step of the small cut with ``opts``, port against JAX
    (module docstring): labels, masks, logits, loss and gradients. Returns
    the names of the tensors held to the JAX float64 step, because the JAX
    float32 gradient is more than the limit from it."""
    port_cfg, jcfg, jmodel, variables, batches = setup(opts)
    loss, grads, (preds, labels, masks) = _jax_step(jcfg, jmodel, variables, batches[0])
    trainer = build_trainer(port_cfg, device="cpu")
    trainer.model.load_state_dict(from_jax_variables(variables["params"],
                                                     variables["batch_stats"], port_cfg))
    p_loss, _, p_out = trainer.loss(batch_to_torch(batches[0], "cpu"))
    p_loss.backward()
    for key in ("node", "class", "person"):
        np.testing.assert_array_equal(p_out["labels"][key].numpy(), np.asarray(labels[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(p_out["labels"]["edge"][0].numpy(),
                                  np.asarray(labels["edge"][0]))
    for key in ("node", "class"):
        np.testing.assert_array_equal(p_out["masks"][key].numpy(), np.asarray(masks[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(p_out["masks"]["edge"][0].numpy(), np.asarray(masks["edge"][0]))
    assert np.asarray(labels["node"]).sum() > min_positive[0]
    assert np.asarray(labels["edge"][0]).sum() > min_positive[1]
    for key in ("edge", "node", "class"):
        for got, want in zip(p_out["preds"][key], preds[key], strict=True):
            w = np.asarray(want)
            np.testing.assert_allclose(got.detach().numpy(), w, rtol=0,
                                       atol=2e-4 * float(np.abs(w).max()), err_msg=key)
    np.testing.assert_allclose(float(p_loss.detach()), float(loss), rtol=1e-4)
    want = from_jax_variables(grads, variables["batch_stats"], port_cfg)
    want64 = from_jax_variables(jax_f64_gradients(jcfg, jmodel, variables, batches[0]),
                                variables["batch_stats"], port_cfg)
    held_to_f64 = []
    for name, p in trainer.model.named_parameters():
        w, w64 = want[name].numpy(), want64[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        if name.endswith("attn_net.0.bias"):
            # constant within each softmax group: no gradient in the port,
            # rounding in the JAX package
            assert not g.any() and np.abs(w).max() < 1e-6
            continue
        tol = 5e-2 if name.startswith(STEM) else 5e-3
        if np.abs(w - w64).max() > tol * np.abs(w64).max():
            held_to_f64.append(name)    # the JAX float32 gradient's own rounding
            w = w64
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * float(np.abs(w).max()),
                                   err_msg=name)
    return held_to_f64


@pytest.mark.parametrize("route", ["pallas", "dots"])
def test_use_gt_step_matches_jax(route):
    assert build_trainer(update_config_command(small_train(), USE_GT + ["TPU.MSG_PASS", route]),
                         device="cpu").train_route == route
    off = step_matches(USE_GT + ["TPU.MSG_PASS", route])
    assert off == ["mpn.mpn_node_cls.mlp_node.mlp.1.0.weight"]


@pytest.mark.parametrize("route", ["auto", "pallas", "dots", "fused_step", "hybrid", "einsum"])
def test_use_gt_routes(route):
    """On the GT joints ``auto`` is ``pallas`` in training and at eval;
    ``pallas`` and ``dots`` run; ``fused_step``, ``hybrid`` and ``einsum``
    need type-blocked nodes and are refused by name, in the path check and
    in the MPN; the eval paths refuse USE_GT."""
    cfg = update_config_command(small_train(), USE_GT + ["TPU.MSG_PASS", route])
    for path in ("eval", "valid", "valid_hr"):
        with pytest.raises(NotImplementedError, match="USE_GT"):
            check_path(cfg, path)
    if route in ("fused_step", "hybrid", "einsum"):
        with pytest.raises(NotImplementedError, match="USE_GT"):
            check_path(cfg, "train")
        return
    check_path(cfg, "train")
    model = build_pose_model(cfg, device="cpu", path="train")
    assert model.mpn.cfg["_GT_NODES"]
    trainer = build_trainer(cfg, device="cpu", model=model)
    assert trainer.train_route == ("pallas" if route == "auto" else route)
    batch = batch_to_torch(make_batch(np.random.RandomState(2), 2, 64, (16, 32), 17, 30), "cpu")
    for r in ("fused_step", "hybrid", "einsum"):
        with pytest.raises(NotImplementedError, match="USE_GT"):
            model.train()(batch["imgs"], keypoints_gt=batch["keypoints"],
                          masks=batch["masks"][-1], factors=batch["factors"], route=r)


@pytest.mark.parametrize("key,value", [("MODEL.GC.NODE_DROPOUT", "0.2"),
                                       ("MODEL.GC.IMAGE_CENTRIC_SAMPLING", "True")])
def test_train_refuses_the_keyless_ablations(key, value):
    """Node dropout and image-centric sampling act only with a random key,
    which the JAX trainer never passes: the training path refuses them and
    says why; the weighted class loss and methods 1-7 it takes."""
    with pytest.raises(NotImplementedError, match="train_step.py:57-67"):
        check_path(update_config_command(small_train(), [key, value]), "train")
    for method in range(1, 8):
        check_path(update_config_command(small_train(), [
            "MODEL.GC.EDGE_LABEL_METHOD", str(method), "MODEL.GC.WEIGHT_CLASS_LOSS", "True"]),
            "train")
