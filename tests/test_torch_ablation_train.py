"""Training on the ablation configurations, port against JAX package, at
the small model_58_4 cut (narrow HigherHRNet at 64x64, batch 2, K = 8, 3
MPN steps) with each delta's keys as KEY VALUE options: the score-based
graph (an edge list, the ``segment`` route), train/model_50_4 (VanillaMPN,
the edge-only loss, frozen backbone), train/model_56_2 (label method 4
with the neighbour pass, frozen backbone) and class_agnostic_end2end/
model_57_1 (no class loss).

Compared: the first step's labels and masks exactly and, for
score_based, model_50_4 and model_57_1, every parameter's gradient within
5e-3 of its tensor's largest (5e-2 on the backbone's stem, as
tests/test_torch_train_step.py explains); then three steps of ``train()``
against the JAX package's ``make_train_step`` on the same batches and
weights, losses within 5e-3, for model_50_4 and model_56_2 here and
model_57_1 in test_torch_ablation_train_e2e.py (its end-to-end JAX step
takes minutes to compile on the CPU, so it runs on a worker of its own).

The JAX trainer cannot run the edge-only configurations as it stands: its
graph reduction takes the sigmoid of VanillaMPN's ``None`` node output
(pemp_tpu/train/train_step.py:79-85), and it calls the loss factory with
the graph, which MPNLossFactory does not take. The JAX side here runs
``make_train_step`` with those two points given the port's reading: no
node output, no graph reduction (every labelled edge counts); the graph
argument dropped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_ablation_valid import delta_options
from test_torch_slice import _seeded_variables
from test_torch_train_opened import jax_config

import pemp_tpu.train.train_step as jax_train_step
from pemp_tpu.losses import dispatch_loss_func as jax_dispatch_loss_func
from pemp_tpu.losses.factories import MPNLossFactory as JaxMPNLossFactory
from pemp_tpu.losses.factories import mask_node_connections as jax_mask_node_connections
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.train import TrainState, build_optimizer, make_train_step
from pemp_tpu_torch.config import small_train, update_config_command
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.train.__main__ import train
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
from pemp_tpu_torch.weights import from_jax_variables

CASES = {
    "score_based": ["MODEL.GC.GRAPH_TYPE", "'score_based'"],
    "model_50_4": delta_options("train/model_50_4"),
    "model_56_2": delta_options("train/model_56_2"),
    "model_57_1": delta_options("class_agnostic_end2end/model_57_1"),
}
STEPS = 3


def _jax_loss_factory(jcfg):
    """The JAX package's loss factory, called without the graph where it
    takes none (MPNLossFactory)."""
    factory = jax_dispatch_loss_func(jcfg)
    if isinstance(factory, JaxMPNLossFactory):
        return lambda preds, labels, masks, graph=None: factory(preds, labels, masks)
    return factory


@pytest.fixture
def no_node_head(monkeypatch):
    """make_train_step's graph reduction read as the port reads it for an
    MPN without a node head: the sigmoid of None is None, and no node
    prediction masks no edge."""
    sigmoid = jax.nn.sigmoid
    monkeypatch.setattr(jax_train_step.jax.nn, "sigmoid",
                        lambda x: None if x is None else sigmoid(x))
    real = jax_train_step.mask_node_connections

    def mask(pred, edge_index, *args, **kwargs):
        if pred is None:
            return jnp.ones((edge_index.shape[1],), bool)
        return real(pred, edge_index, *args, **kwargs)

    monkeypatch.setattr(jax_train_step, "mask_node_connections", mask)


def _setup(case):
    port_cfg = update_config_command(small_train(), CASES[case])
    port_cfg.merge_from_other({"PRINT_FREQ": 1, "WORKERS": 0, "MODEL": {"PRETRAINED": ""}})
    jcfg = jax_config(port_cfg)
    # the JAX package's jnp message path (Pallas is off away from a TPU):
    # the kernels in interpret mode are held elsewhere, and cost minutes here
    jmodel = jax_build_pose_model(jcfg)
    rng = np.random.RandomState(0)
    variables = _seeded_variables(jmodel, jnp.zeros((2, 64, 64, 3), jnp.float32), rng)
    batches = [make_batch(rng, 2, 64, (16, 32), 17, 30, scale_range=(0.4, 0.9))
               for _ in range(STEPS)]
    return port_cfg, jcfg, jmodel, variables, batches


def _jax_first_step(jcfg, jmodel, variables, batch):
    """make_train_step's loss_fn, with the port's reading of a missing node
    head; returns (loss, grads, labels, masks)."""
    node_threshold = jcfg.MODEL.MPN.NODE_THRESHOLD
    factory = _jax_loss_factory(jcfg)

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
            m = output["masks"]["edge"]
            if pred_node is not None:
                m = m * jax_mask_node_connections(
                    jax.nn.sigmoid(jax.lax.stop_gradient(pred_node)),
                    output["graph"]["edge_index"], node_threshold,
                    output["labels"]["node"]).astype(jnp.float32)
            edge_masks.append(m)
        output["labels"]["edge"] = [output["labels"]["edge"]] * len(edge_masks)
        output["masks"]["edge"] = edge_masks
        loss, _ = factory(output["preds"], output["labels"], output["masks"], output["graph"])
        return loss, (output["labels"], output["masks"])

    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    (loss, (labels, masks)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], jbatch)
    return loss, grads, labels, masks


@pytest.mark.parametrize("case", ["score_based", "model_50_4", "model_57_1"])
def test_first_step_labels_and_gradients(case):
    port_cfg, jcfg, jmodel, variables, batches = _setup(case)
    loss, grads, labels, masks = _jax_first_step(jcfg, jmodel, variables, batches[0])
    trainer = build_trainer(port_cfg, device="cpu")
    trainer.model.load_state_dict(from_jax_variables(variables["params"],
                                                     variables["batch_stats"], port_cfg))
    trainer.model.train()
    p_loss, _, p_out = trainer.loss(batch_to_torch(batches[0], "cpu"))
    p_loss.backward()
    for key in ("node", "class", "person"):
        np.testing.assert_array_equal(p_out["labels"][key].numpy(), np.asarray(labels[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(p_out["labels"]["edge"][0].numpy(),
                                  np.asarray(labels["edge"][0]))
    np.testing.assert_array_equal(p_out["masks"]["edge"][0].numpy(), np.asarray(masks["edge"][0]))
    assert np.asarray(labels["edge"][0]).sum() > 10
    np.testing.assert_allclose(float(p_loss), float(loss), rtol=1e-4)
    # the JAX gradients through the weight carrier, into the port's names
    want = from_jax_variables(grads, variables["batch_stats"], port_cfg)
    got = dict(trainer.model.named_parameters())
    assert set(got) <= set(want)
    stem = ("backbone.conv1.", "backbone.bn1.", "backbone.conv2.", "backbone.bn2.")
    for name, p in got.items():
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        if name.endswith("attn_net.0.bias"):
            # constant within each softmax group: the port drops it from the
            # scores (no gradient), the JAX package's gradient is rounding
            assert not g.any() and np.abs(w).max() < 1e-6
            continue
        tol = 5e-2 if name.startswith(stem) else 5e-3
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("case", ["model_50_4", "model_56_2"])
def test_train_losses_match_make_train_step(case, tmp_path, no_node_head):
    """Three steps of train() from the JAX seeded weights (loaded by
    FINETUNE) against make_train_step on the same batches: losses within
    5e-3, the first within 1e-4; the frozen backbones of model_50_4 and
    model_56_2 stay as they were."""
    train_losses_match(case, tmp_path)


def train_losses_match(case, tmp_path):
    port_cfg, jcfg, jmodel, variables, batches = _setup(case)
    init = tmp_path / "init.pt"
    torch.save(from_jax_variables(variables["params"], variables["batch_stats"], port_cfg), init)
    port_cfg.TRAIN.CONTINUE, port_cfg.TRAIN.FINETUNE = str(init), True
    summary = train(port_cfg, batches, None, str(tmp_path / "log"), schedule_steps=STEPS,
                    epochs=1, device="cpu")

    tx, _ = build_optimizer(jcfg, variables["params"], STEPS)
    step = jax.jit(make_train_step(jmodel, _jax_loss_factory(jcfg), tx, jcfg))
    # committed to one device from the start, as the step's outputs are:
    # uncommitted host arrays would make the second call compile again
    dev = jax.devices()[0]
    state = jax.device_put(TrainState(variables["params"], variables["batch_stats"],
                                      tx.init(variables["params"]), jnp.int32(0),
                                      jnp.int32(0)), dev)
    losses = []
    for batch in batches:
        state, loss, _ = step(state, jax.device_put(batch, dev))
        losses.append(float(loss))
    assert summary["fail_count"] == 0 and int(state.fail_count) == 0
    np.testing.assert_allclose(summary["losses"], losses, rtol=5e-3)
    np.testing.assert_allclose(summary["losses"][0], losses[0], rtol=1e-4)
    if not jcfg.TRAIN.END_TO_END:
        before = flatten_dict(variables["params"]["backbone"])
        after = flatten_dict(state.params["backbone"])
        assert all(np.array_equal(before[k], np.asarray(after[k])) for k in before)
        saved = torch.load(summary["ckpt_path"], weights_only=True)["model_state_dict"]
        start = torch.load(init, weights_only=True)
        assert all(torch.equal(saved[k], start[k]) for k in start
                   if k.startswith("backbone.") and "running" not in k
                   and "num_batches" not in k)
