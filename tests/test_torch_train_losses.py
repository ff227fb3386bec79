"""Losses, the optimizer and the non-finite skip of the training path: the
port against the JAX package (losses at 1e-6, AdamW groups over two steps
on identical gradients), and the skip's restoring of state."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pemp_tpu.config import get_config
from pemp_tpu.losses import factories as jf
from pemp_tpu.train.optim import build_optimizer
from pemp_tpu_torch.config import small_train
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.losses import factories as tf
from pemp_tpu_torch.train.optim import SplitAdamW, param_label
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=1e-6,
                               atol=1e-6, **kw)


def test_elementwise_losses_match():
    rng = np.random.RandomState(0)
    logits = (rng.randn(500) * 4).astype(np.float32)
    targets = (rng.rand(500) > 0.6).astype(np.float32)
    mask = (rng.rand(500) > 0.3).astype(np.float32)
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    j = jnp.asarray
    _close(tf.sigmoid_bce_with_logits(t(logits), t(targets)),
           jf.sigmoid_bce_with_logits(j(logits), j(targets)))
    _close(tf.focal_loss(t(logits), t(targets), t(mask), 1.0, 2.0),
           jf.focal_loss(j(logits), j(targets), j(mask), 1.0, 2.0))
    _close(tf.focal_loss(t(logits), t(targets), None, 0.5, 1.0),
           jf.focal_loss(j(logits), j(targets), None, 0.5, 1.0))
    _close(tf.bce_loss_with_logits(t(logits), t(targets), t(mask), 2.0),
           jf.bce_loss_with_logits(j(logits), j(targets), j(mask), 2.0))
    cls = rng.randn(500, 17).astype(np.float32)
    lab = rng.randint(0, 17, 500).astype(np.int32)
    _close(tf.cross_entropy_with_logits(t(cls), t(lab), t(mask)),
           jf.cross_entropy_with_logits(j(cls), j(lab), j(mask)))
    hm = rng.rand(2, 8, 8, 34).astype(np.float32)
    gt = rng.rand(2, 8, 8, 17).astype(np.float32)
    hm_mask = (rng.rand(2, 8, 8) > 0.2).astype(np.float32)
    _close(tf.heatmap_loss(t(hm[..., :17]), t(gt), t(hm_mask)),
           jf.heatmap_loss(j(hm[..., :17]), j(gt), j(hm_mask)))


@pytest.mark.parametrize("bordering", [False, True])
def test_mask_node_connections_matches(bordering):
    rng = np.random.RandomState(1)
    pred = rng.rand(60).astype(np.float32)
    labels = (rng.rand(60) > 0.8).astype(np.float32)
    ei = rng.randint(0, 60, (2, 400)).astype(np.int32)
    want = jf.mask_node_connections(jnp.asarray(pred), jnp.asarray(ei), 0.5,
                                    jnp.asarray(labels), include_bordering_nodes=bordering)
    got = tf.mask_node_connections(torch.from_numpy(pred), torch.from_numpy(ei), 0.5,
                                   torch.from_numpy(labels), include_bordering_nodes=bordering)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_focal", [True, False])
def test_class_multi_loss_matches(use_focal):
    """The flagship factory on model_58_4's settings: one edge prediction,
    two node and class predictions (aux 0), two heatmap stages."""
    rng = np.random.RandomState(2)
    port_cfg = small_train()
    port_cfg.MODEL.LOSS.USE_FOCAL = use_focal
    jcfg = get_config()
    jcfg.merge_from_other(port_cfg.to_dict())
    n, e = 80, 640
    arrays = {
        "edge": [rng.randn(e).astype(np.float32)],
        "node": [rng.randn(n).astype(np.float32) for _ in range(2)],
        "class": [rng.randn(n, 17).astype(np.float32) for _ in range(2)],
        "heatmap": [rng.randn(2, 16, 16, 34).astype(np.float32),
                    rng.randn(2, 32, 32, 17).astype(np.float32)],
    }
    labels = {"edge": [(rng.rand(e) > 0.7).astype(np.float32)],
              "node": (rng.rand(n) > 0.5).astype(np.float32),
              "class": rng.randint(0, 17, n).astype(np.int32),
              "heatmap": [rng.rand(2, 16, 16, 17).astype(np.float32),
                          rng.rand(2, 32, 32, 17).astype(np.float32)]}
    masks = {"edge": [(rng.rand(e) > 0.2).astype(np.float32)],
             "node": (rng.rand(n) > 0.1).astype(np.float32),
             "class": (rng.rand(n) > 0.4).astype(np.float32),
             "heatmap": [np.ones((2, 16, 16), np.float32), np.ones((2, 32, 32), np.float32)]}

    def conv(tree, fn):
        if isinstance(tree, dict):
            return {k: conv(v, fn) for k, v in tree.items()}
        if isinstance(tree, list):
            return [fn(v) for v in tree]
        return fn(tree)

    want_total, want = jf.dispatch_loss_func(jcfg)(
        {**conv(arrays, jnp.asarray), "tag": [None]}, conv(labels, jnp.asarray),
        conv(masks, jnp.asarray), {})
    got_total, got = tf.dispatch_loss_func(port_cfg)(
        conv(arrays, torch.from_numpy), conv(labels, torch.from_numpy),
        conv(masks, torch.from_numpy))
    for key in ("heatmap", "node", "edge", "class_loss", "loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-6)


class _Composite(torch.nn.Module):
    """Parameters named like the composite model's: stem, later backbone,
    feature gather and MPN."""

    def __init__(self, rng):
        super().__init__()
        shapes = {"backbone.conv1.weight": (4, 3), "backbone.layer1.0.conv1.weight": (5,),
                  "backbone.stage2.0.fuse.weight": (3, 2), "feature_gather.weight": (2, 2),
                  "mpn.lin.weight": (6,)}
        self.names = list(shapes)
        self.params = torch.nn.ParameterList(
            torch.nn.Parameter(torch.from_numpy(rng.randn(*s).astype(np.float32)))
            for s in shapes.values())

    def named_parameters(self, *args, **kwargs):
        return zip(self.names, self.params)


def _jax_tree(names, values):
    """The same parameters as a JAX tree whose top-level names carry the
    labels the JAX partition reads (backbone / stem prefixes)."""
    jax_names = {"backbone.conv1.weight": ("backbone", "conv1", "kernel"),
                 "backbone.layer1.0.conv1.weight": ("backbone", "layer1_0", "kernel"),
                 "backbone.stage2.0.fuse.weight": ("backbone", "stage2_0", "kernel"),
                 "feature_gather.weight": ("feature_gather", "kernel"),
                 "mpn.lin.weight": ("mpn", "lin", "kernel")}
    return unflatten_dict({jax_names[n]: jnp.asarray(v) for n, v in zip(names, values)}), jax_names


@pytest.mark.parametrize("freeze_mode,end_to_end", [("nothing", True), ("stem", True),
                                                    ("complete", True)])
def test_split_adamw_matches_build_optimizer(freeze_mode, end_to_end):
    """Two updates on identical gradients with model_58_4's rates and
    decays; the learning-rate boundary falls between them."""
    rng = np.random.RandomState(3)
    port_cfg = small_train()
    port_cfg.TRAIN.KP_FREEZE_MODE = freeze_mode
    port_cfg.TRAIN.END_TO_END = end_to_end
    port_cfg.TRAIN.LR_STEP = [1, 30]
    port_cfg.TRAIN.W_DECAY = 0.01
    jcfg = get_config()
    jcfg.merge_from_other(port_cfg.to_dict())
    model = _Composite(rng)
    params, jax_names = _jax_tree(model.names, [p.detach().numpy() for p in model.params])
    tx, labels = build_optimizer(jcfg, params, steps_per_epoch=1)
    state = tx.init(params)
    opt = SplitAdamW(port_cfg, model, steps_per_epoch=1)
    flat_labels = flatten_dict(labels)
    for name in model.names:
        assert param_label(name, freeze_mode, end_to_end) == flat_labels[jax_names[name]]
    for _ in range(2):
        grads = [rng.randn(*p.shape).astype(np.float32) for p in model.params]
        jgrads, _ = _jax_tree(model.names, grads)
        updates, state = tx.update(jgrads, state, params)
        params = optax.apply_updates(params, updates)
        for p, g in zip(model.params, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        flat = flatten_dict(params)
        for name, p in zip(model.names, model.params):
            # one or two float32 roundings apart in the Adam update
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(flat[jax_names[name]]),
                                       rtol=1e-6, atol=1e-7, err_msg=name)


def test_split_adamw_updates_a_parameter_the_loss_does_not_reach():
    """A parameter with no gradient (torch: None) is updated as optax
    updates it on a zero gradient: decayed, with Adam's moments decaying
    after a step that did reach it (the attention bias on the routes that
    leave it out of the logits)."""
    rng = np.random.RandomState(5)
    port_cfg = small_train()
    port_cfg.TRAIN.KP_FREEZE_MODE, port_cfg.TRAIN.END_TO_END = "nothing", True
    port_cfg.TRAIN.W_DECAY = port_cfg.TRAIN.KP_W_DECAY = 0.01
    jcfg = get_config()
    jcfg.merge_from_other(port_cfg.to_dict())
    model = _Composite(rng)
    params, jax_names = _jax_tree(model.names, [p.detach().numpy() for p in model.params])
    tx, _ = build_optimizer(jcfg, params, steps_per_epoch=1)
    state = tx.init(params)
    opt = SplitAdamW(port_cfg, model, steps_per_epoch=1)
    unreached = {0: "mpn.lin.weight", 1: "backbone.conv1.weight"}
    for step in range(3):
        grads = [rng.randn(*p.shape).astype(np.float32) for p in model.params]
        for name, p, g in zip(model.names, model.params, grads):
            if name == unreached.get(step):       # first reached, then not
                g[...] = 0.0
                p.grad = None
            else:
                p.grad = torch.from_numpy(g)
        jgrads, _ = _jax_tree(model.names, grads)
        updates, state = tx.update(jgrads, state, params)
        params = optax.apply_updates(params, updates)
        opt.step()
        flat = flatten_dict(params)
        for name, p in zip(model.names, model.params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(flat[jax_names[name]]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{name}, step {step}")


def test_non_finite_step_is_skipped_and_state_restored():
    """A step whose loss is not finite (a NaN in the heatmap targets) leaves
    the parameters, the optimizer state and the MPN's running statistics
    as they were, and counts the failure; the next finite step updates."""
    cfg = small_train()
    trainer = build_trainer(cfg, device="cpu", seed=1)
    rng = np.random.RandomState(4)
    batch = batch_to_torch(make_batch(rng, 2, 64, (16, 32), 17, 30), "cpu")
    trainer.step(batch)                                     # creates Adam's state

    def snapshot():
        return ({k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
                {k: [t.clone() for t in s.values() if torch.is_tensor(t)]
                 for k, s in enumerate(trainer.optimizer.opt.state.values())},
                trainer.optimizer.count)

    before = snapshot()
    bad = dict(batch, heatmaps=[h.clone() for h in batch["heatmaps"]])
    bad["heatmaps"][0][0, 0, 0, 0] = float("nan")
    loss, logging = trainer.step(bad)
    assert not torch.isfinite(loss) and float(logging["skipped"]) == 1.0
    assert trainer.fail_count == 1
    after = snapshot()
    for k in before[0]:
        assert torch.equal(before[0][k], after[0][k]), k     # weights and running stats
    for k in before[1]:
        for x, y in zip(before[1][k], after[1][k]):
            assert torch.equal(x, y)
    assert before[2] == after[2]
    loss, logging = trainer.step(batch)
    assert torch.isfinite(loss) and float(logging["skipped"]) == 0.0
    assert trainer.optimizer.count == before[2] + 1
