"""Training on the tag-regression, background-class and group-based
configurations, port against JAX package, at the small model_58_4 cut
(narrow HigherHRNet at 64x64, batch 2, K = 8, 3 MPN steps) with each
config.ZOO delta merged: three steps of ``train()`` against the JAX
package's ``make_train_step`` on the same batches and weights, losses
within 5e-3 (the first within 1e-4). The backbone is frozen
(``TRAIN.END_TO_END`` false, ``KP_FREEZE_MODE`` complete, as
train/model_50_4 trains) and the labels take the greedy matcher: the JAX
step's compile through the backbone's backward and its auction's loop
cost minutes on the CPU, and both are held elsewhere
(test_torch_ablation_train_e2e.py, test_torch_train_labels.py); the
heatmap and tag-map terms still enter every loss.

``tag`` (NodeClassificationMPNTag, TAG_SKIP, ``tag_loss``) and
``group_based`` run here; ``background``, ``pure_tag`` (MPNTag with
SYNC_TAGS) and ``joint_type`` in test_torch_zoo_train_more.py, so the two
halves run on two workers. MPNTag and JointTypeClassification have no node
head: the JAX trainer's graph reduction takes the sigmoid of their
``None`` node output and fails (pemp_tpu/train/train_step.py:79-85), so
its step runs here with the port's reading (no node output, no graph
reduction), as tests/test_torch_ablation_train.py runs VanillaMPN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ablation_train import _jax_loss_factory, no_node_head  # noqa: F401
from test_torch_slice import _seeded_variables
from test_torch_train_opened import jax_config

from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.train import TrainState, build_optimizer, make_train_step
from pemp_tpu_torch.config import small_train, zoo
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.train.__main__ import train
from pemp_tpu_torch.weights import from_jax_variables

STEPS = 3


def setup_case(name, **extra):
    port_cfg = zoo(name, small_train())
    port_cfg.merge_from_other({"PRINT_FREQ": 1, "WORKERS": 0, "MODEL": {"PRETRAINED": ""},
                               "TRAIN": {"END_TO_END": False, "KP_FREEZE_MODE": "complete"},
                               "TPU": {"MATCHER": "greedy"}})
    port_cfg.merge_from_other(extra)
    jcfg = jax_config(port_cfg)
    jmodel = jax_build_pose_model(jcfg)
    rng = np.random.RandomState(0)
    variables = _seeded_variables(jmodel, jnp.zeros((2, 64, 64, 3), jnp.float32), rng)
    if port_cfg.MODEL.MPN.AGGR_TYPE == "agnostic":
        # MPLayer sums its messages unnormalised: at seeded weights the tags
        # saturate; smaller message weights keep them in range
        layer = variables["params"]["mpn"]["mpn_node_cls"]
        layer["mlp_node"]["kernel"] = layer["mlp_node"]["kernel"] * np.float32(0.01)
    batches = [make_batch(rng, 2, 64, (16, 32), 17, 30, scale_range=(0.4, 0.9))
               for _ in range(STEPS)]
    return port_cfg, jcfg, jmodel, variables, batches


def losses_match(name, tmp_path, **extra):
    port_cfg, jcfg, jmodel, variables, batches = setup_case(name, **extra)
    init = tmp_path / "init.pt"
    torch.save(from_jax_variables(variables["params"], variables["batch_stats"], port_cfg), init)
    port_cfg.TRAIN.CONTINUE, port_cfg.TRAIN.FINETUNE = str(init), True
    parts = []
    summary = train(port_cfg, batches, None, str(tmp_path / "log"), schedule_steps=STEPS,
                    epochs=1, device="cpu",
                    on_step=lambda trainer, it, loss, logging: parts.append(
                        {k: float(v) for k, v in logging.items()}))

    tx, _ = build_optimizer(jcfg, variables["params"], STEPS)
    step = jax.jit(make_train_step(jmodel, _jax_loss_factory(jcfg), tx, jcfg))
    dev = jax.devices()[0]
    state = jax.device_put(TrainState(variables["params"], variables["batch_stats"],
                                      tx.init(variables["params"]), jnp.int32(0),
                                      jnp.int32(0)), dev)
    losses = []
    for batch in batches:
        state, loss, _ = step(state, jax.device_put(batch, dev))
        losses.append(float(loss))
    assert summary["fail_count"] == 0 and int(state.fail_count) == 0
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(summary["losses"], losses, rtol=5e-3)
    np.testing.assert_allclose(summary["losses"][0], losses[0], rtol=1e-4)
    return parts


@pytest.mark.parametrize("case", ["tag", "group_based"])
def test_train_losses_match_make_train_step(case, tmp_path):
    """(NODE_STEPS 2 on the tag model: test_torch_mpn_tag.py holds its
    forward in both modes.)"""
    parts = losses_match(case, tmp_path)
    if case == "tag":
        assert all(p["tag"] > 0 for p in parts)
