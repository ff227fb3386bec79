"""``train()`` on the graph paths with the GT joints, port against the JAX
package's ``make_train_step``, at the small model_58_4 cut: label method 7
(the GT joints injected among the detections, without jitter: the JAX
trainer passes the model no key, pemp_tpu/train/train_step.py:57-67) with
the weighted class loss, and ``USE_GT`` with method 2, the backbone frozen.
Three steps from the same seeded weights (loaded by FINETUNE) on the same
batches: losses within 5e-3, the first within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gt_train import USE_GT, setup

from pemp_tpu.losses import dispatch_loss_func as jax_dispatch_loss_func
from pemp_tpu.train import TrainState, build_optimizer, make_train_step
from pemp_tpu_torch.train.__main__ import train
from pemp_tpu_torch.weights import from_jax_variables

STEPS = 3
# the backbone frozen, as train/model_56_2 trains it: the graph, labels and
# class weights under test do not depend on it, and the JAX package's
# end-to-end step takes minutes to compile on the CPU
FROZEN = ["TRAIN.END_TO_END", "False", "TRAIN.KP_FREEZE_MODE", "complete"]
CASES = {"method7_weighted": ["MODEL.GC.EDGE_LABEL_METHOD", "7",
                              "MODEL.GC.WEIGHT_CLASS_LOSS", "True"] + FROZEN,
         "use_gt_method2": USE_GT + FROZEN}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_losses_match_make_train_step(case, tmp_path):
    port_cfg, jcfg, jmodel, variables, batches = setup(CASES[case], steps=STEPS, seed=1)
    init = tmp_path / "init.pt"
    torch.save(from_jax_variables(variables["params"], variables["batch_stats"], port_cfg), init)
    port_cfg.TRAIN.CONTINUE, port_cfg.TRAIN.FINETUNE = str(init), True
    summary = train(port_cfg, batches, None, str(tmp_path / "log"), schedule_steps=STEPS,
                    epochs=1, device="cpu")

    tx, _ = build_optimizer(jcfg, variables["params"], STEPS)
    step = jax.jit(make_train_step(jmodel, jax_dispatch_loss_func(jcfg), tx, jcfg))
    # committed to one device from the start, as the step's outputs are
    dev = jax.devices()[0]
    state = jax.device_put(TrainState(variables["params"], variables["batch_stats"],
                                      tx.init(variables["params"]), jnp.int32(0),
                                      jnp.int32(0)), dev)
    losses = []
    for batch in batches:
        state, loss, _ = step(state, jax.device_put(batch, dev))
        losses.append(float(loss))
    assert summary["fail_count"] == 0 and int(state.fail_count) == 0
    np.testing.assert_allclose(summary["losses"][0], losses[0], rtol=1e-4)
    np.testing.assert_allclose(summary["losses"], losses, rtol=5e-3)
