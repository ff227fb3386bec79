"""Training on the research zoo's configurations (config.ZOO's ``simple``:
ClassificationMPNSimple on the per-type layer with two edge passes after
the node head; ``two_phase``: ClassificationMPN with its grouping phase),
port against JAX package, at the small model_58_4 cut as
test_torch_zoo_train.py runs it: three steps of ``train()`` against the JAX
package's ``make_train_step`` on the same batches and weights, losses within
5e-3 (the first within 1e-4). Neither model has a class head, so both
train on [edge, node, heatmap]. SelfAttention and VanillaMPN2 run in
test_torch_zoo_research_train_more.py, on a worker of their own. Also every
zoo preset through valid's pipeline and a training step, port alone."""

import numpy as np
import pytest
import torch
from test_torch_zoo_train import losses_match

from pemp_tpu_torch.config import small_train, zoo
from pemp_tpu_torch.data.synthetic import eval_scenes, make_batch
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
from pemp_tpu_torch.tta.multi_scale import TTAPipeline


@pytest.mark.parametrize("case", ["simple", "two_phase"])
def test_zoo_research_losses_match_make_train_step(case, tmp_path):
    parts = losses_match(case, tmp_path)
    assert all(p["edge"] > 0 and p["node"] > 0 and p["class_loss"] == 0 for p in parts)


ZOO_PRESETS = ("simple", "two_phase", "self_attention", "simple2", "type_based",
               "type_constrained", "fp_constrained", "with_ref", "attention", "vanilla2")


@pytest.mark.parametrize("name", ZOO_PRESETS)
def test_zoo_preset_runs_valid_pipeline_and_a_training_step(name):
    """Every zoo preset at the small cut, port alone: valid's pipeline
    (one scale with flip, the threshold decode) on two rendered images, and
    one training step on ``auto``; outputs and loss finite, no step
    skipped. The kernel routes' resolution is held in
    test_torch_mpn_zoo.py, the outputs against the JAX zoo there."""
    cfg = zoo(name, small_train())
    cfg.merge_from_other({"MODEL": {"PRETRAINED": "", "GC": {"CC_METHOD": "threshold"}},
                          "TPU": {"MATCHER": "greedy"}, "TEST": {"FLIP_TEST": True}})
    images, _ = eval_scenes(np.random.RandomState(5), [(72, 96), (96, 80)])
    model = build_pose_model(cfg, device="cpu", path="valid")
    for out in TTAPipeline(model, cfg).run_batched(images, batch_size=2):
        assert out["persons"].shape[-2:] == (17, 3)
        assert bool(torch.isfinite(out["edge_pred"]).all())
        assert bool(torch.isfinite(out["node_scores"]).all())
    trainer = build_trainer(cfg, device="cpu")
    batch = make_batch(np.random.RandomState(2), 2, 64, (16, 32), 17, 30, scale_range=(0.4, 0.9))
    loss, logging = trainer.step(batch_to_torch(batch, "cpu"))
    assert bool(torch.isfinite(loss)) and trainer.fail_count == 0
