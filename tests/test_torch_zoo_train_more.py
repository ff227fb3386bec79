"""The rest of test_torch_zoo_train.py's cases, on a worker of their own:
``background`` (the flagship with J + 1 classes, WITH_BACKGROUND labels,
``node_with_background_edge_loss``), ``pure_tag`` (MPNTag, the agnostic
MPLayer, ``pure_tag_loss`` with SYNC_TAGS) and ``joint_type``
(JointTypeClassification trained by the background factory's class loss):
three steps of ``train()`` against ``make_train_step``, losses within
5e-3, as test_torch_zoo_train.py runs them. JointTypeClassification with
``node_edge_loss`` is refused by both packages: the node-edge factory reads
the node head it has not (the JAX package fails with a TypeError, the port
raises by name)."""

import pytest
from test_torch_ablation_train import no_node_head  # noqa: F401
from test_torch_zoo_train import losses_match, setup_case

from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer


def test_background_losses_match_make_train_step(tmp_path):
    parts = losses_match("background", tmp_path)
    assert all(p["class_loss"] > 0 and p["edge"] > 0 for p in parts)


@pytest.mark.parametrize("case", ["pure_tag", "joint_type"])
def test_headless_losses_match_make_train_step(case, tmp_path, no_node_head):  # noqa: F811
    parts = losses_match(case, tmp_path)
    if case == "pure_tag":
        assert all(p["tag"] > 0 for p in parts)
    else:
        assert all(p["edge"] == 0.0 and p["class_loss"] > 0 for p in parts)


def test_joint_type_node_edge_loss_is_refused_by_name():
    """The port's trainer refuses the node-edge loss on JointTypeClassification
    by name; the JAX package's factory fails with a TypeError on its node
    output [None] (test_torch_tag_losses.py, test_torch_mpn_tag.py)."""
    port_cfg, _, _, _, batches = setup_case("joint_type",
                                            MODEL={"LOSS": {"NAME": "node_edge_loss"}})
    trainer = build_trainer(port_cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="no node head"):
        trainer.loss(batch_to_torch(batches[0], "cpu"))
