"""The rest of test_torch_zoo_research_train.py's cases, on a worker of
their own: ``self_attention`` (NodeClassificationMPNSelfAttention, the
feature map passed to the MPN in training as the JAX model passes it) and
``vanilla2`` (VanillaMPN2, edge-only, trained by the edge loss): three
steps of ``train()`` against ``make_train_step``, losses within 5e-3.
VanillaMPN2 has no node head: the JAX trainer's graph reduction takes the
sigmoid of its ``None`` node output and fails
(pemp_tpu/train/train_step.py:79-85), so its step runs here with the
port's reading (no node output, no graph reduction), as
tests/test_torch_ablation_train.py runs VanillaMPN."""

from test_torch_ablation_train import no_node_head  # noqa: F401
from test_torch_zoo_train import losses_match


def test_self_attention_losses_match_make_train_step(tmp_path):
    parts = losses_match("self_attention", tmp_path)
    assert all(p["edge"] > 0 and p["node"] > 0 and p["class_loss"] > 0 for p in parts)


def test_vanilla2_losses_match_make_train_step(tmp_path, no_node_head):  # noqa: F811
    parts = losses_match("vanilla2", tmp_path)
    assert all(p["loss"] > 0 for p in parts)        # the edge loss alone
