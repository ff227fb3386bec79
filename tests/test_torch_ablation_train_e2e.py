"""class_agnostic_end2end/model_57_1 through ``train()``, port against the
JAX package's ``make_train_step``: three steps at the small model_58_4 cut
with the delta's keys as options (the loss list without ``class``,
backbone trained end to end), losses within 5e-3. The comparison is
test_torch_ablation_train.py's; this case is a file of its own because its
JAX step takes minutes to compile on the CPU."""

from test_torch_ablation_train import no_node_head, train_losses_match  # noqa: F401


def test_model_57_1_train_losses_match_make_train_step(tmp_path, no_node_head):  # noqa: F811
    train_losses_match("model_57_1", tmp_path)
