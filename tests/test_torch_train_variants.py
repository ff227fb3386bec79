"""``train()`` on two of config.VARIANTS, port against JAX package: three
steps against tools/train.py's ``make_train_step`` on the same batches and
weights, as test_torch_ablation_train.py holds the deltas of configs/ (the
small model_58_4 cut with the variant's keys as options,
test_torch_variants_entry.variant_options), for a kernel-route variant,
the per-type edge MLP (K2's plain version here, on ``pallas``), and an
edge-list one, the kNN edge list (the ``segment`` route): losses within
5e-3, the first within 1e-4.

The backbone is frozen, as train/model_50_4 and train/model_56_2 freeze
theirs: the variants act in the graph and the MPN, and the JAX step
through the backbone's backward takes about three times as long to compile
on the CPU (145 s against 42 s for the per-type edge MLP). On the kNN edge
list the JAX step's second batch takes about 70 s on the CPU whatever its
place in the run (the batches are the small cut's own draws)."""

import pytest
import test_torch_ablation_train as ablation_train
from test_torch_variants_entry import variant_options

FROZEN = ["TRAIN.END_TO_END", "False", "TRAIN.KP_FREEZE_MODE", "'complete'"]


@pytest.mark.parametrize("name", ["edge_mlp_per_type", "knn_list"])
def test_variant_train_matches_tools_train(tmp_path, monkeypatch, name):
    monkeypatch.setitem(ablation_train.CASES, name, variant_options(name) + FROZEN)
    ablation_train.train_losses_match(name, tmp_path)
