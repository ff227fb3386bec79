"""The delta files of configs/matching_th, configs/semi_vs_pure and
configs/node_feature_selection through the eval entry point, port against
JAX package: ``python -m pemp_tpu_torch.valid`` against ``tools/valid.py``
with model_58_4 as the file and each delta's keys as KEY VALUE options, as
tests/test_torch_ablation_valid.py runs the connectivity deltas (narrow
configuration, one scale with flip, threshold grouping, 4 images of
tools/make_fake_coco.py): keypoints within 2e-3, scores within 1e-4. The
matching radius and the label method change only the training labels, so
those three run as model_58_4 does at eval."""

import pytest
from test_torch_ablation_deltas_train import DELTAS
from test_torch_ablation_valid import fake_coco, valid_matches  # noqa: F401  (fixture)


@pytest.mark.parametrize("name", DELTAS)
def test_delta_valid_matches_tools_valid(fake_coco, monkeypatch, name):  # noqa: F811
    valid_matches(fake_coco, monkeypatch, name, "threshold")
