"""The six feature-importance deltas (edge features [nothing], [position],
[connection_type], per type and type-agnostic) through the eval entry
point, port against JAX package: test_torch_ablation_valid.py's
comparison, in a file of its own so that it runs beside the connectivity
half."""

import pytest
from test_torch_ablation_valid import DELTAS, fake_coco, valid_matches  # noqa: F401


@pytest.mark.parametrize("name", DELTAS[3:])
def test_feature_importance_valid_matches_tools_valid(fake_coco, monkeypatch, name):  # noqa: F811
    valid_matches(fake_coco, monkeypatch, name, "threshold")
