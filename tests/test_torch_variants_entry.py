"""Two of config.VARIANTS through the eval entry point, port against JAX
package, as test_torch_ablation_valid.py holds the ablation deltas:
model_58_4 as the file and the variant's keys as KEY VALUE options, at the
narrow configuration.

``python -m pemp_tpu_torch.valid`` against ``tools/valid.py`` on a 4-image
set written by tools/make_fake_coco.py (one scale with flip, threshold
grouping) for a kernel-route variant, the per-type edge MLP (K2's plain
version here, where the route names the fused step), and an edge-list one,
the kNN edge list (the segment route): keypoints within 2e-3, scores within
1e-4. ``train()`` for the same two is held against tools/train.py in
test_torch_train_variants.py, a file of its own, so that the test
runner's workers share the two files' minutes."""

import pytest
import test_torch_ablation_valid as ablation_valid
from test_torch_ablation_valid import fake_coco, valid_matches  # noqa: F401 (fixture)

from pemp_tpu_torch.config import VARIANTS


def variant_options(name: str) -> list:
    """config.VARIANTS[name] as KEY VALUE options."""
    out = []

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out.extend([f"{prefix}{k}", repr(v)])

    walk(VARIANTS[name], "")
    return out


def test_variant_options_are_the_deltas():
    """The options give the variant's values over model_58_4, as
    config.variant merges them."""
    from pemp_tpu_torch.config import update_config_command, variant, w32_512_train

    for name in VARIANTS:
        got = update_config_command(w32_512_train(), variant_options(name))
        assert got.to_dict() == variant(name).to_dict(), name


@pytest.mark.parametrize("name", ["edge_mlp_per_type", "knn_list"])
def test_variant_valid_matches_tools_valid(fake_coco, monkeypatch, name):  # noqa: F811
    monkeypatch.setattr(ablation_valid, "delta_options", variant_options)
    valid_matches(fake_coco, monkeypatch, name, "threshold")
