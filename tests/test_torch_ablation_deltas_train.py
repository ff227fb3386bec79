"""The delta files of configs/matching_th, configs/semi_vs_pure and
configs/node_feature_selection on the training path, port against the
JAX package: model_58_4's small cut with each delta's keys as KEY VALUE
options (the matching radius 0.3 and 0.7, label method 6, HigherHRNet's
``avg``, ``large`` and ``small`` feature fusion), one step each, held as
tests/test_torch_gt_train.py holds a step: labels and masks exactly,
logits within 2e-4 of their largest, the loss within 1e-4, gradients
within 5e-3 of each tensor's largest against the JAX package (against its
float64 step for the tensors named in ``HELD_TO_F64``). ``hrnet_cat`` is refused by both packages.
"""

import jax.numpy as jnp
import pytest
from test_torch_ablation_valid import delta_options
from test_torch_gt_train import step_matches

from pemp_tpu.config import get_config as jax_get_config
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu_torch.config import small_train, update_config_command
from pemp_tpu_torch.models.pose_estimation import build_pose_model

DELTAS = ["matching_th/matching_03", "matching_th/matching_07", "semi_vs_pure/pure",
          "node_feature_selection/hrnet_avg", "node_feature_selection/hrnet_large",
          "node_feature_selection/hrnet_small"]


# the tensors whose JAX float32 gradient is more than 5e-3 of its largest
# from the JAX float64 step's: the port is held to the float64 one there
HELD_TO_F64 = {"node_feature_selection/hrnet_large": ["mpn.mpn_node_cls.mlp_node.mlp.6.0.weight"]}


@pytest.mark.parametrize("name", DELTAS)
def test_delta_first_step_matches_jax(name):
    assert step_matches(delta_options(name), min_positive=(5, 10)) == HELD_TO_F64.get(name, [])


def test_hrnet_cat_is_refused_by_both():
    """FEATURE_FUSION ``cat``: the port refuses it when it builds the
    backbone, the JAX package at its first call (pemp_tpu/models/hrnet.py:
    578)."""
    opts = delta_options("node_feature_selection/hrnet_cat")
    cfg = update_config_command(small_train(), opts)
    assert cfg.MODEL.HRNET.FEATURE_FUSION == "cat"
    with pytest.raises(NotImplementedError, match="cat"):
        build_pose_model(cfg, device="cpu", path="train")
    jcfg = jax_get_config()
    jcfg.defrost()
    jcfg.merge_from_other(cfg.to_dict())
    jcfg.freeze()
    jmodel = jax_build_pose_model(jcfg)
    import jax

    with pytest.raises(NotImplementedError):
        jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
                       jnp.zeros((1, 64, 64, 3)))
