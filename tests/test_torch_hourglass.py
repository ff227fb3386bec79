"""The Hourglass backbone, port against JAX package on one set of seeded
weights carried by weights.from_jax_variables: PoseNet's per-stack
predictions and feature map, hg_process_output, the composite model's
backbone_forward on the Hourglass (process output, then the feature
gather), and the weight carrier's round trip through
pemp_tpu.train.convert.convert_hourglass_state_dict. Narrow cuts (1-2
stacks, 16 wide) at 64x64: the network is fully convolutional, and the
nested blocks still add 128 channels a level."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_slice import _seeded_variables

from pemp_tpu.config import get_config as jax_get_config
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.models.hourglass import PoseNet as JaxPoseNet
from pemp_tpu.models.hourglass import hg_process_output as jax_hg_process_output
from pemp_tpu.train.convert import convert_hourglass_state_dict
from pemp_tpu_torch.config import small_hg
from pemp_tpu_torch.config.defaults import _FLAGSHIP_MPN
from pemp_tpu_torch.models.hourglass import PoseNet, hg_process_output
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.weights import from_jax_variables


def _close(got, want):
    """Within 1e-5 of the largest |value|: f32 convolutions summed in
    another order over 30-60 layers."""
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _hg_cfg(nstack, inp_dim):
    cfg = small_hg()
    cfg.MODEL.HG.NSTACK, cfg.MODEL.HG.INPUT_DIM = nstack, inp_dim
    return cfg


@pytest.fixture(scope="module", params=[(1, 16), (2, 16)], ids=lambda p: f"{p[0]}x{p[1]}")
def posenet_run(request):
    nstack, inp_dim = request.param
    jmodel = JaxPoseNet(nstack, inp_dim, 68)
    rng = np.random.RandomState(0)
    imgs = rng.rand(2, 64, 64, 3).astype(np.float32)
    variables = _seeded_variables(jmodel, jnp.asarray(imgs), rng)
    preds, feature = jax.jit(lambda v, x: jmodel.apply(v, x))(variables, jnp.asarray(imgs))
    sd = from_jax_variables({"backbone": variables["params"]}, {}, _hg_cfg(nstack, inp_dim))
    model = PoseNet(nstack, inp_dim, 68)
    model.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    with torch.no_grad():
        p_preds, p_feature = model(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    return dict(nstack=nstack, variables=variables, sd=sd, jax=(preds, feature),
                port=(p_preds, p_feature))


def test_posenet_matches(posenet_run):
    preds, feature = posenet_run["jax"]
    p_preds, p_feature = posenet_run["port"]
    assert len(p_preds) == len(preds) == posenet_run["nstack"]
    for got, want in zip(p_preds, preds):
        _close(_nhwc(got), want)
    _close(_nhwc(p_feature), feature)
    assert _nhwc(p_feature).shape == (2, 16, 16, 16)


def test_hg_process_output_matches(posenet_run):
    want = jax_hg_process_output(*posenet_run["jax"], num_joints=17, mode="avg")
    got = hg_process_output(*posenet_run["port"], num_joints=17)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    assert got[0].shape[-1] == got[2].shape[-1] == 17


def test_weight_round_trip_is_exact(posenet_run):
    """JAX params -> the port's state_dict -> convert_hourglass_state_dict
    gives the JAX params back bit for bit, and every port weight is one."""
    sd = {k[len("backbone."):]: v.numpy() for k, v in posenet_run["sd"].items()}
    params, stats = convert_hourglass_state_dict(sd, nstack=posenet_run["nstack"])
    want = flatten_dict(posenet_run["variables"]["params"])
    got = flatten_dict(params)
    assert set(got) == set(want) and stats == {}
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=str(key))
    assert len(sd) == len(want)


def test_composite_backbone_forward_matches():
    """PoseEstimationBaseline on the Hourglass: the maps and the gathered
    features (feature_gather on the last stack's INPUT_DIM-wide map, after
    the output is processed, as the JAX package orders it)."""
    port_cfg = _hg_cfg(2, 16)
    port_cfg.merge_from_other({"MODEL": {"MPN": {**_FLAGSHIP_MPN, "STEPS": 3}},
                               "TPU": {"NODES_PER_TYPE": 8}})
    jcfg = jax_get_config()
    jcfg.defrost()
    jcfg.merge_from_other(port_cfg.to_dict())
    jcfg.freeze()
    jmodel = jax_build_pose_model(jcfg)
    rng = np.random.RandomState(1)
    imgs = rng.rand(2, 64, 64, 3).astype(np.float32)
    variables = _seeded_variables(jmodel, jnp.asarray(imgs), rng)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, method=jmodel.backbone_forward))(
        variables, jnp.asarray(imgs))
    model = build_pose_model(port_cfg, device="cpu", path="valid")
    assert model.feature_gather.in_channels == 16
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"],
                                             port_cfg))
    with torch.no_grad():
        got = model.backbone_forward(torch.from_numpy(imgs))
    for g, w in zip(got[0], want[0]):
        _close(g.numpy(), w)
    for g, w in zip(got[1:], want[1:]):
        _close(g.numpy(), w)
