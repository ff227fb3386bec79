"""The whole eval slice, port against JAX package: narrow HigherHRNet at
64x64, batch 2, K = 8, 3 fused MPN steps, decode. Also the weight carrier's
round trip through pemp_tpu.train.convert."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pemp_tpu.config import get_config
from pemp_tpu.decode.assembly import decode_poses as jax_decode
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.train.convert import convert_composite_state_dict
from pemp_tpu_torch.config import small
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.pipeline import Pipeline
from pemp_tpu_torch.weights import from_jax_variables

B = 2


def _jax_config(port_cfg):
    cfg = get_config()
    cfg.defrost()
    cfg.merge_from_other(port_cfg.to_dict())
    # the fused-step eval path and its asymmetric kNN layout; "auto" would
    # pick the symmetric einsum layout away from a TPU
    cfg.TPU.MSG_PASS = "fused_step"
    cfg.TPU.COLLECT_AUX = False
    cfg.freeze()
    return cfg


def _seeded_variables(jmodel, imgs, rng):
    """The model's variables, drawn with numpy: LeCun-normal kernels and
    non-trivial biases and BatchNorm statistics, so every weight the
    carrier maps counts. (Only the shapes come from flax: an eager
    ``init`` on the CPU takes most of a minute.)"""
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False), imgs
    )
    out = {}
    for path, leaf in flatten_dict(shapes).items():
        shape, name = leaf.shape, path[-1]
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) // (shape[0] if len(shape) == 3 else 1)
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:                                   # bias, mean
            v = rng.randn(*shape) * 0.1
        out[path] = np.asarray(v, np.float32)
    return unflatten_dict(out)


@pytest.fixture(scope="module")
def slice_run():
    port_cfg = small()
    jcfg = _jax_config(port_cfg)
    jmodel = jax_build_pose_model(jcfg, dtype=jnp.float32)
    # build_pose_model turns Pallas off away from a TPU; the interpret mode
    # runs the fused-step kernel on the CPU (as bench.py tunes mpn_cfg)
    jmodel.mpn_cfg["_USE_PALLAS"] = True
    jmodel.mpn_cfg["_PALLAS_INTERPRET"] = True
    assert jmodel.mpn_cfg.get("_FUSED_STEP")
    rng = np.random.RandomState(0)
    imgs = rng.rand(B, 64, 64, 3).astype(np.float32)
    variables = _seeded_variables(jmodel, jnp.asarray(imgs), rng)
    scoremaps, out = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(imgs))

    model = build_pose_model(port_cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_variables(
        variables["params"], variables["batch_stats"], port_cfg))
    pipe = Pipeline(model, port_cfg.MODEL.MPN.NODE_THRESHOLD, 17)
    persons, valid, p_scoremaps, p_out = pipe.forward(torch.from_numpy(imgs))
    return dict(jcfg=jcfg, port_cfg=port_cfg, variables=variables, jax=(scoremaps, out),
                port=(p_scoremaps, p_out, persons, valid))


def test_backbone_maps_match(slice_run):
    scoremaps, out = slice_run["jax"]
    p_scoremaps, p_out = slice_run["port"][:2]
    # f32 convolutions summed in another order over a ~30-conv network
    np.testing.assert_allclose(p_scoremaps.numpy(), np.asarray(scoremaps), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(p_out["graph"]["tags"].numpy(), np.asarray(out["graph"]["tags"]),
                               atol=1e-4, rtol=1e-4)


def test_graph_matches(slice_run):
    _, out = slice_run["jax"]
    p_out = slice_run["port"][1]
    for key in ("nodes", "edge_index", "edge_valid", "node_valid"):
        np.testing.assert_array_equal(p_out["graph"][key].numpy(),
                                      np.asarray(out["graph"][key]), err_msg=key)
    assert np.asarray(out["graph"]["edge_valid"]).sum() > 1000


def test_mpn_outputs_match(slice_run):
    _, out = slice_run["jax"]
    p_out = slice_run["port"][1]
    ev = np.asarray(out["graph"]["edge_valid"])
    # backbone differences of ~1e-5 pass through 3 MPN steps: the JAX
    # package's own fused-vs-plain MPN tolerance (2e-3)
    np.testing.assert_allclose(p_out["preds"]["edge"][-1].numpy()[ev],
                               np.asarray(out["preds"]["edge"][-1])[ev], atol=2e-3, rtol=2e-3)
    for key in ("node", "class"):
        np.testing.assert_allclose(p_out["preds"][key][-1].numpy(),
                                   np.asarray(out["preds"][key][-1]),
                                   atol=2e-3, rtol=2e-3, err_msg=key)


def test_persons_match(slice_run):
    """Decode is compared exactly, which is only sound where no sigmoid lies
    within 1e-4 of the 0.8 edge or 0.1 node threshold: the test checks that
    margin first."""
    scoremaps, out = slice_run["jax"]
    persons, valid = slice_run["port"][2:]
    g = out["graph"]
    edge_pred = jax.nn.sigmoid(out["preds"]["edge"][-1])
    node_pred = jax.nn.sigmoid(out["preds"]["node"][-1])
    class_prob = jax.nn.softmax(out["preds"]["class"][-1], axis=-1)
    ev = np.asarray(g["edge_valid"])
    assert np.all(np.abs(np.asarray(edge_pred)[ev] - 0.8) > 1e-4)
    assert np.all(np.abs(np.asarray(node_pred) - 0.1) > 1e-4)
    n = 17 * slice_run["port_cfg"].TPU.NODES_PER_TYPE
    e = g["edge_index"].shape[1] // B
    per_img = lambda x: x.reshape(B, -1, *x.shape[1:])  # noqa: E731
    decode = jax.jit(jax.vmap(functools.partial(
        jax_decode, node_threshold=0.1, num_joints=17, blocked_c=e // n, channels_last=True,
    )))
    local_ei = g["edge_index"].reshape(2, B, e).transpose(1, 0, 2) - (jnp.arange(B) * n)[:, None, None]
    wp, wv = decode(
        scoremaps, g["tags"], per_img(g["nodes"]), per_img(node_pred), local_ei,
        per_img(g["edge_valid"]), per_img(edge_pred), per_img(g["node_valid"]),
        class_probs=per_img(class_prob),
    )
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(persons[..., :2].numpy(), np.asarray(wp)[..., :2])
    np.testing.assert_allclose(persons[..., 2].numpy(), np.asarray(wp)[..., 2], atol=1e-6, rtol=0)


def test_weight_round_trip_is_exact(slice_run):
    """JAX variables -> port state_dict -> convert_composite_state_dict
    gives back the JAX variables bit for bit."""
    params, stats = slice_run["variables"]["params"], slice_run["variables"]["batch_stats"]
    sd = from_jax_variables(params, stats, slice_run["port_cfg"])
    back_params, back_stats = convert_composite_state_dict(
        {k: v.numpy() for k, v in sd.items()}, slice_run["jcfg"]
    )
    for want, got in ((params, back_params), (stats, back_stats)):
        fw, fg = flatten_dict(want), flatten_dict(got)
        assert set(fw) == set(fg)
        for key in fw:
            w, g_ = np.asarray(fw[key]), np.asarray(fg[key])
            assert w.shape == g_.shape and w.dtype == g_.dtype, key
            np.testing.assert_array_equal(g_, w, err_msg=str(key))
