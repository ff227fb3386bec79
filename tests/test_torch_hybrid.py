"""The split edge MLP's message paths, port against the JAX package: the
type-blocked projection (TypeAwareSplitLinear with ``rev_perm``), the
flagship MPN on the ``hybrid`` route (K3 in interpret mode on the JAX side),
the ``einsum`` and ``dots`` routes (the JAX jnp aggregate) at eval and in
training and the ``pallas`` route at eval (K2's bf16-capable kernel in
interpret mode), and one small_train step on ``hybrid`` (K3 and its
backward kernel K3b in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_slice import _seeded_variables
from test_torch_train_step import STEM, _jax_loss_fn

from pemp_tpu.config import get_config
from pemp_tpu.losses import dispatch_loss_func as jax_dispatch_loss_func
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.models.mpn.layers import TypeAwareSplitLinear, fused_tile_ok
from pemp_tpu.models.mpn.models import NodeClassificationMPN as JaxMPN
from pemp_tpu.models.mpn.models import mpn_cfg_from_config
from pemp_tpu.ops.knn import knn_edges_target_major as jax_knn
from pemp_tpu.ops.knn import reverse_edge_perm as jax_reverse_edge_perm
from pemp_tpu.train.convert import convert_composite_state_dict
from pemp_tpu_torch.config import small_train
from pemp_tpu_torch.config.defaults import W48_640
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.models.mpn.layers import type_aware_split_linear
from pemp_tpu_torch.models.mpn.models import NodeClassificationMPN
from pemp_tpu_torch.ops import attn_aggregate, blocked_attn, typed_message
from pemp_tpu_torch.ops.knn import reverse_edge_perm
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
from pemp_tpu_torch.weights import from_jax_variables, mpn_from_jax_variables


def _t(a):
    return torch.from_numpy(np.array(a))


def _symmetric_graph(rng, raw, kpt, k, cap, imgs=1, grid=50.0):
    """Symmetric target-major layouts of ``imgs`` images of raw * kpt
    type-blocked nodes, flattened with offset node ids."""
    n_img = raw * kpt
    eis, evs = [], []
    for i in range(imgs):
        pos = jnp.asarray(rng.rand(n_img, 2) * grid, jnp.float32)
        valid = jnp.asarray(rng.rand(n_img) > 0.2)
        ei, ev = jax_knn(pos, valid, k, cap_in=cap, symmetric=True)
        eis.append(np.asarray(ei) + i * n_img)
        evs.append(np.asarray(ev))
    return np.concatenate(eis, axis=1), np.concatenate(evs), imgs * n_img


@pytest.mark.parametrize("summary", [None, "pairs"])
def test_type_aware_split_linear_matches_jax(summary):
    """The port's projection (weights in nn.Linear's layout) against the
    JAX module, with and without a raw-to-summary type map, on the valid
    slots (the only ones the aggregates read)."""
    rng = np.random.RandomState(3 if summary is None else 4)
    raw, kpt, k, cap = 6, 4, 5, 3
    ei, ev, n = _symmetric_graph(rng, raw, kpt, k, cap)
    c, e = ei.shape[1] // n, ei.shape[1]
    sum_map = None if summary is None else np.array([0, 0, 1, 1, 2, 2], np.int32)
    num_types = raw if sum_map is None else 3
    x = rng.randn(n, 8).astype(np.float32)
    ef = rng.randn(e, 7).astype(np.float32)
    raw_types = (np.arange(n) // kpt) % raw
    src_type = (raw_types if sum_map is None else sum_map[raw_types])[ei[0]].astype(np.int32)
    mod = TypeAwareSplitLinear(num_types, 9, raw_blocks=raw, block_slots=kpt * c)
    jrp = jax_reverse_edge_perm(jnp.asarray(ei[0]), jnp.asarray(ev), n, c)
    jargs = (jnp.asarray(x), jnp.asarray(ei[1]), jnp.asarray(ef), jnp.asarray(src_type))
    params = mod.init(jax.random.PRNGKey(0), *jargs)
    params = jax.tree_util.tree_map(lambda p: p + 0.1 * jnp.ones_like(p), params)   # bias != 0
    want = mod.apply(params, *jargs, rev_perm=jrp,
                     sum_map=None if sum_map is None else jnp.asarray(sum_map))
    kernel = np.asarray(params["params"]["kernel"])          # (T, dn + De, D)
    rp = reverse_edge_perm(_t(ei[0]), _t(ev), n, c).long()
    got = type_aware_split_linear(
        _t(x), _t(ef), _t(src_type), _t(kernel.transpose(0, 2, 1)),
        _t(params["params"]["bias"]), rp, raw, kpt * c,
        None if sum_map is None else _t(sum_map).long())
    np.testing.assert_allclose(got.numpy()[ev], np.asarray(want)[ev], rtol=1e-5, atol=1e-5)


def _mpn_inputs(rng, kpt=8, k=8, cap=8, imgs=2):
    ei, ev, n = _symmetric_graph(rng, 17, kpt, k, cap, imgs=imgs, grid=40.0)
    x = rng.randn(n, 128).astype(np.float32)
    ea = rng.randn(ei.shape[1], 19).astype(np.float32)
    types = ((np.arange(n) // kpt) % 17).astype(np.int32)
    node_valid = rng.rand(n) > 0.1
    return (x, ea, ei, types, node_valid, ev), 17 * kpt, ei.shape[1] // n


@pytest.fixture(scope="module")
def mpn_setup():
    """Shared weights for every route: the parameters are the same
    (mlp_node, attn_net) whichever form the step takes."""
    rng = np.random.RandomState(0)
    args, n_img, c = _mpn_inputs(rng)
    cfg = get_config()
    cfg.merge_from_other({"MODEL": {"MPN": W48_640["MODEL"]["MPN"]}})
    mpn_cfg = mpn_cfg_from_config(cfg.MODEL.MPN)
    mpn_cfg.update(STEPS=3, AUX_LOSS_STEPS=1, _BLOCKED_C=c, _NODES_PER_TYPE=8)
    jargs = tuple(jnp.asarray(a) for a in args)
    init_model = JaxMPN({**mpn_cfg, "_TYPED_EINSUM": True, "_COLLECT_AUX": False})
    variables = init_model.init(jax.random.PRNGKey(0), *jargs)
    # the hybrid branch of the JAX layer runs only under its tile gate
    assert fused_tile_ok(args[0].shape[0], c, 17)
    return dict(args=args, jargs=jargs, mpn_cfg=mpn_cfg, variables=variables, n_img=n_img)


ROUTES = {
    # route: (the JAX model's switches, train); the JAX package's
    # build_pose_model sets _TYPED_EINSUM for hybrid and einsum only and
    # _USE_PALLAS off for einsum and dots
    "hybrid_eval": ({"_USE_PALLAS": True, "_PALLAS_INTERPRET": True}, False),
    "hybrid_train": ({"_USE_PALLAS": True, "_PALLAS_INTERPRET": True}, True),
    "einsum_eval": ({}, False),
    "einsum_train": ({}, True),
    "dots_eval": ({"_TYPED_EINSUM": False}, False),
    "dots_train": ({"_TYPED_EINSUM": False}, True),
    "pallas_eval": ({"_TYPED_EINSUM": False, "_USE_PALLAS": True, "_PALLAS_INTERPRET": True},
                    False),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_mpn_route_matches_jax(mpn_setup, route):
    switches, train = ROUTES[route]
    msg_pass = route.split("_")[0]
    s = mpn_setup
    jax_mpn = JaxMPN({**s["mpn_cfg"], "_TYPED_EINSUM": True, "_COLLECT_AUX": False, **switches})
    if train:
        want, _ = jax_mpn.apply(s["variables"], *s["jargs"], train=True,
                                mutable=["batch_stats"])
    else:
        want = jax_mpn.apply(s["variables"], *s["jargs"])

    port = NodeClassificationMPN({**s["mpn_cfg"], "_MSG_PASS": msg_pass})
    port.load_state_dict(mpn_from_jax_variables(
        s["variables"]["params"], s["variables"]["batch_stats"], s["mpn_cfg"]))
    port.train(train)
    x, ea, ei, _, node_valid, ev = s["args"]
    before = (attn_aggregate.LAUNCHES_FWD, blocked_attn.LAUNCHES, typed_message.LAUNCHES_FWD)
    with torch.no_grad():
        got = port(_t(x), _t(ea), _t(ei), _t(ev), _t(ei[0] % s["n_img"]), torch.float32,
                   node_valid=_t(node_valid))
    assert (attn_aggregate.LAUNCHES_FWD, blocked_attn.LAUNCHES,
            typed_message.LAUNCHES_FWD) == before   # CPU: plain
    # tests/test_typed_einsum.py:236-250's tolerance between message paths
    for key in ("edge", "node", "class"):
        assert len(got[key]) == len(want[key]), key
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            g, w = g.numpy(), np.asarray(w)
            if key == "edge":
                g, w = g[ev], w[ev]
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4, err_msg=f"{key}[{i}]")


@pytest.fixture(scope="module")
def hybrid_step():
    """One small_train step on MSG_PASS=hybrid, as
    tests/test_torch_train_step.py's on pallas."""
    port_cfg = small_train()
    port_cfg.TPU.MSG_PASS = "hybrid"
    jcfg = get_config()
    jcfg.defrost()
    jcfg.merge_from_other(port_cfg.to_dict())
    jcfg.freeze()
    jmodel = jax_build_pose_model(jcfg, dtype=jnp.float32)
    assert jmodel.mpn_cfg.get("_TYPED_EINSUM")
    jmodel.mpn_cfg["_USE_PALLAS"] = True
    jmodel.mpn_cfg["_PALLAS_INTERPRET"] = True
    rng = np.random.RandomState(0)
    batch = make_batch(rng, 2, 64, (16, 32), 17, 30, scale_range=(0.4, 0.9))
    variables = _seeded_variables(jmodel, jnp.asarray(batch["imgs"]), rng)
    loss_fn = _jax_loss_fn(jmodel, jax_dispatch_loss_func(jcfg), jcfg)
    (loss, (_, logging, labels, _)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"],
            jax.tree_util.tree_map(jnp.asarray, batch))

    trainer = build_trainer(port_cfg, device="cpu")
    trainer.model.load_state_dict(from_jax_variables(
        variables["params"], variables["batch_stats"], port_cfg))
    p_loss, p_logging, p_out = trainer.loss(batch_to_torch(batch, "cpu"))
    p_loss.backward()
    n = p_out["graph"]["node_valid"].numel()
    assert fused_tile_ok(n, trainer.model.gc.slots, 17)
    return dict(jcfg=jcfg, jax=(loss, logging, labels, grads), port=(p_loss, p_logging, p_out),
                trainer=trainer)


def test_hybrid_step_labels_and_loss(hybrid_step):
    """The symmetric graph's labels exactly, the loss parts at 1e-4."""
    loss, logging, labels, _ = hybrid_step["jax"]
    p_loss, p_logging, p_out = hybrid_step["port"]
    assert hybrid_step["trainer"].model.gc.knn_symmetric
    for key in ("node", "class", "person"):
        np.testing.assert_array_equal(p_out["labels"][key].numpy(), np.asarray(labels[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(p_out["labels"]["edge"][0].numpy(),
                                  np.asarray(labels["edge"][0]))
    for key in ("heatmap", "node", "edge", "class_loss", "loss"):
        np.testing.assert_allclose(float(p_logging[key].detach()), float(logging[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(p_loss), float(loss), rtol=1e-4)


def test_hybrid_step_gradients_match_per_tensor(hybrid_step):
    """Every parameter's gradient within 5e-3 of that tensor's largest
    |grad| (5e-2 on the backbone's stem): tests/test_torch_train_step.py's
    tolerances."""
    grads = hybrid_step["jax"][3]
    model = hybrid_step["trainer"].model
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
          for k, p in model.named_parameters()}
    sd.update({k: b.numpy() for k, b in model.named_buffers()})
    got, _ = convert_composite_state_dict(sd, hybrid_step["jcfg"])
    want, got = flatten_dict(grads), flatten_dict(got)
    assert set(want) == set(got)
    for key in want:
        w, g = np.asarray(want[key]), np.asarray(got[key])
        tol = 5e-2 if key[:2] in STEM else 5e-3
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * float(np.abs(w).max()),
                                   err_msg=str(key))
