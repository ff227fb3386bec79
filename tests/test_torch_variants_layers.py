"""The JAX package's MPN layer variants (config.VARIANTS' layer entries and
the small-cut values of VARIANT_CUTS), port against the JAX package on the
same weights (carried by weights.mpn_from_jax_variables), at narrow widths
on two images of 17 types x 3 nodes, inputs drawn with numpy.

Each variant runs on the routes the port resolves for it
(config.layer_route: the per-type edge MLP takes K2 where the route names
the fused step; an aggregation other than one attention head takes the
split linear and K4 or the plain per-type sum), in eval mode and in
training mode (masked BatchNorm statistics, the per-step heads). The JAX
side runs as its own CPU tests run it: the kNN layout pinned to the route
(the symmetric one with the reverse-edge projection for ``hybrid`` and
``einsum``, the asymmetric one with the all-types projection for the rest,
an edge list for ``segment``), with its Pallas kernels off, so it takes the
jnp form of the same function. Outputs within 2e-4 of each one's largest
(2e-3 on ``fused_step``); in training mode also the gradients of a fixed
linear function of every output, each parameter's within 5e-3 of its
largest (a gradient the JAX step gives as zero to rounding, 1e-6 of the
step's largest, is held to that: the attention heads' biases, constant
within each softmax group). The test suite runs close to its time limit, so the JAX side runs once a
(variant, layout, mode) and the gradients are held where a variant changes
what the backward sees: the per-type edge MLP on the three asymmetric-
layout routes (K2b's plain version on `pallas` and where the route names
the fused step, K4b's on `dots`), the per-type attention and the per-type
maximum on `pallas` and `dots`, the node-only stack with the late-fused
embedding (one run) on `pallas` and the fused step, and MPLayer's
per-type edge MLP with its update MLP on an edge list; two zoo models
read the layer keys as the flagship does (TypeBased's per-type edge MLP
and hierarchy on `pallas`, the Attention model's MPLayer options on
`agnostic`). The hierarchical
update's gradients are held on the module alone (its JAX step through the
MPN takes half a minute to compile on the CPU): what reaches the kernels'
backwards is the cotangent of the (N, T, D) messages, whatever update
follows them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pemp_tpu.config import get_config
from pemp_tpu.models.mpn.models import get_mpn_model as jax_get_mpn_model
from pemp_tpu.models.mpn.models import mpn_cfg_from_config
from pemp_tpu.ops import knn as jknn
from pemp_tpu_torch.config.defaults import layer_route
from pemp_tpu_torch.models.mpn.models import get_mpn_model
from pemp_tpu_torch.weights import mpn_from_jax_variables

J, K, B = 17, 3, 2
N_IMG = J * K
C = 8                      # kNN slots a node (k 4, cap 4)

NARROW = {
    "NAME": "NodeClassificationMPN", "STEPS": 3, "AGGR_TYPE": "per_type",
    "NODE_INPUT_DIM": 12, "EDGE_INPUT_DIM": 19, "NODE_FEATURE_DIM": 8,
    "EDGE_FEATURE_DIM": 8, "EDGE_FEATURE_HIDDEN": 8, "SKIP": True, "BN": False, "AGGR": "add",
    "AGGR_SUB": "node_edge_attn", "AUX_LOSS_STEPS": 1, "NODE_STEPS": 0,
    "NODE_EMB": {"BN": True, "END_WITH_RELU": False, "OUTPUT_SIZES": [16, 8]},
    "EDGE_EMB": {"BN": True, "END_WITH_RELU": False, "OUTPUT_SIZES": [8, 8, 8]},
    "EDGE_CLASS": {"BN": True, "OUTPUT_SIZES": [8, 1]},
    "NODE_CLASS": {"BN": True, "OUTPUT_SIZES": [8, 1]},
    "CLASS": {"BN": True, "OUTPUT_SIZES": [8, J]},
}
# the per-type edge MLP's output is EDGE_FEATURE_HIDDEN wide, and the JAX
# package's scanned steps need it as wide as the edge carry: 8, as the rest

# each variant's routes at eval and in training; the JAX side runs once a
# layout (the asymmetric kNN layout serves fused_step, pallas and dots, the
# symmetric one hybrid and einsum), so the routes of one layout share it
_ASYM = ("fused_step", "pallas", "dots")
_SYM = ("hybrid", "einsum")
VARIANTS = {
    "edge_mlp_per_type": ({"EDGE_MLP": "per_type"}, (*_ASYM, *_SYM), _ASYM),
    "update_hierarch": ({"UPDATE_TYPE": "hierarch_mlp"}, _ASYM, ()),
    "attn_per_type": ({"AGGR_SUB": "node_edge_attn_per_type"},
                      ("fused_step", "hybrid", "segment"), ("pallas", "dots")),
    "aggr_add": ({"AGGR_SUB": "None"}, ("fused_step", "einsum"), ()),
    "aggr_max": ({"AGGR_SUB": "None", "AGGR": "max"}, ("dots", "segment"), ("pallas", "dots")),
    "aggr_mean": ({"AGGR_SUB": "None", "AGGR": "mean"}, ("dots",), ()),
    # the node-only stack and the late-fused embedding in one training run
    "node_steps_late_fusion": ({"NODE_STEPS": 2, "LATE_FUSION_POS": True}, (),
                               ("fused_step", "pallas")),
    # MPLayer: the flagship with the agnostic layer, and VanillaMPN
    "mplayer_per_type": ({"AGGR_TYPE": "agnostic", "EDGE_MLP": "per_type",
                          "USE_NODE_UPDATE_MLP": True}, ("agnostic",), ("agnostic_list",)),
    "vanilla_per_type": ({"NAME": "VanillaMPN", "AGGR_TYPE": "agnostic", "EDGE_MLP": "per_type",
                          "USE_NODE_UPDATE_MLP": True, "DROP_FEATURE": "edge_dist"},
                         ("agnostic_list",), ()),
    # the zoo's models read the layer keys as the flagship does: TypeBased
    # on the per-type layer, the Attention model on MPLayer
    "zoo_type_based": ({"NAME": "NodeClassificationMPNTypeBased", "EDGE_MLP": "per_type",
                        "UPDATE_TYPE": "hierarch_mlp"}, ("pallas",), ("pallas",)),
    "zoo_attention": ({"NAME": "NodeClassificationMPNAttention", "AGGR_TYPE": "agnostic",
                       "EDGE_MLP": "per_type", "USE_NODE_UPDATE_MLP": True}, ("agnostic",), ()),
}
RUNS = [(v, r, mode) for v, (_, ev, tr) in VARIANTS.items()
        for mode, routes in (("eval", ev), ("train", tr)) for r in routes]


def _layout(route):
    """The graph layout a route runs on: the symmetric kNN layout for the
    reverse-permutation routes, the asymmetric one for the other kernel
    routes and MPLayer's ``agnostic``, an edge list for ``segment`` and
    ``agnostic_list``."""
    if route in ("hybrid", "einsum"):
        return "sym"
    if route in ("segment", "agnostic_list"):
        return "list"
    return "asym"


@functools.lru_cache(maxsize=None)
def _graph(layout, seed=0):
    rng = np.random.RandomState(seed)
    eis, evs = [], []
    for b in range(B):
        pos = jnp.asarray(rng.randint(0, 12, (N_IMG, 2)), jnp.float32)
        valid = jnp.asarray(rng.rand(N_IMG) > 0.2)
        if layout == "list":
            ei, ev = jknn.score_based_edges(pos, valid, jnp.asarray(rng.rand(N_IMG)), 9)
        else:
            ei, ev = jknn.knn_edges_target_major(pos, valid, 4, 4, symmetric=layout == "sym")
        eis.append(np.asarray(ei) + b * N_IMG)
        evs.append(np.asarray(ev))
    ei = np.concatenate(eis, 1).astype(np.int32)
    ev = np.concatenate(evs)
    n = B * N_IMG
    return {
        "x": rng.randn(n, NARROW["NODE_INPUT_DIM"]).astype(np.float32),
        "edge_attr": rng.randn(ei.shape[1], NARROW["EDGE_INPUT_DIM"]).astype(np.float32),
        "edge_index": ei, "edge_valid": ev,
        "node_types": ((np.arange(n) // K) % J).astype(np.int32),
        "node_valid": np.asarray(rng.rand(n) > 0.1),
    }


def _cfg(variant, layout, train):
    cfg = get_config()
    delta = {"edge_mlp_per_type_2": {"EDGE_MLP": "per_type_2"}}.get(variant)
    cfg.merge_from_other({"MODEL": {"MPN": {**NARROW, **(delta or VARIANTS[variant][0])}}})
    mpn = mpn_cfg_from_config(cfg.MODEL.MPN)
    mpn["_COLLECT_AUX"] = train          # the JAX eval entries: final heads only
    if layout != "list":
        mpn.update(_BLOCKED_C=C, _NODES_PER_TYPE=K)
    if layout == "sym":
        mpn["_TYPED_EINSUM"] = True      # the reverse-edge projection
    return mpn


def _weights(seed, e):
    rng = np.random.RandomState(seed)
    n = B * N_IMG
    return (rng.randn(e).astype(np.float32), rng.randn(n).astype(np.float32),
            rng.randn(n, J).astype(np.float32))


def _objective(out, ev, w, xp):
    """sum over heads and steps of the outputs times fixed weights (edges
    on the valid slots only)."""
    we, wn, wc = w
    total = 0.0
    for p in out["edge"]:
        total = total + (xp.where(ev, p, 0.0) * we).sum()
    for p in out["node"]:
        if p is not None:
            total = total + (p * wn).sum()
    for p in out["class"] or []:
        total = total + (p * wc).sum()
    return total


@functools.lru_cache(maxsize=None)
def _jax_run(variant, layout, train):
    """(params, stats, JAX outputs, JAX gradients of the objective or None)."""
    mpn = _cfg(variant, layout, train)
    g = _graph(layout)
    jm = jax_get_mpn_model(mpn)
    args = tuple(jnp.asarray(g[k]) for k in ("x", "edge_attr", "edge_index", "node_types",
                                              "node_valid", "edge_valid"))
    variables = jm.init(jax.random.PRNGKey(0), *args, train=False)
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(rng.uniform(0.5, 1.5, v.shape), np.float32),
        variables.get("batch_stats", {}))
    # flax initialises biases at 0: draw them, so that each is carried
    params = unflatten_dict({
        k: v + np.asarray(rng.randn(*v.shape) * 0.1, np.float32) if k[-1] == "bias" else v
        for k, v in flatten_dict(variables["params"]).items()})
    if not train:
        return params, stats, jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
            {"params": params, "batch_stats": stats}, *args), None
    w = tuple(jnp.asarray(a) for a in _weights(2, g["edge_index"].shape[1]))
    ev = jnp.asarray(g["edge_valid"])

    def loss(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, *args, train=True,
                          mutable=["batch_stats"])
        return _objective(out, ev, w, jnp), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return params, stats, out, grads


def _port(variant, layout, params, stats, route):
    mpn = _cfg(variant, layout, True)
    plain = route if route in ("segment", "agnostic") else None
    plain = "agnostic" if route == "agnostic_list" else plain
    port = get_mpn_model({**mpn, "_PLAIN_ROUTE": plain})
    port.load_state_dict(mpn_from_jax_variables(params, stats, mpn))
    return port, plain


def _assert_close(got, want, ev, tol):
    for key in ("edge", "node", "class"):
        w = want[key]
        if w is None or w == [None]:
            assert got[key] == w, key
            continue
        assert len(got[key]) == len(w), key
        for gt, ww in zip(got[key], w):
            ww = np.asarray(ww)
            gt = gt.detach().numpy()
            if key == "edge":
                gt, ww = gt[ev], ww[ev]
            scale = float(np.abs(ww).max())
            np.testing.assert_allclose(gt, ww, atol=tol * scale, rtol=0, err_msg=key)


def _assert_grads_close(port, grads, stats, mpn):
    want = mpn_from_jax_variables(grads, stats, mpn)
    params = dict(port.named_parameters())
    assert set(params) <= set(want)
    top = max(float(want[k].abs().max()) for k in params)
    for name, p in params.items():
        w = want[name].float()
        got = torch.zeros_like(p) if p.grad is None else p.grad
        scale = float(w.abs().max())
        if scale <= 1e-6 * top:           # zero to rounding in the JAX step
            assert float(got.abs().max()) <= 1e-6 * top, name
        else:
            err = float((got - w).abs().max())
            assert err <= 5e-3 * scale, (name, err, scale)


@pytest.mark.parametrize("variant,route,mode", RUNS, ids=[f"{v}-{r}-{m}" for v, r, m in RUNS])
def test_variant_layer_matches_jax(variant, route, mode):
    train = mode == "train"
    layout = _layout(route)
    params, stats, want, grads = _jax_run(variant, layout, train)
    g = _graph(layout)
    port, plain = _port(variant, layout, params, stats, route)
    port.train(train)
    t = torch.from_numpy
    got = port(t(g["x"]), t(g["edge_attr"]), t(g["edge_index"]), t(g["edge_valid"]),
               t(g["edge_index"][0] % N_IMG), torch.float32, node_valid=t(g["node_valid"]),
               route=None if plain else route, node_types=t(g["node_types"]))
    _assert_close(got, want, g["edge_valid"], 2e-3 if route == "fused_step" else 2e-4)
    if train:
        w = tuple(torch.from_numpy(a) for a in _weights(2, g["edge_index"].shape[1]))
        _objective(got, torch.from_numpy(g["edge_valid"]), w, torch).backward()
        _assert_grads_close(port, grads, stats, _cfg(variant, layout, True))


@pytest.mark.parametrize("num_types", [17, 14])
def test_hierarch_update_matches_jax(num_types):
    """HierarchUpdateMlp against the JAX module at COCO's 17 types and
    CrowdPose's 14: the output, and the gradients of a fixed linear
    function of it with respect to every weight and to the input (the
    cotangent the kernels' backwards receive), each within 5e-3 of its
    largest (outputs 2e-4)."""
    from pemp_tpu.models.mpn.layers import HierarchUpdateMlp as JaxHierarch
    from pemp_tpu_torch.models.mpn.layers import HierarchUpdateMlp

    rng = np.random.RandomState(num_types)
    u = rng.randn(40, num_types, 8).astype(np.float32)
    w = rng.randn(40, 8).astype(np.float32)
    jm = JaxHierarch(8, num_types)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(u))["params"]
    params = jax.tree_util.tree_map(
        lambda v: v + np.asarray(rng.randn(*v.shape) * 0.1, np.float32), params)
    fn = jax.jit(jax.value_and_grad(lambda p, x: (jm.apply({"params": p}, x) * w).sum(),
                                    argnums=(0, 1)))
    (_, (gp, gx)) = fn(params, jnp.asarray(u))
    port = HierarchUpdateMlp(8, num_types)
    port.load_state_dict({f"{k}.{t}": torch.from_numpy(np.array(
        params[k]["kernel"].T if t == "weight" else params[k]["bias"]))
        for k in params for t in ("weight", "bias")})
    x = torch.from_numpy(u).requires_grad_()
    out = port(x)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jm.apply({"params": params},
                                                                         jnp.asarray(u))),
                               rtol=0, atol=2e-4 * float(out.abs().max()))
    (out * torch.from_numpy(w)).sum().backward()
    pairs = [(x.grad, np.asarray(gx))] + [
        (getattr(port, k).weight.grad, np.asarray(gp[k]["kernel"]).T) for k in gp] + [
        (getattr(port, k).bias.grad, np.asarray(gp[k]["bias"])) for k in gp]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=5e-3 * float(np.abs(want).max()))


@pytest.mark.parametrize("variant,route,train,form", [
    ("edge_mlp_per_type", "fused_step", False, "pallas"),
    ("edge_mlp_per_type", "fused_step", True, "pallas"),
    ("edge_mlp_per_type_2", "fused_step", False, "pallas"),
    ("edge_mlp_per_type", "hybrid", True, "hybrid"),
    ("update_hierarch", "fused_step", True, "fused_step"),
    ("attn_per_type", "fused_step", False, "dots"),
    ("attn_per_type", "pallas", True, "dots"),
    ("attn_per_type", "hybrid", False, "einsum"),
    ("aggr_add", "dots", True, "dots"),
    ("aggr_add", "einsum", False, "einsum"),
    ("node_steps_late_fusion", "fused_step", True, "fused_step"),
    ("node_steps_late_fusion", "fused_step", False, "fused_step"),
])
def test_variant_route_forms(variant, route, train, form):
    """The form each variant's layer takes on a route, as the JAX layer
    takes it on a TPU (config.layer_route, pemp_tpu/models/mpn/layers.py:
    393-404, 551-556, 630-662); ``auto`` resolves to the fused step at eval
    and pallas in training before that."""
    mpn = _cfg(variant, "asym", train)
    assert layer_route(route, mpn.get("EDGE_MLP", "agnostic"), mpn["AGGR_SUB"]) == form
    port = get_mpn_model({**mpn, "_MSG_PASS": route})
    port.train(train)
    assert port._route(None) == form
    port = get_mpn_model({**mpn, "_MSG_PASS": "auto"})
    port.train(train)
    auto = "pallas" if train else "fused_step"
    assert port._route(None) == layer_route(auto, mpn.get("EDGE_MLP", "agnostic"),
                                            mpn["AGGR_SUB"])


@pytest.mark.parametrize("extra,key", [
    ({"EDGE_MLP": "per_type_3"}, "EDGE_MLP"),
    ({"AGGR_TYPE": "agnostic", "EDGE_MLP": "per_type_2"}, "EDGE_MLP"),
    ({"UPDATE_TYPE": "hierarch_cnn"}, "UPDATE_TYPE"),
    ({"UPDATE_TYPE": "hierarch_mlp", "NODE_TYPE_SUMMARY": "left_right"}, "hierarch_mlp"),
    ({"AGGR_SUB": "None", "AGGR": "sum"}, "AGGR"),
    ({"DROP_FEATURE": "edge_dist"}, "DROP_FEATURE"),
    ({"NAME": "VanillaMPN", "AGGR_TYPE": "agnostic", "DROP_FEATURE": "edge_angle"},
     "DROP_FEATURE"),
    ({"NAME": "VanillaMPN", "AGGR_TYPE": "agnostic", "LATE_FUSION_POS": True},
     "LATE_FUSION_POS"),
    ({"NAME": "VanillaMPN2", "AGGR_TYPE": "agnostic", "EDGE_MLP": "per_type"}, "EDGE_MLP"),
    ({"NAME": "NodeClassificationMPNTag", "UPDATE_TYPE": "hierarch_cnn"}, "UPDATE_TYPE"),
])
def test_values_neither_package_runs_are_refused(extra, key):
    """What neither package implements (an unknown edge MLP or update, on
    the flagship or a zoo model, the per_type_2 edge MLP on MPLayer, which
    the JAX MPLayer raises on, the hierarchy at 9 summary types, an unknown
    aggregation), and a key on a model that does not read it (VanillaMPN2's
    own layer has no per-type edge MLP), raise by name at build."""
    with pytest.raises(NotImplementedError, match=key):
        get_mpn_model({**_cfg("edge_mlp_per_type", "asym", False), "EDGE_MLP": "agnostic",
                       **extra})
