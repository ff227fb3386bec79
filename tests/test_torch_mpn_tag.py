"""The tag-regression, class-only, group-based and background MPNs, MPNTag
and the three baselines, port against the JAX package on the same weights
(carried by weights.mpn_from_jax_variables), at narrow widths on two
images of 17 types x 3 nodes.

Each model runs in eval mode and in training mode (masked BatchNorm
statistics) on every route it takes: the tag and class models on the
flagship's five (fused step at eval only; hybrid and einsum on the
symmetric kNN layout), the group-based model on pallas and dots, MPNTag
on the agnostic route. The JAX side runs its plain jnp layer on the same
graph (its kernels' math, held to their Pallas forms elsewhere). Outputs
within 2e-4 of each one's largest, 2e-3 on the fused step. Also: the
routes and names both packages refuse, and the weight carrier's round trip
back through pemp_tpu.train.convert, exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pemp_tpu.config import get_config
from pemp_tpu.models.mpn.models import get_mpn_model as jax_get_mpn_model
from pemp_tpu.models.mpn.models import mpn_cfg_from_config
from pemp_tpu.ops import knn as jknn
from pemp_tpu.train import convert
from pemp_tpu_torch.models.mpn.models import get_mpn_model
from pemp_tpu_torch.weights import mpn_from_jax_variables

J, K, B = 17, 3, 2
N_IMG = J * K
C = 8                      # kNN slots a node (k 4, cap 4)

NARROW = {
    "NAME": "NodeClassificationMPNTag", "STEPS": 3, "AGGR_TYPE": "per_type",
    "NODE_INPUT_DIM": 12, "EDGE_INPUT_DIM": 19, "NODE_FEATURE_DIM": 8, "EDGE_FEATURE_DIM": 8,
    "EDGE_FEATURE_HIDDEN": 8, "SKIP": True, "BN": False, "AGGR": "add",
    "AGGR_SUB": "node_edge_attn", "AUX_LOSS_STEPS": 1, "NODE_STEPS": 0,
    "NODE_EMB": {"BN": True, "END_WITH_RELU": False, "OUTPUT_SIZES": [16, 8]},
    "EDGE_EMB": {"BN": True, "END_WITH_RELU": False, "OUTPUT_SIZES": [8, 8]},
    "EDGE_CLASS": {"BN": True, "OUTPUT_SIZES": [8, 1]},
    "NODE_CLASS": {"BN": True, "OUTPUT_SIZES": [8, 1]},
    "CLASS": {"BN": True, "OUTPUT_SIZES": [8, J]},
    "NODE_TAG": {"BN": True, "OUTPUT_SIZES": [8, 1]},
}

MODELS = {
    "tag": {},
    "tag_skip_bn": {"TAG_SKIP": True, "BN": True},
    "tag_node_steps": {"NODE_STEPS": 2, "TAG_SKIP": True},
    "joint_type": {"NAME": "JointTypeClassification"},
    "group_based": {"NAME": "NodeClassificationMPNGroupBased"},
    "group_based_bn": {"NAME": "NodeClassificationMPNGroupBased", "BN": True},
    "background": {"NAME": "NodeClassificationMPNWithBackground",
                   "CLASS": {"BN": True, "OUTPUT_SIZES": [8, J + 1]}},
    "mpn_tag": {"NAME": "MPNTag", "AGGR_TYPE": "agnostic"},
}
ROUTES = {"eval": ("fused_step", "pallas", "hybrid", "einsum", "dots"),
          "train": ("pallas", "hybrid", "einsum", "dots")}
GROUP_ROUTES = ("pallas", "dots")


def _graph(symmetric, seed=0):
    """B images of type-blocked nodes on a small grid, the target-major kNN
    layout flattened; node and edge inputs, raw types, node validity and
    the joints' tags (two channels, as TTA's)."""
    rng = np.random.RandomState(seed)
    eis, evs = [], []
    for b in range(B):
        pos = jnp.asarray(rng.randint(0, 12, (N_IMG, 2)), jnp.float32)
        valid = jnp.asarray(rng.rand(N_IMG) > 0.2)
        ei, ev = jknn.knn_edges_target_major(pos, valid, 4, 4, symmetric=symmetric)
        eis.append(np.asarray(ei) + b * N_IMG)
        evs.append(np.asarray(ev))
    ei = np.concatenate(eis, 1).astype(np.int32)
    ev = np.concatenate(evs)
    n = B * N_IMG
    x = rng.randn(n, NARROW["NODE_INPUT_DIM"]).astype(np.float32)
    ea = rng.randn(ei.shape[1], NARROW["EDGE_INPUT_DIM"]).astype(np.float32)
    types = ((np.arange(n) // K) % J).astype(np.int32)
    node_valid = np.asarray(rng.rand(n) > 0.1)
    tags = rng.randn(n, 2).astype(np.float32)
    return x, ea, ei, ev, types, node_valid, tags


def _cfg(model, **extra):
    cfg = get_config()
    cfg.merge_from_other({"MODEL": {"MPN": {**NARROW, **MODELS[model], **extra}}})
    mpn = mpn_cfg_from_config(cfg.MODEL.MPN)
    # _COLLECT_AUX: the JAX eval entries' setting (the flagship's final heads only)
    mpn.update(_BLOCKED_C=C, _NODES_PER_TYPE=K, _COLLECT_AUX=False)
    return mpn


def _seeded(jm, args, kwargs):
    """The JAX model's variables with non-trivial BatchNorm statistics."""
    variables = jm.init(jax.random.PRNGKey(0), *args, **kwargs)
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(rng.uniform(0.5, 1.5, v.shape), np.float32),
        variables.get("batch_stats", {}))
    return variables["params"], stats


@functools.lru_cache(maxsize=None)
def _jax_run(model, symmetric, train, tag_dims):
    """(params, stats, JAX outputs, graph) for ``model`` on the layout, in
    the mode; ``tag_dims`` 1 or 2: the joints' tags as (N,) or (N, 2)."""
    mpn = _cfg(model)
    graph = _graph(symmetric)
    x, ea, ei, ev, types, node_valid, tags = graph
    if tag_dims == 1:
        tags = tags[:, 0]
    jm = jax_get_mpn_model(mpn)
    args = tuple(jnp.asarray(a) for a in (x, ea, ei, types, node_valid, ev))
    kwargs = {"joint_tags": jnp.asarray(tags)}
    params, stats = _seeded(jm, args, kwargs)
    variables = {"params": params, "batch_stats": stats}
    if train:
        want, _ = jm.apply(variables, *args, **kwargs, train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(variables, *args, **kwargs, train=False)
    return params, stats, want, graph, tags


def _port(model, params, stats, **extra):
    mpn = _cfg(model, **extra)
    port = get_mpn_model(mpn)
    port.load_state_dict(mpn_from_jax_variables(params, stats, mpn))
    return port


def _forward(port, graph, tags, route, train):
    x, ea, ei, ev, types, node_valid, _ = graph
    t = torch.from_numpy
    port.train(train)
    return port(t(x), t(ea), t(ei), t(ev), t(ei[0] % N_IMG), torch.float32,
                node_valid=t(node_valid), route=route, node_types=t(types),
                joint_tags=t(np.ascontiguousarray(tags)))


def _assert_close(got, want, ev, tol):
    for key in ("edge", "node", "class", "tag"):
        w = want[key]
        if w is None or w == [None]:
            assert got[key] == w, key
            continue
        assert len(got[key]) == len(w), key
        for g, ww in zip(got[key], w):
            ww = np.asarray(ww)
            g = g.detach().numpy()
            if key == "edge":
                g, ww = g[ev], ww[ev]
            scale = float(np.abs(ww).max())
            np.testing.assert_allclose(g, ww, atol=tol * scale, rtol=0, err_msg=key)


RUNS = [(m, r, mode) for m in ("tag", "tag_skip_bn", "tag_node_steps", "joint_type", "background")
        for mode in ("eval", "train") for r in ROUTES[mode]]
RUNS += [(m, r, mode) for m in ("group_based", "group_based_bn") for mode in ("eval", "train")
         for r in GROUP_ROUTES]
RUNS += [("mpn_tag", "agnostic", mode) for mode in ("eval", "train")]


@pytest.mark.parametrize("model,route,mode", RUNS, ids=[f"{m}-{r}-{mo}" for m, r, mo in RUNS])
def test_mpn_matches_jax(model, route, mode):
    train = mode == "train"
    symmetric = route in ("hybrid", "einsum")
    tag_dims = 2 if model == "tag_skip_bn" else 1
    params, stats, want, graph, tags = _jax_run(model, symmetric, train, tag_dims)
    port = _port(model, params, stats)
    got = _forward(port, graph, tags, route, train)
    _assert_close(got, want, graph[3], 2e-3 if route == "fused_step" else 2e-4)


@pytest.mark.parametrize("name", ["TagThreshold", "PlainTag", "LogisticEdgeClassifier"])
def test_baselines_match_jax(name):
    """The baselines pass no message: edge logits from the edge attributes
    (tag distance below 1, the raw attribute, a logistic regression);
    node and tag [None], class None, whatever route is named."""
    mpn = _cfg("tag", NAME=name)
    x, ea, ei, ev, types, node_valid, tags = _graph(False)
    jm = jax_get_mpn_model(mpn)
    ea[::3, 0] = np.abs(ea[::3, 0]) * 0.5      # some tag distances below 1
    args = tuple(jnp.asarray(a) for a in (x, ea, ei, types, node_valid, ev))
    variables = jm.init(jax.random.PRNGKey(0), *args)
    want = jm.apply(variables, *args)
    port = get_mpn_model(mpn)
    port.load_state_dict(mpn_from_jax_variables(variables.get("params", {}), {}, mpn))
    for route in (None, "pallas"):
        got = _forward(port, (x, ea, ei, ev, types, node_valid, tags), tags, route, False)
        assert got["node"] == [None] and got["class"] is None and got["tag"] == [None]
        np.testing.assert_allclose(got["edge"][0].detach().numpy(), np.asarray(want["edge"][0]),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["NodeClassificationMPNTag", "NodeClassificationMPNWithBackground",
                                  "NodeClassificationMPNGroupBased", "JointTypeClassification",
                                  "MPNTag", "TagThreshold", "PlainTag", "LogisticEdgeClassifier"])
def test_factory_builds_every_name(name):
    """Each name builds its class; the background name is the flagship's."""
    extra = {"AGGR_TYPE": "agnostic"} if name == "MPNTag" else {}
    cls = "NodeClassificationMPN" if name == "NodeClassificationMPNWithBackground" else name
    assert type(get_mpn_model(_cfg("tag", NAME=name, **extra))).__name__ == cls


@pytest.mark.parametrize("name", ["ClassificationNaive", "NodeClassificationMPNGroupBasedHierach"])
def test_broken_reference_names_are_refused_by_both(name):
    mpn = _cfg("tag", NAME=name)
    with pytest.raises(NotImplementedError, match="absent from the reference"):
        get_mpn_model(mpn)
    with pytest.raises(NotImplementedError, match="absent from the reference"):
        jax_get_mpn_model(mpn)


@pytest.mark.parametrize("route", ["fused_step", "hybrid", "einsum"])
def test_group_based_refuses_type_blocked_routes(route):
    """The group-based model's masked passes run on pallas and dots; the
    routes that need type-blocked nodes raise by name in both modes, and
    ``auto`` is pallas in both."""
    params, stats, _, graph, tags = _jax_run("group_based", False, False, 1)
    port = _port("group_based", params, stats)
    for train in ((False, True) if route != "fused_step" else (False,)):
        with pytest.raises(NotImplementedError, match="NodeClassificationMPNGroupBased"):
            _forward(port, graph, tags, route, train)
    for train in (False, True):
        port.train(train)
        assert port._route(None) == "pallas"


@pytest.mark.parametrize("model,extra,key", [
    ("tag", {"NAME": "NodeClassificationMPNTypeBased", "NODE_STEPS": 2}, "NODE_STEPS"),
    ("group_based", {"NODE_STEPS": 1}, "NODE_STEPS"),
    ("group_based", {"NAME": "NodeClassificationMPNTag", "LATE_FUSION_POS": True},
     "LATE_FUSION_POS"),
    ("group_based", {"AGGR_TYPE": "agnostic"}, "AGGR_TYPE"),
    ("mpn_tag", {"AGGR_TYPE": "per_type"}, "agnostic only"),
])
def test_variants_refused_at_build(model, extra, key):
    """NODE_STEPS is open on the tag model and the flagship only (the JAX
    models that read it); the late-fused position MLP on the flagship and
    the group-based model only, the two JAX models that read it (both
    held in test_torch_variants_layers.py and test_torch_mpn_tag.py's
    routes); MPNTag takes the agnostic layer only, as the JAX package's."""
    with pytest.raises(NotImplementedError, match=key):
        get_mpn_model(_cfg(model, **extra))


def _mlp_back(sd, prefix, dims, bn):
    return convert._convert_mlp(sd, prefix, len(dims), [bn] * (len(dims) - 1) + [False])


def _back(sd, mpn):
    """The port's MPN state dict back to JAX params and stats, through the
    JAX package's own converters (convert.py)."""
    name = mpn["NAME"]
    if name == "MPNTag":
        return convert.convert_mpn_tag_state_dict(sd, mpn)
    if name == "LogisticEdgeClassifier":
        return {"linear": {"kernel": convert._linear(sd["linear.weight"]),
                           "bias": np.asarray(sd["linear.bias"])}}, {}
    params, stats = {}, {}
    heads = {"NodeClassificationMPNTag": (("tag_pred", "NODE_TAG"),
                                          ("node_classification", "NODE_CLASS"),
                                          ("classification", "CLASS")),
             "JointTypeClassification": (("classification", "CLASS"),)}.get(
        name, (("edge_classification", "EDGE_CLASS"), ("node_classification", "NODE_CLASS"),
               ("classification", "CLASS")))
    for emb, key in (("node_embedding", "NODE_EMB"), ("edge_embedding", "EDGE_EMB")):
        params[emb], stats[emb] = _mlp_back(sd, emb, mpn[key]["OUTPUT_SIZES"], mpn[key]["BN"])
    for head, key in heads:
        params[head], stats[head] = _mlp_back(sd, head, mpn[key]["OUTPUT_SIZES"], mpn["BN"])
    layer = convert._convert_type_aware_layer(sd, "mpn_node_cls", J)
    if name == "NodeClassificationMPNGroupBased":
        params["layer"] = layer
    else:
        params["mpn"] = {"layer": layer}
    if mpn.get("NODE_STEPS"):
        params["mpn_node"] = {"layer": convert._convert_type_aware_layer(sd, "mpn_node", J)}
    return params, {k: v for k, v in stats.items() if v}


@pytest.mark.parametrize("model,name", [
    ("tag_skip_bn", None), ("tag_node_steps", None), ("joint_type", None),
    ("group_based_bn", None), ("background", None), ("mpn_tag", None),
    ("tag", "LogisticEdgeClassifier")])
def test_weight_round_trip_is_exact(model, name):
    """JAX variables -> the port's state dict -> the JAX package's
    converters give back the JAX variables bit for bit, for every new
    model's parameters (the tag head, the second step stack, the
    unscanned layers, the logistic head)."""
    extra = {"NAME": name} if name else {}
    mpn = _cfg(model, **extra)
    jm = jax_get_mpn_model(mpn)
    x, ea, ei, ev, types, node_valid, tags = _graph(False)
    args = tuple(jnp.asarray(a) for a in (x, ea, ei, types, node_valid, ev))
    params, stats = _seeded(jm, args, {"joint_tags": jnp.asarray(tags[:, 0])})
    sd = mpn_from_jax_variables(params, stats, mpn)
    port = get_mpn_model(mpn)
    port.load_state_dict(sd)         # strict: every key of the port's model, no other
    back_params, back_stats = _back({k: v.numpy() for k, v in sd.items()}, mpn)
    for want, got in ((params, back_params), (stats, back_stats)):
        fw, fg = flatten_dict(want), flatten_dict(got)
        assert set(fw) == set(fg)
        for key in fw:
            w, g = np.asarray(fw[key]), np.asarray(fg[key])
            assert w.shape == g.shape and w.dtype == g.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=str(key))
