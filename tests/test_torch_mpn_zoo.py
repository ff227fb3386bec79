"""The research zoo's MPNs (pemp_tpu_torch.models.mpn.zoo), port against the
JAX zoo (pemp_tpu.models.mpn.zoo) on the same weights (carried by
weights.mpn_from_jax_variables), at narrow widths on two images of 17
types x 3 nodes in the target-major kNN layout, inputs drawn with numpy.

Each model runs in eval mode and in training mode (masked BatchNorm
statistics, the node labels given) on every route it takes: the six on the
flagship's layer with ``AGGR_TYPE: per_type`` on ``pallas`` (K2's plain
version here) and ``dots`` in both modes and on ``fused_step`` (K1's) at
eval, and with ``agnostic`` on the ``agnostic`` route (MPLayer); the other
four on ``agnostic``. Outputs within 2e-4 of each one's largest (2e-3 on
``fused_step``); in training mode also the gradients of a fixed linear
function of every output, each parameter's within 5e-3 of its largest (a
gradient the JAX step gives as zero to rounding, 1e-6 of the step's
largest, is held to that: the port drops the attention bias, whose
gradient is zero, as every route does). TypeConstrained's source classes
and ClassificationMPN's true-positive masks are asserted equal before the
outputs are compared; at these draws no node score is within 1e-4 of 0.5
and no class argmax within 1e-4 of a tie, which the test asserts too.

Also the factory's names and refusals, and a ``state_dict`` in the
reference's names (the keys pemp_tpu/train/convert.py reads) for
ClassificationMPNSimple and VanillaMPN2 read through
train.checkpoint.load_params_only."""

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
from pemp_tpu.train import convert
from pemp_tpu_torch.models.mpn.models import get_mpn_model
from pemp_tpu_torch.train.checkpoint import load_params_only
from pemp_tpu_torch.weights import mpn_from_jax_variables

J, K, B = 17, 3, 2
N_IMG = J * K
C = 8                      # kNN slots a node (k 4, cap 4)
FM = (4, 5)                # SelfAttention's feature map, pixels an image

NARROW = {
    "STEPS": 3, "AGGR_TYPE": "per_type", "NODE_INPUT_DIM": 12, "EDGE_INPUT_DIM": 19,
    "NODE_FEATURE_DIM": 8, "EDGE_FEATURE_DIM": 8, "EDGE_FEATURE_HIDDEN": 8, "SKIP": True,
    "BN": False, "AGGR": "add", "AGGR_SUB": "node_edge_attn", "AUX_LOSS_STEPS": 0,
    "NODE_STEPS": 0,
    "NODE_EMB": {"BN": True, "END_WITH_RELU": False, "OUTPUT_SIZES": [16, 8]},
    "EDGE_EMB": {"BN": True, "END_WITH_RELU": False, "OUTPUT_SIZES": [8, 8]},
    "EDGE_CLASS": {"BN": True, "OUTPUT_SIZES": [8, 4, 1]},
    "NODE_CLASS": {"BN": True, "OUTPUT_SIZES": [8, 1]},
    "CLASS": {"BN": True, "OUTPUT_SIZES": [8, J]},
}

# the six on the flagship's layer, then the four on their own
PER_TYPE = {
    "simple": {"NAME": "ClassificationMPNSimple", "EDGE_STEPS": 2},
    "simple2": {"NAME": "ClassificationMPNSimple2", "EDGE_STEPS": 1,
                "NODE_TYPE_SUMMARY": "left_right", "BN": True},
    "type_based": {"NAME": "NodeClassificationMPNTypeBased"},
    "type_constrained": {"NAME": "NodeClassificationMPNTypeConstrained", "BN": True},
    "fp_constrained": {"NAME": "NodeClassificationMPNFPConstrained"},
    "with_ref": {"NAME": "NodeClassificationMPNWithRef", "NODE_STEPS": 1},
}
OWN = {
    "two_phase": {"NAME": "ClassificationMPN", "STEPS_NODE": 2, "STEPS_GROUP": 2,
                  "AGGR_TYPE": "agnostic"},
    "attention": {"NAME": "NodeClassificationMPNAttention", "NODE_STEPS": 1, "AGGR": "max"},
    "self_attention": {"NAME": "NodeClassificationMPNSelfAttention", "BN": True},
    "vanilla2": {"NAME": "VanillaMPN2", "BN": True, "AUX_LOSS_STEPS": 1, "AGGR": "mean",
                 "CLASS": {"BN": True, "OUTPUT_SIZES": [8, 1]}},
}
MODELS = {**PER_TYPE, **{f"{m}_agnostic": {**v, "AGGR_TYPE": "agnostic"}
                         for m, v in PER_TYPE.items()}, **OWN}

RUNS = []
for _m in MODELS:
    for _mode in ("eval", "train"):
        if _m in PER_TYPE:
            _routes = ("fused_step", "pallas", "dots") if _mode == "eval" else ("pallas", "dots")
        else:
            _routes = ("agnostic",)
        RUNS += [(_m, _r, _mode) for _r in _routes]


def _graph(seed=0):
    """B images of type-blocked nodes on a small grid, the target-major kNN
    layout flattened; node and edge inputs, raw types, node validity and
    labels, the feature map."""
    rng = np.random.RandomState(seed)
    eis, evs = [], []
    for b in range(B):
        pos = jnp.asarray(rng.randint(0, 12, (N_IMG, 2)), jnp.float32)
        valid = jnp.asarray(rng.rand(N_IMG) > 0.2)
        ei, ev = jknn.knn_edges_target_major(pos, valid, 4, 4)
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
        "node_labels": (rng.rand(n) > 0.5).astype(np.float32),
        "feature_maps": rng.randn(B, *FM, NARROW["NODE_INPUT_DIM"]).astype(np.float32),
        "batch_index": np.repeat(np.arange(B, dtype=np.int32), N_IMG),
    }


def _cfg(model):
    cfg = get_config()
    cfg.merge_from_other({"MODEL": {"MPN": {**NARROW, **MODELS[model]}}})
    mpn = mpn_cfg_from_config(cfg.MODEL.MPN)
    mpn.update(_BLOCKED_C=C, _NODES_PER_TYPE=K)
    return mpn


def _weights(seed):
    """Fixed weights of the linear objective: per node, per valid edge,
    per node and class."""
    rng = np.random.RandomState(seed)
    e = B * N_IMG * C
    return (rng.randn(e).astype(np.float32), rng.randn(B * N_IMG).astype(np.float32),
            rng.randn(B * N_IMG, J).astype(np.float32))


def _objective(out, ev, w, xp):
    """sum over heads and steps of the outputs times fixed weights (edges
    on the valid slots only)."""
    we, wn, wc = w
    total = 0.0
    for p in out["edge"]:
        if p is not None:
            total = total + (xp.where(ev, p, 0.0) * we).sum()
    for p in out["node"]:
        if p is not None:
            total = total + (p * wn).sum()
    for p in out["class"] or []:
        total = total + (p * wc[:, :p.shape[1]]).sum()
    return total


def _jax_args(g):
    args = tuple(jnp.asarray(g[k]) for k in ("x", "edge_attr", "edge_index", "node_types",
                                              "node_valid", "edge_valid"))
    kwargs = {k: jnp.asarray(g[k]) for k in ("node_labels", "feature_maps", "batch_index")}
    return args, kwargs


@functools.lru_cache(maxsize=None)
def _jax_run(model, train):
    """(params, stats, JAX outputs, JAX gradients of the objective or None)."""
    mpn = _cfg(model)
    g = _graph()
    jm = jax_get_mpn_model(mpn)
    args, kwargs = _jax_args(g)
    variables = jm.init(jax.random.PRNGKey(0), *args, **kwargs, train=False)
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(rng.uniform(0.5, 1.5, v.shape), np.float32),
        variables.get("batch_stats", {}))
    # flax initialises biases at 0: draw them, so that each is carried and
    # no logit sits at exactly 0 (a node with no valid in-edge)
    params = unflatten_dict({
        k: v + np.asarray(rng.randn(*v.shape) * 0.1, np.float32) if k[-1] == "bias" else v
        for k, v in flatten_dict(variables["params"]).items()})
    if not train:
        return params, stats, jm.apply({"params": params, "batch_stats": stats}, *args,
                                       **kwargs, train=False), None
    w = tuple(jnp.asarray(a) for a in _weights(2))
    ev = jnp.asarray(g["edge_valid"])

    def loss(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, *args, **kwargs, train=True,
                          mutable=["batch_stats"])
        return _objective(out, ev, w, jnp), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return params, stats, out, grads


def _port(model, params, stats):
    mpn = _cfg(model)
    port = get_mpn_model(mpn)
    port.load_state_dict(mpn_from_jax_variables(params, stats, mpn))
    return port


def _forward(port, g, route, train):
    t = torch.from_numpy
    port.train(train)
    return port(t(g["x"]), t(g["edge_attr"]), t(g["edge_index"]), t(g["edge_valid"]),
                t(g["edge_index"][0] % N_IMG), torch.float32, node_valid=t(g["node_valid"]),
                route=route, node_types=t(g["node_types"]), node_labels=t(g["node_labels"]),
                feature_maps=t(g["feature_maps"]), batch_index=t(g["batch_index"]))


def _assert_decisions_equal(model, got, want, g, train):
    """The piecewise-constant choices inside the models, before any output
    is compared: TypeConstrained's source classes (the class argmax) and
    ClassificationMPN's true-positive masks; and the draw keeps clear of
    their edges."""
    if MODELS[model]["NAME"] == "NodeClassificationMPNTypeConstrained":
        cls = np.asarray(want["class"][-1])
        src = g["edge_index"][0][g["edge_valid"]]     # the classes a valid edge reads
        top2 = np.sort(cls[src], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-4
        np.testing.assert_array_equal(got["class"][-1].detach().numpy().argmax(-1)[src],
                                      cls.argmax(-1)[src])
    if MODELS[model]["NAME"] == "ClassificationMPN":
        p = 1.0 / (1.0 + np.exp(-np.asarray(want["node"][-1], np.float64)))
        assert np.abs(p - 0.5).min() > 1e-4
        tp_want = p > 0.5
        tp_got = torch.sigmoid(got["node"][-1].detach()).numpy() > 0.5
        if train:
            tp_want, tp_got = (m | (g["node_labels"] == 1.0) for m in (tp_want, tp_got))
        np.testing.assert_array_equal(tp_got, tp_want)


def _assert_close(got, want, ev, tol):
    for key in ("edge", "node", "class", "tag"):
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
    """The port's parameter gradients against the JAX ones, carried into
    the port's names by the same walk as the weights."""
    want = mpn_from_jax_variables(grads, stats, mpn)
    params = dict(port.named_parameters())
    top = max(float(want[k].abs().max()) for k in params)
    for name, p in params.items():
        w = want[name].float()
        got = torch.zeros_like(p) if p.grad is None else p.grad
        scale = float(w.abs().max())
        err = float((got - w).abs().max())
        if scale <= 1e-6 * top:           # zero to rounding in the JAX step
            assert float(got.abs().max()) <= 1e-6 * top, name
        else:
            assert err <= 5e-3 * scale, (name, err, scale)


@pytest.mark.parametrize("model,route,mode", RUNS, ids=[f"{m}-{r}-{mo}" for m, r, mo in RUNS])
def test_zoo_mpn_matches_jax(model, route, mode):
    train = mode == "train"
    params, stats, want, grads = _jax_run(model, train)
    g = _graph()
    port = _port(model, params, stats)
    got = _forward(port, g, route, train)
    _assert_decisions_equal(model, got, want, g, train)
    _assert_close(got, want, g["edge_valid"], 2e-3 if route == "fused_step" else 2e-4)
    if train:
        w = tuple(torch.from_numpy(a) for a in _weights(2))
        _objective(got, torch.from_numpy(g["edge_valid"]), w, torch).backward()
        _assert_grads_close(port, grads, stats, _cfg(model))


def test_routes_of_the_zoo():
    """``auto`` resolves as on the flagship for the six on its layer (the
    fused step at eval, pallas in training) and to ``agnostic`` for the
    rest; a kernel route named for an MPLayer model raises."""
    for model in MODELS:
        port = get_mpn_model(_cfg(model))
        for train, want in ((False, "fused_step"), (True, "pallas")):
            port.train(train)
            kernel = model in PER_TYPE
            assert port._route(None) == (want if kernel else "agnostic"), model
            if not kernel:
                with pytest.raises(NotImplementedError, match="TPU.MSG_PASS"):
                    port._route("pallas")


@pytest.mark.parametrize("name,extra,match", [
    ("ClassificationMPNSimple", {"NODE_TYPE_SUMMARY": "left_right"}, "NODE_TYPE_SUMMARY"),
    ("NodeClassificationMPNWithRef", {"NODE_STEPS": 2}, "NODE_STEPS=2"),
    ("ClassificationMPN", {"NODE_STEPS": 1}, "NODE_STEPS"),
    ("VanillaMPN2", {"USE_NODE_UPDATE_MLP": True}, "USE_NODE_UPDATE_MLP"),
    ("NodeClassificationMPNTypeConstrained", {"EDGE_MLP": "per_type"}, "EDGE_MLP"),
    ("NodeClassificationMPNSelfAttention", {"USE_NODE_UPDATE_MLP": True},
     "USE_NODE_UPDATE_MLP"),
])
def test_zoo_variants_refused(name, extra, match):
    """What neither package runs (Simple's summary, WithRef's second node
    pass), and the variants no file sets, raise by name at build."""
    with pytest.raises(NotImplementedError, match=match):
        get_mpn_model({**_cfg("simple"), "NAME": name, **extra})


def test_factory_builds_every_jax_name():
    """Every name of the JAX factory builds in the port, but the two whose
    reference classes are absent, which both refuse."""
    from pemp_tpu.models.mpn.models import _MODELS

    broken = ("ClassificationNaive", "NodeClassificationMPNGroupBasedHierach")
    for name in _MODELS:
        agnostic = name in ("MPNTag",)
        cfg = {**_cfg("simple"), "NAME": name, **({"AGGR_TYPE": "agnostic"} if agnostic else {})}
        assert get_mpn_model(cfg) is not None, name
    for name in broken:
        with pytest.raises(NotImplementedError, match="absent from the reference"):
            get_mpn_model({**_cfg("simple"), "NAME": name})


_BACK = {"ClassificationMPNSimple": convert.convert_classification_simple_state_dict,
         "VanillaMPN2": convert.convert_vanilla_mpn2_state_dict}


@pytest.mark.parametrize("model", ["simple", "simple_agnostic", "vanilla2"])
def test_reference_state_dict_loads_unchanged(model, tmp_path):
    """A ``state_dict`` in the reference's names, as the JAX package's
    converter reads them (convert_classification_simple_state_dict,
    convert_vanilla_mpn2_state_dict), loads through load_params_only as it
    is: the converter gives back the JAX variables bit for bit from the
    same keys, and the port, loaded from the file, gives the JAX outputs."""
    mpn = _cfg(model)
    params, stats, want, _ = _jax_run(model, False)
    sd = {k: v.numpy() for k, v in mpn_from_jax_variables(params, stats, mpn).items()}
    back_params, back_stats = _BACK[mpn["NAME"]](sd, mpn)
    for a, b in ((params, back_params), (stats, back_stats)):
        fa, fb = flatten_dict(a), flatten_dict({k: v for k, v in b.items() if v})
        assert set(fa) == set(fb)
        for key in fa:
            np.testing.assert_array_equal(np.asarray(fb[key]), np.asarray(fa[key]),
                                          err_msg=str(key))
    path = tmp_path / "reference.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    port = get_mpn_model(mpn)
    load_params_only(path, port)
    g = _graph()
    route = "agnostic" if model != "simple" else "pallas"
    _assert_close(_forward(port, g, route, False), want, g["edge_valid"], 2e-4)
