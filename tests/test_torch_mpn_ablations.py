"""The ablation MPNs, port against JAX package on the same weights (carried
by weights.mpn_from_jax_variables): NodeClassificationMPN with the
type-agnostic MPLayer and with the flagship's per-type layer on an edge
list, and VanillaMPN, on the blocked kNN layout and on an edge list, in
eval mode and in training mode (masked BatchNorm statistics, per-step
heads). Outputs within 2e-4 of the largest. Also the factory's, the
routes' and the unported variants' refusals, and the research zoo on an
edge list."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pemp_tpu.config import get_config
from pemp_tpu.models.mpn.models import get_mpn_model as jax_get_mpn_model
from pemp_tpu.models.mpn.models import mpn_cfg_from_config
from pemp_tpu.ops import knn as jknn
from pemp_tpu_torch.models.mpn.models import get_mpn_model
from pemp_tpu_torch.weights import mpn_from_jax_variables

J, K, B = 17, 3, 2             # 17 types, 51 nodes an image
N_IMG = J * K
C = 8                          # kNN slots a node on the blocked layout (k 4, cap 4)

# the flagship head at narrow widths
NARROW = {
    "NAME": "NodeClassificationMPN", "STEPS": 3, "AGGR_TYPE": "per_type", "NODE_INPUT_DIM": 12,
    "EDGE_INPUT_DIM": 19, "NODE_FEATURE_DIM": 8, "EDGE_FEATURE_DIM": 8,
    "EDGE_FEATURE_HIDDEN": 8, "SKIP": True, "BN": False, "AGGR": "add",
    "AGGR_SUB": "node_edge_attn", "AUX_LOSS_STEPS": 1,
    "NODE_EMB": {"BN": True, "END_WITH_RELU": False, "OUTPUT_SIZES": [16, 8]},
    "EDGE_EMB": {"BN": True, "END_WITH_RELU": False, "OUTPUT_SIZES": [8, 8]},
    "EDGE_CLASS": {"BN": True, "OUTPUT_SIZES": [8, 1]},
    "NODE_CLASS": {"BN": True, "OUTPUT_SIZES": [8, 1]},
    "CLASS": {"BN": True, "OUTPUT_SIZES": [8, J]},
}

CASES = {
    "agnostic": {"AGGR_TYPE": "agnostic"},
    "agnostic_max": {"AGGR_TYPE": "agnostic", "AGGR": "max"},
    "agnostic_mean_no_skip": {"AGGR_TYPE": "agnostic", "AGGR": "mean", "SKIP": False,
                              "NODE_EMB": {"BN": True, "OUTPUT_SIZES": [16, 8]},
                              "EDGE_EMB": {"BN": True, "OUTPUT_SIZES": [8, 8]}},
    "per_type_flagship": {},
    "per_type_no_skip": {"SKIP": False},
    "vanilla": {"NAME": "VanillaMPN", "AGGR_TYPE": "agnostic"},
    "vanilla_bn": {"NAME": "VanillaMPN", "AGGR_TYPE": "agnostic", "BN": True},
}


def _graph(layout, seed=0):
    """B images of type-blocked nodes on a small grid: the target-major
    kNN layout (C slots a node) or the score-based edge list, flattened."""
    rng = np.random.RandomState(seed)
    eis, evs = [], []
    for b in range(B):
        pos = jnp.asarray(rng.randint(0, 12, (N_IMG, 2)), jnp.float32)
        valid = jnp.asarray(rng.rand(N_IMG) > 0.2)
        if layout == "blocked":
            ei, ev = jknn.knn_edges_target_major(pos, valid, 4, 4)
        else:
            ei, ev = jknn.score_based_edges(pos, valid, jnp.asarray(rng.rand(N_IMG)), 9)
        eis.append(np.asarray(ei) + b * N_IMG)
        evs.append(np.asarray(ev))
    ei = np.concatenate(eis, 1).astype(np.int32)
    ev = np.concatenate(evs)
    n = B * N_IMG
    x = rng.randn(n, NARROW["NODE_INPUT_DIM"]).astype(np.float32)
    ea = rng.randn(ei.shape[1], NARROW["EDGE_INPUT_DIM"]).astype(np.float32)
    types = ((np.arange(n) // K) % J).astype(np.int32)
    node_valid = np.asarray(rng.rand(n) > 0.1)
    return x, ea, ei, ev, types, node_valid


def _cfgs(case, layout):
    cfg = get_config()
    cfg.merge_from_other({"MODEL": {"MPN": {**NARROW, **CASES[case]}}})
    mpn = mpn_cfg_from_config(cfg.MODEL.MPN)
    mpn["_COLLECT_AUX"] = False       # the JAX eval entries' setting: final heads only
    if layout == "blocked":
        mpn.update(_BLOCKED_C=C, _NODES_PER_TYPE=K)
    agnostic = mpn["NAME"] == "VanillaMPN" or mpn["AGGR_TYPE"] == "agnostic"
    port = {**mpn, "_PLAIN_ROUTE": "agnostic" if agnostic else "segment"}
    return mpn, port


def _run(case, layout, train):
    mpn, port_cfg = _cfgs(case, layout)
    x, ea, ei, ev, types, node_valid = _graph(layout)
    jm = jax_get_mpn_model(mpn)
    args = tuple(jnp.asarray(a) for a in (x, ea, ei, types, node_valid, ev))
    variables = jm.init(jax.random.PRNGKey(0), *args)
    # non-trivial running statistics, so the eval-mode BatchNorm counts
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(rng.uniform(0.5, 1.5, v.shape) if v.ndim else v, np.float32),
        variables.get("batch_stats", {}))
    variables = {"params": variables["params"], "batch_stats": stats}
    if train:
        want, _ = jm.apply(variables, *args, train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(variables, *args, train=False)
    port = get_mpn_model(port_cfg)
    port.load_state_dict(mpn_from_jax_variables(variables["params"], stats, mpn))
    port.train(train)
    t = torch.from_numpy
    got = port(t(x), t(ea), t(ei), t(ev), t(ei[0] % N_IMG), torch.float32,
               node_valid=t(node_valid), node_types=t(types))
    return got, want, ev


# the per-type layer runs here on an edge list only: on the blocked layout
# it takes the kernel routes (test_torch_mpn.py and the route tests)
RUNS = [(case, layout, train) for case in CASES for layout in ("blocked", "edge_list")
        for train in (False, True) if layout == "edge_list" or not case.startswith("per_type")]


@pytest.mark.parametrize("case,layout,train", RUNS,
                         ids=[f"{c}-{lay}-{'train' if t else 'eval'}" for c, lay, t in RUNS])
def test_ablation_mpn_matches_jax(case, layout, train):
    got, want, ev = _run(case, layout, train)
    for key in ("edge", "node", "class"):
        w = want[key]
        if w is None or w == [None]:
            assert got[key] == w, key      # VanillaMPN: node [None], class None
            continue
        assert len(got[key]) == len(w), key
        for g, ww in zip(got[key], w):
            ww = np.asarray(ww)
            g = g.detach().numpy()
            if key == "edge":
                g, ww = g[ev], ww[ev]
            scale = float(np.abs(ww).max())
            np.testing.assert_allclose(g, ww, atol=2e-4 * scale, rtol=0, err_msg=key)


def test_delta_file_alone_raises_at_build():
    """A delta file loaded alone leaves the tree's VanillaMPN without
    embedding sizes: the port raises the same KeyError at build that the
    JAX package raises at its first call."""
    from pemp_tpu.config import update_config as jax_update_config
    from pemp_tpu_torch.config import update_config
    from pemp_tpu_torch.config.defaults import CONFIGS, get_config as port_get_config
    from pemp_tpu_torch.models.pose_estimation import build_pose_model

    for name in ("feature_importance/model_nothing", "connectivity/fully", "train/model_50_4",
                 "class_agnostic_end2end/model_57_1"):
        path = str(CONFIGS / f"{name}.yaml")
        cfg = update_config(port_get_config(), path)
        assert cfg.MODEL.MPN.NAME == "VanillaMPN"
        with pytest.raises(KeyError, match="OUTPUT_SIZES"):
            build_pose_model(cfg, device="cpu", path="valid")
        jcfg = jax_update_config(get_config(), path)
        jm = jax_get_mpn_model(jcfg.MODEL.MPN)
        with pytest.raises(KeyError, match="OUTPUT_SIZES"):
            jm.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in _graph("edge_list")[:4]))


@pytest.mark.parametrize("name", ["NodeClassificationMPNTypeBased",
                                  "NodeClassificationMPNAttention", "ClassificationMPN",
                                  "VanillaMPN2", "ClassificationNaive",
                                  "NodeClassificationMPNGroupBasedHierach"])
def test_factory_refuses_the_rest_of_the_zoo(name):
    """The research zoo builds and runs on an edge list (each model is held
    against the JAX zoo in test_torch_mpn_zoo.py); the factory refuses only
    the two names whose reference classes are absent."""
    _, port_cfg = _cfgs("per_type_flagship", "edge_list")
    if name in ("ClassificationNaive", "NodeClassificationMPNGroupBasedHierach"):
        with pytest.raises(NotImplementedError, match="absent from the reference"):
            get_mpn_model({**port_cfg, "NAME": name})
        return
    port = get_mpn_model({**port_cfg, "NAME": name, "STEPS_GROUP": 1})
    x, ea, ei, ev, types, node_valid = _graph("edge_list")
    t = torch.from_numpy
    out = port(t(x), t(ea), t(ei), t(ev), t(ei[0] % N_IMG), torch.float32,
               node_valid=t(node_valid), node_types=t(types))
    assert out["edge"][-1].shape == (ei.shape[1],)
    assert bool(torch.isfinite(out["edge"][-1][t(ev)]).all())


@pytest.mark.parametrize("variant", [{"EDGE_MLP": "per_type"}, {"AGGR_SUB": "None"},
                                     {"AGGR_SUB": "node_edge_attn_per_type"},
                                     {"UPDATE_TYPE": "hierarch_mlp"},
                                     {"AGGR_TYPE": "agnostic", "USE_NODE_UPDATE_MLP": True},
                                     {"NAME": "VanillaMPN", "AGGR_TYPE": "agnostic",
                                      "DROP_FEATURE": "edge_dist"}],
                         ids=lambda v: "-".join(f"{k}={v[k]}" for k in v))
def test_variants_no_config_sets_are_refused(variant):
    """The JAX package's MPN variants that no file of configs/ sets build
    on an edge list and on the blocked layout, on the flagship and
    VanillaMPN and on a zoo model whose layer reads the key (held against
    the JAX package in test_torch_variants_layers.py); VanillaMPN's
    DROP_FEATURE, a key of that model alone, stays refused by key on the
    others, which do not read it."""
    for layout in ("edge_list", "blocked"):
        _, port_cfg = _cfgs("per_type_flagship", layout)
        assert get_mpn_model({**port_cfg, **variant}) is not None
        key = next(k for k in variant if k not in ("NAME", "AGGR_TYPE"))
        other = ("NodeClassificationMPNTypeBased" if variant.get("AGGR_TYPE") != "agnostic"
                 else "NodeClassificationMPNAttention" if "NAME" not in variant else "MPNTag")
        if key == "DROP_FEATURE":
            with pytest.raises(NotImplementedError, match=key):
                get_mpn_model({**port_cfg, **variant, "NAME": other})
        else:
            assert get_mpn_model({**port_cfg, **variant, "NAME": other}) is not None


@pytest.mark.parametrize("route", ["fused_step", "pallas", "hybrid", "einsum", "dots"])
@pytest.mark.parametrize("case", ["per_type_flagship", "agnostic", "vanilla"])
def test_explicit_kernel_route_is_refused_on_plain_routes(case, route):
    """A kernel route named on an edge list or for an MPLayer raises, in
    either mode, with the reason; nothing falls back."""
    _, port_cfg = _cfgs(case, "edge_list")
    x, ea, ei, ev, types, node_valid = _graph("edge_list")
    port = get_mpn_model({**port_cfg, "_MSG_PASS": route})
    t = torch.from_numpy
    for train in (False, True):
        port.train(train)
        with pytest.raises(NotImplementedError, match="TPU.MSG_PASS"):
            port(t(x), t(ea), t(ei), t(ev), t(ei[0] % N_IMG), torch.float32,
                 node_types=t(types))
