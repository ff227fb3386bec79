"""The eval MPN in bf16, port against the JAX package, on each message route.

Both models are the small configuration in bf16 with the same seeded
weights (carried by ``from_jax_variables``). The JAX backbone runs once;
its bf16 outputs (scoremaps, features, tags, handed on in f32 as both
backbones hand them on) feed both graph constructors and MPNs: the JAX one
with ``TPU.MSG_PASS`` pinned to the route and its Pallas kernels in
interpret mode (as tests/test_torch_slice.py runs them), the port's on the
CPU through the plain versions of K1 (``fused_step``), K2 (``pallas``), K3
(``hybrid``) and K4 (``einsum``, ``dots``). An end-to-end bf16 comparison is not made: the two bf16
backbones round differently, and detections then diverge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import B, _seeded_variables

from pemp_tpu.config import get_config
from pemp_tpu.graph.constructor import construct_graph_batch as jax_construct_graph_batch
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.models.mpn.layers import fused_tile_ok
from pemp_tpu_torch.config import small
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.ops import attn_aggregate, blocked_attn, fused_step, typed_message
from pemp_tpu_torch.weights import from_jax_variables

ROUTES = ("fused_step", "hybrid", "einsum", "pallas", "dots")
GRAPH_KEYS = ("nodes", "edge_index", "edge_valid", "node_valid")


def _jax_model(port_cfg, route):
    cfg = get_config()
    cfg.defrost()
    cfg.merge_from_other(port_cfg.to_dict())
    cfg.TPU.MSG_PASS = route
    cfg.TPU.COLLECT_AUX = False
    cfg.freeze()
    jmodel = jax_build_pose_model(cfg, dtype=jnp.bfloat16)
    if route not in ("einsum", "dots"):
        # build_pose_model turns Pallas off away from a TPU; the interpret
        # mode runs the route's kernel on the CPU (einsum and dots run the
        # jnp aggregate)
        jmodel.mpn_cfg["_USE_PALLAS"] = True
        jmodel.mpn_cfg["_PALLAS_INTERPRET"] = True
    return jmodel


def _graph_and_mpn(module, scoremaps, features, tags):
    """The JAX model's eval forward after its backbone."""
    gb = jax_construct_graph_batch(module.gc, scoremaps, features, tags, testing=True)
    preds = module.mpn_forward(gb)
    graph = {"nodes": gb.joint_det, "edge_index": gb.edge_index,
             "edge_valid": gb.edge_valid, "node_valid": gb.node_valid}
    return {k: preds[k] for k in ("edge", "node", "class")}, graph


@pytest.fixture(scope="module")
def backbone_run():
    port_cfg = small()
    jmodel = _jax_model(port_cfg, "fused_step")
    rng = np.random.RandomState(0)
    imgs = rng.rand(B, 64, 64, 3).astype(np.float32)
    variables = _seeded_variables(jmodel, jnp.asarray(imgs), rng)
    outputs = jax.jit(lambda v, x: jmodel.apply(v, x, method="backbone_forward"))(
        variables, jnp.asarray(imgs))
    return dict(port_cfg=port_cfg, imgs=imgs, variables=variables, outputs=outputs)


@pytest.mark.parametrize("route", ROUTES)
def test_bf16_mpn_matches_jax(backbone_run, route):
    port_cfg, variables = backbone_run["port_cfg"].clone(), backbone_run["variables"]
    stages, scoremaps, features, tags = backbone_run["outputs"]
    assert scoremaps.dtype == jnp.float32      # both backbones hand their maps on in f32

    jmodel = _jax_model(port_cfg, route)
    want, graph = jax.jit(lambda v, s, f, t: jmodel.apply(v, s, f, t, method=_graph_and_mpn))(
        variables, scoremaps, features, tags)

    port_cfg.TPU.MSG_PASS = route
    model = build_pose_model(port_cfg, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(from_jax_variables(
        variables["params"], variables["batch_stats"], port_cfg))
    to_t = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    model.backbone_forward = lambda imgs: (
        [to_t(s).to(torch.bfloat16) for s in stages], to_t(scoremaps), to_t(features),
        to_t(tags))
    if route in ("hybrid", "pallas"):
        # the JAX layer takes its K3 or K2 branch only under this gate
        assert fused_tile_ok(int(np.asarray(graph["node_valid"]).size), model.gc.slots, 17)
    counts = lambda: (fused_step.LAUNCHES, typed_message.LAUNCHES_FWD,  # noqa: E731
                      attn_aggregate.LAUNCHES_FWD, blocked_attn.LAUNCHES)
    before = counts()
    with torch.no_grad():
        _, out = model(torch.from_numpy(backbone_run["imgs"]))
    assert counts() == before

    for key in GRAPH_KEYS:
        np.testing.assert_array_equal(out["graph"][key].numpy(), np.asarray(graph[key]),
                                      err_msg=key)
    ev = np.asarray(graph["edge_valid"])
    assert ev.sum() > 1000
    # bf16 rounds at other places in the two MPNs (and the port's own f32
    # MPN lies as far from JAX's bf16 one): measured 0.031 to 0.035 of a
    # largest edge logit of 1.14 to 1.16 on these inputs, at most 3.1 % of
    # the largest logit on any route and head. 5e-2 of the largest logit
    # holds that with room; a wrong route, weight or graph field is off by
    # far more.
    for key in ("edge", "node", "class"):
        assert len(out["preds"][key]) == len(want[key]), key
        for i, (g, w) in enumerate(zip(out["preds"][key], want[key])):
            g, w = g.float().numpy(), np.asarray(w, np.float32)
            if key == "edge":
                g, w = g[ev], w[ev]
            assert np.isfinite(g).all(), f"{key}[{i}]"
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-2 * np.abs(w).max(),
                                       err_msg=f"{route} {key}[{i}]")
