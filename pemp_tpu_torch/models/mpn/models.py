"""The MPN models (counterpart of pemp_tpu.models.mpn.models):
``NodeClassificationMPN``, the flagship, and ``VanillaMPN``, the edge-only
model; :func:`get_mpn_model` builds either by ``MODEL.MPN.NAME`` and refuses
the rest of the zoo by name.

Forward contract as in the reference
(src/Models/MessagePassingNetwork/NodeClassificationMPNSimple.py:62-97):

    (x, edge_attr, edge_index, ...) ->
        dict(edge=[(E,) logits], node=[(N,)], class=[(N, C)])

(VanillaMPN: node ``[None]`` and class ``None``, pemp_tpu/models/mpn/
models.py:326-370).

The route of each step is ``TPU.MSG_PASS`` (``_MSG_PASS`` in the MPN
config), resolved as the JAX package's build_pose_model resolves it on a
TPU (pemp_tpu/models/pose_estimation.py:234-256) for the module's mode:
``auto`` is the fused step (K1) in eval mode and the typed message kernel
(``pallas``: K2, differentiable through K2b) in training mode; ``pallas``
(K2's bf16 form at eval), ``hybrid`` (K3, through K3b), ``einsum`` and
``dots`` (K4, through K4b) run in both, ``fused_step`` in eval mode only.
The two reverse-permutation routes (``hybrid``, ``einsum``) read the
reverse-edge involution of the symmetric layout, built once per forward;
``dots`` runs on the asymmetric layout, as ``pallas``. Where a gradient can
flow, the plans of G1 (ops.gather_mm.gather_plan) are built once per
forward too: the source gather's, and on ``einsum`` and ``dots`` the
projection's selections'. These kernel routes need the target-major
blocked kNN layout (``_BLOCKED_C``, ``_NODES_PER_TYPE`` nodes of each
type an image) and the flagship layer; under ``MODEL.GC.USE_GT``
(``_GT_NODES``) the nodes are the GT joints, person-major, so the source
types are gathered, ``auto`` is ``pallas`` in both modes and the routes
that need type-blocked nodes (``fused_step``, ``hybrid``, ``einsum``)
raise. The kernel-free routes
(``_PLAIN_ROUTE``, config.defaults.PLAIN_ROUTES) run everything else:
``segment`` (the per-type layer on an edge list) and ``agnostic``
(MPLayer on either layout); an explicit kernel route there raises. The module's mode decides the rest: training collects per-step
outputs, with the heads on the last ``AUX_LOSS_STEPS + 1`` steps and on
the final features (pemp_tpu/models/mpn/models.py:288-316), and takes the
embeddings' BatchNorm statistics over valid rows; eval runs the heads on
the final features only.

The JAX package scans the shared-weight step with ``nn.scan``; here it is a
Python loop over the same module. The index columns, the init-edge
projection ``q`` and the step's weight views are loop-invariant and are
computed once per forward.
"""

from __future__ import annotations

import torch
from torch import nn

from pemp_tpu_torch.config.defaults import PLAIN_ROUTES, msg_pass_route
from pemp_tpu_torch.models.mpn.layers import (
    MLP,
    MPLayer,
    TypeAwareMPNLayer,
    num_summary_types,
    split_linear_plans,
    sum_node_types,
    type_order,
)
from pemp_tpu_torch.ops.gather_mm import gather_plan
from pemp_tpu_torch.ops.knn import reverse_edge_perm

# the MPN keys' values the port implements, absent keys taking them: the
# JAX package's other variants (the per-type edge MLP, the node update MLP,
# VanillaMPN's dropped edge distances, the late-fused position MLP, node-only
# steps) wait for a configuration that sets them
_PORTED = {"EDGE_MLP": "agnostic", "USE_NODE_UPDATE_MLP": False, "DROP_FEATURE": "",
           "LATE_FUSION_POS": False, "NODE_STEPS": 0}
# and of the per-type layer on every route (attention aggregation, mlp update)
_PER_TYPE_LAYER = {"AGGR_SUB": "node_edge_attn", "UPDATE_TYPE": "mlp"}


def mpn_cfg_from_config(mpn_config) -> dict:
    """The open MPN config subtree as a plain dict."""
    d = mpn_config.to_dict() if hasattr(mpn_config, "to_dict") else dict(mpn_config)
    d.setdefault("NODE_STEPS", 0)
    return d


def _check_flagship(c: dict) -> None:
    """Raises ``NotImplementedError`` unless the port has the MPN ``c``
    asks for: a model of :data:`MODELS`, the values of :data:`_PORTED`, a
    known aggregation type, the flagship's per-type layer, and on the
    kernel routes (``_PLAIN_ROUTE`` unset) skip connections and the
    blocked, type-blocked layout."""
    name = c.get("NAME")
    if name not in MODELS:
        raise NotImplementedError(
            f"MODEL.MPN.NAME={name!r}: the port has {sorted(MODELS)}; the rest of the MPN "
            f"zoo is not ported")
    if c.get("AGGR_TYPE") not in ("per_type", "agnostic"):
        raise NotImplementedError(f"MPN AGGR_TYPE={c.get('AGGR_TYPE')!r}")
    agnostic = name == "VanillaMPN" or c["AGGR_TYPE"] == "agnostic"
    for key, value in {**_PORTED, **({} if agnostic else _PER_TYPE_LAYER)}.items():
        if c.get(key, value) != value:
            raise NotImplementedError(f"MPN {key}={c.get(key)!r}: not ported "
                                      f"({key}={value!r} is)")
    if agnostic or c.get("_PLAIN_ROUTE"):
        return
    if not c.get("SKIP"):
        raise NotImplementedError("MPN SKIP=False: the kernel routes run the flagship's skip "
                                  "connections")
    if not c.get("_BLOCKED_C") or not c.get("_NODES_PER_TYPE"):
        raise NotImplementedError("the flagship MPN needs the blocked, type-blocked layout")


def _widths(c: dict):
    """(node_in, edge_in) of the shared layer: with ``SKIP`` the step's
    inputs are the embeddings concatenated with the carry."""
    nd, ed = c["NODE_FEATURE_DIM"], c["EDGE_FEATURE_DIM"]
    if c["SKIP"]:
        return (c["NODE_EMB"]["OUTPUT_SIZES"][-1] + nd,
                c["EDGE_EMB"]["OUTPUT_SIZES"][-1] + ed)
    return nd, ed


def plain_pre(c: dict, edge_index, edge_valid, types, num_types: int, per_type: bool) -> dict:
    """The loop-invariant index columns of the kernel-free routes
    (pemp_tpu/models/mpn/models.py:124-148): each edge's source and target
    (the target a repeat on the blocked layout), validity, and with
    ``per_type`` the source types from ``types`` (N,) and their order for
    the message projection."""
    blocked_c = c.get("_BLOCKED_C", 0)
    src = edge_index[0].long()
    if blocked_c:
        n = edge_index.shape[1] // blocked_c
        dst = torch.arange(n, device=src.device).repeat_interleave(blocked_c)
    else:
        dst = edge_index[1].long()
    pre = {"src": src, "dst": dst, "blocked_c": blocked_c, "valid": edge_valid}
    if per_type:
        pre["src_type"] = types.long()[src]
        pre["type_order"] = type_order(pre["src_type"], num_types)
    return pre


class NodeClassificationMPN(nn.Module):
    """Flagship: shared-weight MP steps + edge/node/class heads.

    reference: NodeClassificationMPNSimple.py:23-97. ``mpn_cfg`` is the
    plain-dict MPN config plus ``_BLOCKED_C`` (slots per node) and
    ``_NODES_PER_TYPE`` (K) on the target-major kNN layout, as the JAX
    package's build_pose_model sets them, ``_MSG_PASS`` (``TPU.MSG_PASS``,
    ``auto`` when absent) and ``_PLAIN_ROUTE`` (config.defaults.plain_route;
    None for the kernel routes). ``AGGR_TYPE: agnostic`` makes the shared
    layer an MPLayer (pemp_tpu/models/mpn/models.py:94-107).
    """

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        c = dict(mpn_cfg)
        _check_flagship(c)
        if c["AGGR_TYPE"] == "agnostic":
            c["_PLAIN_ROUTE"] = "agnostic"    # MPLayer runs no kernel on any layout
        self.cfg = c
        self.num_types = num_summary_types(c["NODE_TYPE_SUMMARY"], c["NUM_JOINTS"])
        node_emb = c["NODE_EMB"]["OUTPUT_SIZES"]
        edge_emb = c["EDGE_EMB"]["OUTPUT_SIZES"]
        self.node_embedding = MLP(c["NODE_INPUT_DIM"], node_emb, c["NODE_EMB"]["BN"],
                                  c["NODE_EMB"].get("END_WITH_RELU", False))
        self.edge_embedding = MLP(c["EDGE_INPUT_DIM"], edge_emb, c["EDGE_EMB"]["BN"],
                                  c["EDGE_EMB"].get("END_WITH_RELU", False))
        nd, ed, hidden = c["NODE_FEATURE_DIM"], c["EDGE_FEATURE_DIM"], c["EDGE_FEATURE_HIDDEN"]
        node_in, edge_in = _widths(c)
        if c["AGGR_TYPE"] == "agnostic":
            self.mpn_node_cls = MPLayer(node_in, edge_in, nd, ed, hidden, c["AGGR"])
        else:
            self.mpn_node_cls = TypeAwareMPNLayer(
                node_in=node_in, edge_in=edge_in, init_edge_dim=edge_emb[-1], node_dim=nd,
                edge_dim=ed, edge_hidden=hidden, num_types=self.num_types)
        self.edge_classification = MLP(ed, c["EDGE_CLASS"]["OUTPUT_SIZES"], c["BN"])
        self.node_classification = MLP(nd, c["NODE_CLASS"]["OUTPUT_SIZES"], c["BN"])
        self.classification = MLP(nd, c["CLASS"]["OUTPUT_SIZES"], c["BN"])

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None):
        """x (N, F) f32, edge_attr (E, EDGE_INPUT_DIM), edge_index (2, E) flat
        ids, edge_valid (E,), edge_src_local (E,) source ids within their
        image; ``dtype`` is the working type; ``node_valid`` (N,) masks the
        BatchNorm statistics in training; ``node_types`` (N,) the raw joint
        types, which the kernel-free routes read (on the kernel routes'
        type-blocked layout they are index arithmetic, but for the GT
        joints of ``_GT_NODES``). The route is ``route`` when given, else
        ``_MSG_PASS`` resolved for the module's mode (module docstring)."""
        c = self.cfg
        plain = c.get("_PLAIN_ROUTE")
        gt_nodes = bool(c.get("_GT_NODES"))
        if route is None or (plain and route != plain):
            route = msg_pass_route(route or c.get("_MSG_PASS", "auto"), self.training, plain,
                                   not gt_nodes)
        elif not plain and route in PLAIN_ROUTES:
            raise NotImplementedError(f"route {route!r}: this MPN runs the kernel routes")
        elif gt_nodes:
            msg_pass_route(route, self.training, None, False)   # refuses type-blocked routes
        if plain:
            types = None
            if node_types is not None:
                types = sum_node_types(c["NODE_TYPE_SUMMARY"], node_types.long())
            return self._forward_plain(x, edge_attr, edge_index, edge_valid, dtype, node_valid,
                                       types)
        npt = c["_NODES_PER_TYPE"]
        e = edge_index.shape[1]
        edge_features = self.edge_embedding(edge_attr.to(dtype), edge_valid)
        node_features = self.node_embedding(x.to(dtype), node_valid)

        # loop-invariant inputs of every step (_run_steps' ``pre``): source
        # types are index arithmetic on the type-blocked layout, a gather on
        # the GT joints (pemp_tpu/models/mpn/models.py:147-155)
        if gt_nodes:
            raw = node_types.long()[edge_index[0].long()]
        else:
            raw = (edge_index[0].long() // npt) % c["NUM_JOINTS"]
        pre = {
            "src_type": sum_node_types(c["NODE_TYPE_SUMMARY"], raw).to(torch.int32).reshape(e),
            "valid": edge_valid.to(torch.int32).reshape(e),
        }
        layer = self.mpn_node_cls
        init_nodes, init_edges = node_features, edge_features
        if route == "fused_step":
            pre["src_local"] = edge_src_local.to(torch.int32).reshape(e)
            pre["nodes_per_image"] = c["NUM_JOINTS"] * npt
            sw = layer.step_weights(dtype)
            q = (init_edges @ sw["w_init_edge"].t()).contiguous()
            for _ in range(c["STEPS"]):
                nf = torch.cat([init_nodes, node_features], dim=-1)
                node_features, edge_features = layer(nf, q, edge_features, pre, sw)
            return {
                "edge": [self.edge_classification(edge_features)[..., 0]],
                "node": [self.node_classification(node_features)[..., 0]],
                "class": [self.classification(node_features)],
            }

        # the split edge MLP routes (pemp_tpu/models/mpn/models.py:199-211);
        # the source gather's plan where a gradient can flow
        n = x.shape[0]
        pre["src"] = edge_index[0].long()
        pre["n_img"] = c["NUM_JOINTS"] * npt
        grad = torch.is_grad_enabled()
        pre["gather_plan"] = gather_plan(pre["src"], pre["n_img"], n) if grad else None
        if route in ("einsum", "dots") and grad:
            pre["select_plans"] = split_linear_plans(pre["src_type"], n, self.num_types,
                                                     route == "dots")
        step = {"pallas": layer.forward_typed, "hybrid": layer.forward_hybrid,
                "einsum": layer.forward_einsum, "dots": layer.forward_einsum}[route]
        if route in ("hybrid", "einsum"):
            cslots = c["_BLOCKED_C"]
            pre["rev_perm"] = reverse_edge_perm(edge_index[0], edge_valid, n, cslots).long()
            pre["blocks"] = (c["NUM_JOINTS"], npt * cslots)
            summary = c["NODE_TYPE_SUMMARY"]
            pre["type_sum_map"] = None if summary == "not" else sum_node_types(
                summary, torch.arange(c["NUM_JOINTS"], device=x.device))
        dn, dec = layer.node_in, layer.init_edge_dim
        w0 = layer.mlp_edge[0].weight.to(dtype)
        q = init_edges @ w0[:, 2 * dn:2 * dn + dec].t()
        init_proj = init_nodes @ w0[:, dn:dn + (dn - layer.node_dim)].t()
        steps, aux = c["STEPS"], c.get("AUX_LOSS_STEPS", 0)
        preds = {"edge": [], "node": [], "class": []}
        for i in range(steps):
            nf = torch.cat([init_nodes, node_features], dim=-1)
            node_features, edge_features = step(nf, q, init_proj, edge_features, pre)
            if self.training and i >= steps - aux - 1:
                preds["node"].append(self.node_classification(node_features, node_valid)[..., 0])
                preds["class"].append(self.classification(node_features, node_valid))
                preds["edge"].append(
                    self.edge_classification(edge_features, edge_valid)[..., 0])
        if not self.training:
            preds["edge"].append(self.edge_classification(edge_features, edge_valid)[..., 0])
        preds["node"].append(self.node_classification(node_features, node_valid)[..., 0])
        preds["class"].append(self.classification(node_features, node_valid))
        return preds

    def _forward_plain(self, x, edge_attr, edge_index, edge_valid, dtype, node_valid, types):
        """The kernel-free routes: MPLayer (``agnostic``) or the per-type
        layer's ``forward_segment`` (``segment``), in ``dtype``, with the
        split routes' heads."""
        c = self.cfg
        per_type = c["AGGR_TYPE"] == "per_type"
        if types is None and per_type:
            raise ValueError("the per-type layer needs node_types")
        pre = plain_pre(c, edge_index, edge_valid, types, self.num_types, per_type)
        layer = self.mpn_node_cls
        step = layer.forward_segment if per_type else layer
        edge_features = self.edge_embedding(edge_attr.to(dtype), edge_valid)
        node_features = self.node_embedding(x.to(dtype), node_valid)
        init_nodes, init_edges = node_features, edge_features
        steps, aux = c["STEPS"], c["AUX_LOSS_STEPS"]
        preds = {"edge": [], "node": [], "class": []}
        for i in range(steps):
            nf, ef = node_features, edge_features
            if c["SKIP"]:
                nf = torch.cat([init_nodes, node_features], dim=-1)
                ef = torch.cat([init_edges, edge_features], dim=-1)
            node_features, edge_features = step(nf, ef, pre)
            if self.training and i >= steps - aux - 1:
                preds["node"].append(self.node_classification(node_features, node_valid)[..., 0])
                preds["class"].append(self.classification(node_features, node_valid))
                preds["edge"].append(
                    self.edge_classification(edge_features, edge_valid)[..., 0])
        if not self.training:
            preds["edge"].append(self.edge_classification(edge_features, edge_valid)[..., 0])
        preds["node"].append(self.node_classification(node_features, node_valid)[..., 0])
        preds["class"].append(self.classification(node_features, node_valid))
        return preds


class VanillaMPN(nn.Module):
    """Edge-only classification MPN (pemp_tpu.models.mpn.models.VanillaMPN;
    reference VanillaMPN.py:78-116): embeddings with ``MPN.BN`` (and the
    node embedding's END_WITH_RELU for both), the shared MPLayer for
    ``STEPS`` steps, the edge head on the last ``AUX_LOSS_STEPS + 1`` steps
    (in both modes, as the JAX package). Returns node ``[None]`` and class
    ``None``. A config without ``EDGE_EMB.OUTPUT_SIZES`` raises KeyError at
    build (the JAX package at its first call)."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        c = dict(mpn_cfg)
        _check_flagship(c)
        self.cfg = c
        end = c["NODE_EMB"].get("END_WITH_RELU", False)
        self.edge_embedding = MLP(c["EDGE_INPUT_DIM"], c["EDGE_EMB"]["OUTPUT_SIZES"], c["BN"],
                                  end)
        self.node_embedding = MLP(c["NODE_INPUT_DIM"], c["NODE_EMB"]["OUTPUT_SIZES"], c["BN"],
                                  end)
        node_in, edge_in = _widths(c)
        ed = c["EDGE_FEATURE_DIM"]
        self.mpn_node_cls = MPLayer(node_in, edge_in, c["NODE_FEATURE_DIM"], ed,
                                    c["EDGE_FEATURE_HIDDEN"], c["AGGR"])
        self.edge_classification = MLP(ed, c["EDGE_CLASS"]["OUTPUT_SIZES"], c["BN"])

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None):
        """As NodeClassificationMPN.forward, on the ``agnostic`` route
        (``node_types`` is not read)."""
        del edge_src_local, node_types
        c = self.cfg
        if route != "agnostic":
            msg_pass_route(route or c.get("_MSG_PASS", "auto"), self.training, "agnostic")
        pre = plain_pre(c, edge_index, edge_valid, None, 0, False)
        edge_features = self.edge_embedding(edge_attr.to(dtype), edge_valid)
        node_features = self.node_embedding(x.to(dtype), node_valid)
        init_nodes, init_edges = node_features, edge_features
        steps, aux = c["STEPS"], c["AUX_LOSS_STEPS"]
        preds = []
        for i in range(steps):
            nf, ef = node_features, edge_features
            if c["SKIP"]:
                nf = torch.cat([init_nodes, node_features], dim=-1)
                ef = torch.cat([init_edges, edge_features], dim=-1)
            node_features, edge_features = self.mpn_node_cls(nf, ef, pre)
            if i >= steps - aux - 1:
                preds.append(self.edge_classification(edge_features, edge_valid)[..., 0])
        return {"edge": preds, "node": [None], "class": None}


# the names of the reference factory (MessagePassingNetwork/__init__.py:
# 27-73) the port has; the rest of the zoo is refused by name
MODELS = {"NodeClassificationMPN": NodeClassificationMPN, "VanillaMPN": VanillaMPN}


def get_mpn_model(mpn_cfg: dict) -> nn.Module:
    """The MPN ``mpn_cfg["NAME"]`` names (pemp_tpu.models.mpn.models.
    get_mpn_model); raises ``NotImplementedError`` for a name the port does
    not have."""
    name = mpn_cfg.get("NAME")
    if name not in MODELS:
        _check_flagship(dict(mpn_cfg))
    return MODELS[name](mpn_cfg)
