"""The MPN models (counterpart of pemp_tpu.models.mpn.models and of
``MPNTag`` in pemp_tpu.models.mpn.zoo); :func:`get_mpn_model` builds one by
``MODEL.MPN.NAME``, these or the research zoo's (models.mpn.zoo), and
refuses the two names whose reference classes are absent:

* ``NodeClassificationMPN``, the flagship (also under the reference's name
  ``NodeClassificationMPNWithBackground``: the background class is the
  flagship with J + 1 class outputs and ``WITH_BACKGROUND`` labels);
* ``VanillaMPN``, the edge-only model;
* ``JointTypeClassification``, the class head alone;
* ``NodeClassificationMPNTag``, a per-node tag regression head after the
  steps, then node and class heads (after a second step stack
  ``mpn_node`` with ``NODE_STEPS``);
* ``NodeClassificationMPNGroupBased``, two masked passes of the shared
  layer a step, within and across body parts;
* ``MPNTag``, the tag head after type-agnostic MPLayer steps;
* the baselines ``TagThreshold``, ``PlainTag`` and
  ``LogisticEdgeClassifier``, which pass no message.

Forward contract as in the reference
(src/Models/MessagePassingNetwork/NodeClassificationMPNSimple.py:62-97):

    (x, edge_attr, edge_index, ...) ->
        dict(edge=[(E,) logits], node=[(N,)], class=[(N, C)], tag=[(N,)])

with ``[None]`` (class ``None``) where a model has no such head, as in the
JAX package (pemp_tpu/models/mpn/models.py:326-508). Every model takes
``node_labels``, ``feature_maps`` and ``batch_index`` too, which only the
zoo's ClassificationMPN and SelfAttention read.

The route of each step is ``TPU.MSG_PASS`` (``_MSG_PASS`` in the MPN
config), resolved as the JAX package's build_pose_model resolves it on a
TPU (pemp_tpu/models/pose_estimation.py:234-256) for the module's mode:
``auto`` is the fused step (K1) in eval mode and the typed message kernel
(``pallas``: K2, differentiable through K2b) in training mode; ``pallas``
(K2's bf16 form at eval), ``hybrid`` (K3, through K3b), ``einsum`` and
``dots`` (K4, through K4b) and ``fused_step`` (K1, through K2b, K1b and
G1) run in both.
The two reverse-permutation routes (``hybrid``, ``einsum``) read the
reverse-edge involution of the symmetric layout, built once per forward;
``dots`` runs on the asymmetric layout, as ``pallas``. Where a gradient can
flow, the plans of G1 (ops.gather_mm.gather_plan) are built once per
forward too: the source gather's (K1's on ``fused_step``), and on
``einsum`` and ``dots`` the projection's selections'. These kernel routes
need the target-major blocked kNN layout (``_BLOCKED_C``,
``_NODES_PER_TYPE`` nodes of each type an image) and the flagship layer; under ``MODEL.GC.USE_GT``
(``_GT_NODES``) the nodes are the GT joints, person-major, so the source
types are gathered, ``auto`` is ``pallas`` in both modes and the routes
that need type-blocked nodes (``fused_step``, ``hybrid``, ``einsum``)
raise; so they do on the group-based model, whose masked passes the JAX
package runs on its plain per-type layer. The kernel-free routes
(``_PLAIN_ROUTE``, config.defaults.PLAIN_ROUTES) run everything else:
``segment`` (the per-type layer on an edge list) and ``agnostic``
(MPLayer on either layout); an explicit kernel route there raises. Every
model with message passing runs its steps through :class:`_Steps`, so the
tag and class models take the flagship's routes. The module's mode decides
the rest: the flagship in training collects per-step outputs, with the
heads on the last ``AUX_LOSS_STEPS + 1`` steps and on the final features
(pemp_tpu/models/mpn/models.py:288-316), and every model takes its
BatchNorm statistics over valid rows; eval runs the heads on the final
features only.

The JAX package scans the shared-weight step with ``nn.scan``; here it is a
Python loop over the same module. The index columns, the init-edge
projection ``q`` and the step's weight views are loop-invariant and are
computed once per forward.
"""

from __future__ import annotations

import torch
from torch import nn

from pemp_tpu_torch.config.defaults import AGNOSTIC_MPNS, PLAIN_ROUTES, msg_pass_route
from pemp_tpu_torch.models.mpn.layers import (
    MLP,
    Linear,
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
# steps but on the tag model) wait for a configuration that sets them
_PORTED = {"EDGE_MLP": "agnostic", "USE_NODE_UPDATE_MLP": False, "DROP_FEATURE": "",
           "LATE_FUSION_POS": False, "NODE_STEPS": 0}
# and of the per-type layer on every route (attention aggregation, mlp update)
_PER_TYPE_LAYER = {"AGGR_SUB": "node_edge_attn", "UPDATE_TYPE": "mlp"}
# the models whose layer is MPLayer (or, VanillaMPN2, a kernel-free one of
# its own) whatever AGGR_TYPE says, and those that take NODE_STEPS
_AGNOSTIC = (*AGNOSTIC_MPNS, "MPNTag")
_NODE_STEPS = ("NodeClassificationMPNTag", "NodeClassificationMPNAttention",
               "NodeClassificationMPNWithRef")
# the baselines, which pass no message (pemp_tpu/models/mpn/models.py:461-508)
_BASELINES = ("TagThreshold", "PlainTag", "LogisticEdgeClassifier")


def mpn_cfg_from_config(mpn_config) -> dict:
    """The open MPN config subtree as a plain dict."""
    d = mpn_config.to_dict() if hasattr(mpn_config, "to_dict") else dict(mpn_config)
    d.setdefault("NODE_STEPS", 0)
    return d


def _check_flagship(c: dict) -> None:
    """Raises ``NotImplementedError`` unless the port has the MPN ``c``
    asks for: a model of :func:`registry`, the values of :data:`_PORTED`
    (``NODE_STEPS`` free on the models of :data:`_NODE_STEPS`), a known
    aggregation type, the flagship's per-type layer, and on the kernel
    routes (``_PLAIN_ROUTE`` unset) skip connections and the blocked,
    type-blocked layout."""
    name = c.get("NAME")
    models = registry()
    if name in ("ClassificationNaive", "NodeClassificationMPNGroupBasedHierach"):
        # the reference's own imports for these are broken
        # (pemp_tpu/models/mpn/models.py:558-566)
        raise NotImplementedError(
            f"{name}: class absent from the reference repository (broken import in its "
            f"MessagePassingNetwork/__init__.py)")
    if name not in models:
        raise NotImplementedError(f"MODEL.MPN.NAME={name!r}: not in the MPN zoo the port has, "
                                  f"{sorted(models)}")
    if name in _BASELINES:
        return
    if c.get("AGGR_TYPE") not in ("per_type", "agnostic"):
        raise NotImplementedError(f"MPN AGGR_TYPE={c.get('AGGR_TYPE')!r}")
    if name == "MPNTag" and c["AGGR_TYPE"] != "agnostic":
        raise NotImplementedError("MPNTag supports AGGR_TYPE=agnostic only (reference "
                                  "MPNTag.py:17)")
    if name == "NodeClassificationMPNGroupBased" and c["AGGR_TYPE"] != "per_type":
        raise NotImplementedError("NodeClassificationMPNGroupBased runs the per-type layer "
                                  "(pemp_tpu/models/mpn/models.py:617-624); AGGR_TYPE "
                                  f"{c['AGGR_TYPE']!r} is not ported")
    if name == "ClassificationMPNSimple" and c.get("NODE_TYPE_SUMMARY", "not") != "not":
        raise NotImplementedError(
            f"ClassificationMPNSimple with NODE_TYPE_SUMMARY={c['NODE_TYPE_SUMMARY']!r}: its "
            f"forward reads the raw types while its layer is sized by the summary (reference "
            f"ClassificationMPNSimple.py:16-41); only 'not' is ported")
    if name == "NodeClassificationMPNWithRef" and c.get("NODE_STEPS", 0) > 1:
        raise NotImplementedError(
            f"NodeClassificationMPNWithRef with NODE_STEPS={c['NODE_STEPS']}: its node stack's "
            f"edge width changes after one pass (the JAX model fails at the second)")
    agnostic = name in _AGNOSTIC or c["AGGR_TYPE"] == "agnostic"
    ported = {k: v for k, v in _PORTED.items() if not (k == "NODE_STEPS" and name in _NODE_STEPS)}
    for key, value in {**ported, **({} if agnostic else _PER_TYPE_LAYER)}.items():
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


def _widths(c: dict, node_init: int | None = None, edge_init: int | None = None):
    """(node_in, edge_in) of a shared layer: with ``SKIP`` the step's
    inputs are its stack's initial features (the embeddings by default)
    concatenated with the carry."""
    nd, ed = c["NODE_FEATURE_DIM"], c["EDGE_FEATURE_DIM"]
    if c["SKIP"]:
        node_init = c["NODE_EMB"]["OUTPUT_SIZES"][-1] if node_init is None else node_init
        edge_init = c["EDGE_EMB"]["OUTPUT_SIZES"][-1] if edge_init is None else edge_init
        return node_init + nd, edge_init + ed
    return nd, ed


def _type_aware_layer(c: dict, num_types: int, node_init=None, edge_init=None):
    node_in, edge_in = _widths(c, node_init, edge_init)
    init_edge = c["EDGE_EMB"]["OUTPUT_SIZES"][-1] if edge_init is None else edge_init
    return TypeAwareMPNLayer(
        node_in=node_in, edge_in=edge_in, init_edge_dim=init_edge,
        node_dim=c["NODE_FEATURE_DIM"], edge_dim=c["EDGE_FEATURE_DIM"],
        edge_hidden=c["EDGE_FEATURE_HIDDEN"], num_types=num_types)


def _mp_layer(c: dict, node_init=None, edge_init=None):
    node_in, edge_in = _widths(c, node_init, edge_init)
    return MPLayer(node_in, edge_in, c["NODE_FEATURE_DIM"], c["EDGE_FEATURE_DIM"],
                   c["EDGE_FEATURE_HIDDEN"], c["AGGR"])


def _shared_layer(c: dict, num_types: int, node_init=None, edge_init=None):
    """The step's shared layer: an MPLayer for ``AGGR_TYPE: agnostic``
    (pemp_tpu/models/mpn/models.py:94-107), else the per-type layer."""
    if c["AGGR_TYPE"] == "agnostic":
        return _mp_layer(c, node_init, edge_init)
    return _type_aware_layer(c, num_types, node_init, edge_init)


def _embeddings(c: dict, bn=None, end=None):
    """(node_embedding, edge_embedding) MLPs: each with its own ``BN`` and
    ``END_WITH_RELU``, or ``bn`` and ``end`` for both (VanillaMPN)."""
    def mlp(key, in_dim):
        e = c[key]
        return MLP(c[in_dim], e["OUTPUT_SIZES"], e["BN"] if bn is None else bn,
                   e.get("END_WITH_RELU", False) if end is None else end)
    return mlp("NODE_EMB", "NODE_INPUT_DIM"), mlp("EDGE_EMB", "EDGE_INPUT_DIM")


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


class _Steps(nn.Module):
    """The message-passing part the MPNs with steps share: route
    resolution, the loop-invariant index columns of the route (``pre``)
    and a step function per step stack (pemp_tpu/models/mpn/models.py:
    131-235, ``_run_steps``). A model builds its embeddings and heads, and
    drives its stacks through :meth:`_pre` and :meth:`_stepper`."""

    def _setup(self, mpn_cfg: dict):
        c = dict(mpn_cfg)
        _check_flagship(c)
        if c["NAME"] in _AGNOSTIC or c["AGGR_TYPE"] == "agnostic":
            c["_PLAIN_ROUTE"] = "agnostic"    # MPLayer runs no kernel on any layout
        self.cfg = c
        self.num_types = num_summary_types(c["NODE_TYPE_SUMMARY"], c["NUM_JOINTS"])

    def _route(self, route):
        """The route of this forward: ``route`` when given, else
        ``_MSG_PASS`` resolved for the module's mode (module docstring)."""
        c = self.cfg
        plain = c.get("_PLAIN_ROUTE")
        why = "use_gt" if c.get("_GT_NODES") else (
            "group_based" if c["NAME"] == "NodeClassificationMPNGroupBased" else None)
        if route is None or (plain and route != plain):
            return msg_pass_route(route or c.get("_MSG_PASS", "auto"), self.training, plain, why)
        if not plain and route in PLAIN_ROUTES:
            raise NotImplementedError(f"route {route!r}: this MPN runs the kernel routes")
        if why:
            msg_pass_route(route, self.training, None, why)   # refuses type-blocked routes
        return route

    def _pre(self, route, x, edge_index, edge_valid, edge_src_local, node_types):
        """The loop-invariant inputs of every step of ``route``
        (``_run_steps``' ``pre``): source types are index arithmetic on
        the type-blocked layout, a gather on the GT joints
        (pemp_tpu/models/mpn/models.py:147-155); on the split routes the
        source gather's plan where a gradient can flow, and the
        projection's and the reverse permutation's columns."""
        c = self.cfg
        if route in PLAIN_ROUTES:
            types = None
            if node_types is not None:
                types = sum_node_types(c["NODE_TYPE_SUMMARY"], node_types.long())
            per_type = route == "segment"
            if types is None and per_type:
                raise ValueError("the per-type layer needs node_types")
            return plain_pre(c, edge_index, edge_valid, types, self.num_types, per_type)
        npt = c["_NODES_PER_TYPE"]
        e = edge_index.shape[1]
        if c.get("_GT_NODES"):
            raw = node_types.long()[edge_index[0].long()]
        else:
            raw = (edge_index[0].long() // npt) % c["NUM_JOINTS"]
        pre = {
            "src_type": sum_node_types(c["NODE_TYPE_SUMMARY"], raw).to(torch.int32).reshape(e),
            "valid": edge_valid.to(torch.int32).reshape(e),
        }
        n = x.shape[0]
        n_img = c["NUM_JOINTS"] * npt
        grad = torch.is_grad_enabled()
        if route == "fused_step":
            pre["src_local"] = edge_src_local.to(torch.int32).reshape(e)
            pre["nodes_per_image"] = n_img
            # the rows K1 gathers, img_base + src_local, keyed as G1's plan
            # keys them: its backward scatters dq onto dp through the plan
            pre["gather_plan"] = gather_plan(pre["src_local"], n_img, n) if grad else None
            return pre
        # the split edge MLP routes (pemp_tpu/models/mpn/models.py:199-211)
        pre["src"] = edge_index[0].long()
        pre["n_img"] = n_img
        pre["gather_plan"] = gather_plan(pre["src"], n_img, n) if grad else None
        if route in ("einsum", "dots") and grad:
            pre["select_plans"] = split_linear_plans(pre["src_type"], n, self.num_types,
                                                     route == "dots")
        if route in ("hybrid", "einsum"):
            cslots = c["_BLOCKED_C"]
            pre["rev_perm"] = reverse_edge_perm(edge_index[0], edge_valid, n, cslots).long()
            pre["blocks"] = (c["NUM_JOINTS"], npt * cslots)
            summary = c["NODE_TYPE_SUMMARY"]
            pre["type_sum_map"] = None if summary == "not" else sum_node_types(
                summary, torch.arange(c["NUM_JOINTS"], device=x.device))
        return pre

    def _stepper(self, layer, route, init_nodes, init_edges, dtype, fixed=None):
        """``step(nodes, edges, pre) -> (nodes, edges)``: one step of
        ``layer`` on ``route`` in the stack whose initial features are
        ``init_nodes`` and ``init_edges`` (the skip connections' first
        halves), with that stack's loop-invariant projections taken once.
        ``fixed``: the first columns of the edge carry where they stay the
        same over the stack (a one-pass stack whose carry starts wider than
        the layer's edge width, zoo.NodeClassificationMPNSimpleWithRef); on
        the fused step their projection joins the loop-invariant one, so
        that the kernel gets a carry of the edge width."""
        skip = self.cfg["SKIP"]
        if route in PLAIN_ROUTES:
            fn = layer.forward_segment if route == "segment" else layer

            def plain_step(nodes, edges, pre):
                if skip:
                    nodes = torch.cat([init_nodes, nodes], dim=-1)
                    edges = torch.cat([init_edges, edges], dim=-1)
                return fn(nodes, edges, pre)
            return plain_step
        if route == "fused_step":
            sw = layer.step_weights(dtype)
            q = init_edges @ sw["w_init_edge"].t()
            k = 0 if fixed is None else fixed.shape[1]
            if k:
                q = q + fixed @ sw["w_cur"][:k]
                sw = {**sw, "w_cur": sw["w_cur"][k:].contiguous()}
            q = q.contiguous()

            def fused(nodes, edges, pre):
                return layer(torch.cat([init_nodes, nodes], dim=-1), q, edges[:, k:], pre, sw)
            return fused
        fn = {"pallas": layer.forward_typed, "hybrid": layer.forward_hybrid,
              "einsum": layer.forward_einsum, "dots": layer.forward_einsum}[route]
        dn, dec = layer.node_in, layer.init_edge_dim
        w0 = layer.mlp_edge[0].weight.to(dtype)
        q = init_edges @ w0[:, 2 * dn:2 * dn + dec].t()
        init_proj = init_nodes @ w0[:, dn:dn + (dn - layer.node_dim)].t()

        def split(nodes, edges, pre):
            return fn(torch.cat([init_nodes, nodes], dim=-1), q, init_proj, edges, pre)
        return split


class NodeClassificationMPN(_Steps):
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
        self._setup(mpn_cfg)
        c = self.cfg
        self.node_embedding, self.edge_embedding = _embeddings(c)
        self.mpn_node_cls = _shared_layer(c, self.num_types)
        nd, ed = c["NODE_FEATURE_DIM"], c["EDGE_FEATURE_DIM"]
        self.edge_classification = MLP(ed, c["EDGE_CLASS"]["OUTPUT_SIZES"], c["BN"])
        self.node_classification = MLP(nd, c["NODE_CLASS"]["OUTPUT_SIZES"], c["BN"])
        self.classification = MLP(nd, c["CLASS"]["OUTPUT_SIZES"], c["BN"])

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                **unread):
        """x (N, F) f32, edge_attr (E, EDGE_INPUT_DIM), edge_index (2, E) flat
        ids, edge_valid (E,), edge_src_local (E,) source ids within their
        image; ``dtype`` is the working type; ``node_valid`` (N,) masks the
        BatchNorm statistics in training; ``node_types`` (N,) the raw joint
        types, which the kernel-free routes read (on the kernel routes'
        type-blocked layout they are index arithmetic, but for the GT
        joints of ``_GT_NODES``); ``joint_tags`` is read by the tag model
        only. The route is ``route`` when given, else ``_MSG_PASS``
        resolved for the module's mode (module docstring)."""
        c = self.cfg
        route = self._route(route)
        pre = self._pre(route, x, edge_index, edge_valid, edge_src_local, node_types)
        edge_features = self.edge_embedding(edge_attr.to(dtype), edge_valid)
        node_features = self.node_embedding(x.to(dtype), node_valid)
        step = self._stepper(self.mpn_node_cls, route, node_features, edge_features, dtype)
        steps, aux = c["STEPS"], c.get("AUX_LOSS_STEPS", 0)
        preds = {"edge": [], "node": [], "class": [], "tag": [None]}
        for i in range(steps):
            node_features, edge_features = step(node_features, edge_features, pre)
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


class JointTypeClassification(_Steps):
    """Class-only model (pemp_tpu.models.mpn.models.JointTypeClassification;
    reference JointTypeClassification.py): the flagship's embeddings and
    steps, then the class head on the final node features, in both modes.
    Returns edge and node ``[None]``."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup(mpn_cfg)
        c = self.cfg
        self.node_embedding, self.edge_embedding = _embeddings(c)
        self.mpn_node_cls = _shared_layer(c, self.num_types)
        self.classification = MLP(c["NODE_FEATURE_DIM"], c["CLASS"]["OUTPUT_SIZES"], c["BN"])

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                **unread):
        """As NodeClassificationMPN.forward."""
        route = self._route(route)
        pre = self._pre(route, x, edge_index, edge_valid, edge_src_local, node_types)
        edge_features = self.edge_embedding(edge_attr.to(dtype), edge_valid)
        node_features = self.node_embedding(x.to(dtype), node_valid)
        step = self._stepper(self.mpn_node_cls, route, node_features, edge_features, dtype)
        for _ in range(self.cfg["STEPS"]):
            node_features, edge_features = step(node_features, edge_features, pre)
        return {"edge": [None], "node": [None],
                "class": [self.classification(node_features, node_valid)], "tag": [None]}


class NodeClassificationMPNTag(_Steps):
    """MPN with a per-node tag regression head
    (pemp_tpu.models.mpn.models.NodeClassificationMPNTag; reference
    NodeClassificationMPNTag.py:7-90): the flagship's embeddings and
    ``STEPS`` steps, the tag head ``tag_pred`` (``NODE_TAG``, ``MPN.BN``) on
    their node features, plus the joint's tag from the maps with
    ``TAG_SKIP`` (the mean of TTA's tag channels); then ``NODE_STEPS`` steps
    of a second stack ``mpn_node`` whose initial features are the first
    stack's outputs, and the node and class heads. Returns edge
    ``[None]``; each head once, in both modes."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup(mpn_cfg)
        c = self.cfg
        nd, ed = c["NODE_FEATURE_DIM"], c["EDGE_FEATURE_DIM"]
        self.node_embedding, self.edge_embedding = _embeddings(c)
        self.mpn_node_cls = _shared_layer(c, self.num_types)
        if c.get("NODE_STEPS", 0):
            self.mpn_node = _shared_layer(c, self.num_types, nd, ed)
        self.tag_pred = MLP(nd, c["NODE_TAG"]["OUTPUT_SIZES"], c["BN"])
        self.node_classification = MLP(nd, c["NODE_CLASS"]["OUTPUT_SIZES"], c["BN"])
        self.classification = MLP(nd, c["CLASS"]["OUTPUT_SIZES"], c["BN"])

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                **unread):
        """As NodeClassificationMPN.forward; ``joint_tags`` (N,) or (N, S)
        the tag maps at the nodes, added to the tag with ``TAG_SKIP``."""
        c = self.cfg
        route = self._route(route)
        pre = self._pre(route, x, edge_index, edge_valid, edge_src_local, node_types)
        edge_features = self.edge_embedding(edge_attr.to(dtype), edge_valid)
        node_features = self.node_embedding(x.to(dtype), node_valid)
        step = self._stepper(self.mpn_node_cls, route, node_features, edge_features, dtype)
        for _ in range(c["STEPS"]):
            node_features, edge_features = step(node_features, edge_features, pre)
        tag = self.tag_pred(node_features, node_valid)[..., 0]
        if c.get("TAG_SKIP", False) and joint_tags is not None:
            if joint_tags.dim() == 2:        # TTA's tag channels: skip from their mean
                joint_tags = joint_tags.mean(dim=-1)
            tag = tag + joint_tags
        if c.get("NODE_STEPS", 0):
            step = self._stepper(self.mpn_node, route, node_features, edge_features, dtype)
            for _ in range(c["NODE_STEPS"]):
                node_features, edge_features = step(node_features, edge_features, pre)
        return {"edge": [None],
                "node": [self.node_classification(node_features, node_valid)[..., 0]],
                "class": [self.classification(node_features, node_valid)], "tag": [tag]}


class NodeClassificationMPNGroupBased(_Steps):
    """Body-part message passing
    (pemp_tpu.models.mpn.models.NodeClassificationMPNGroupBased; reference
    NodeClassificationMPNGroupBased.py:62-116): each step runs the shared
    layer twice over the whole edge list, first with only the valid edges
    within a body part (``sum_node_types("per_body_part")`` of both ends
    equal) counted, then, on the first pass's nodes, with only the valid
    edges across parts; each edge keeps the new features of its own pass
    (0 on invalid edges). The JAX package calls the layer without its
    precomputed columns, which leaves it on the plain per-type layer; here
    ``auto`` is ``pallas`` (K2, K2b: one launch a pass, two a step) in both
    modes, ``dots`` runs too, and the routes that need type-blocked nodes
    raise. Heads on the final features, in both modes."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup(mpn_cfg)
        c = self.cfg
        self.node_embedding, self.edge_embedding = _embeddings(c)
        self.mpn_node_cls = _type_aware_layer(c, self.num_types)
        nd, ed = c["NODE_FEATURE_DIM"], c["EDGE_FEATURE_DIM"]
        self.edge_classification = MLP(ed, c["EDGE_CLASS"]["OUTPUT_SIZES"], c["BN"])
        self.node_classification = MLP(nd, c["NODE_CLASS"]["OUTPUT_SIZES"], c["BN"])
        self.classification = MLP(nd, c["CLASS"]["OUTPUT_SIZES"], c["BN"])

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                **unread):
        """As NodeClassificationMPN.forward; ``node_types`` (N,) is needed
        for the body parts."""
        route = self._route(route)
        pre = self._pre(route, x, edge_index, edge_valid, edge_src_local, node_types)
        part = sum_node_types("per_body_part", node_types.long())
        same = part[edge_index[0].long()] == part[edge_index[1].long()]
        ev = edge_valid.bool()
        within, cross = ev & same, ev & ~same
        valid = pre["valid"]
        pre_within = {**pre, "valid": within.to(valid.dtype)}
        pre_cross = {**pre, "valid": cross.to(valid.dtype)}
        edge_features = self.edge_embedding(edge_attr.to(dtype), edge_valid)
        node_features = self.node_embedding(x.to(dtype), node_valid)
        step = self._stepper(self.mpn_node_cls, route, node_features, edge_features, dtype)
        for _ in range(self.cfg["STEPS"]):
            node_features, e_within = step(node_features, edge_features, pre_within)
            node_features, e_cross = step(node_features, edge_features, pre_cross)
            edge_features = torch.where(within[:, None], e_within,
                                        torch.where(cross[:, None], e_cross,
                                                    torch.zeros_like(e_cross)))
        return {"edge": [self.edge_classification(edge_features, edge_valid)[..., 0]],
                "node": [self.node_classification(node_features, node_valid)[..., 0]],
                "class": [self.classification(node_features, node_valid)], "tag": [None]}


class VanillaMPN(_Steps):
    """Edge-only classification MPN (pemp_tpu.models.mpn.models.VanillaMPN;
    reference VanillaMPN.py:78-116): embeddings with ``MPN.BN`` (and the
    node embedding's END_WITH_RELU for both), the shared MPLayer for
    ``STEPS`` steps, the edge head on the last ``AUX_LOSS_STEPS + 1`` steps
    (in both modes, as the JAX package). Returns node ``[None]`` and class
    ``None``. A config without ``EDGE_EMB.OUTPUT_SIZES`` raises KeyError at
    build (the JAX package at its first call)."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup(mpn_cfg)
        c = self.cfg
        node_embedding, self.edge_embedding = _embeddings(
            c, c["BN"], c["NODE_EMB"].get("END_WITH_RELU", False))
        self.node_embedding = node_embedding
        self.mpn_node_cls = _mp_layer(c)
        self.edge_classification = MLP(c["EDGE_FEATURE_DIM"], c["EDGE_CLASS"]["OUTPUT_SIZES"],
                                       c["BN"])

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                **unread):
        """As NodeClassificationMPN.forward, on the ``agnostic`` route
        (``node_types`` is not read)."""
        c = self.cfg
        route = self._route(route)
        pre = self._pre(route, x, edge_index, edge_valid, edge_src_local, None)
        edge_features = self.edge_embedding(edge_attr.to(dtype), edge_valid)
        node_features = self.node_embedding(x.to(dtype), node_valid)
        step = self._stepper(self.mpn_node_cls, route, node_features, edge_features, dtype)
        steps, aux = c["STEPS"], c["AUX_LOSS_STEPS"]
        preds = []
        for i in range(steps):
            node_features, edge_features = step(node_features, edge_features, pre)
            if i >= steps - aux - 1:
                preds.append(self.edge_classification(edge_features, edge_valid)[..., 0])
        return {"edge": preds, "node": [None], "class": None, "tag": [None]}


class MPNTag(_Steps):
    """Tag regression alone (pemp_tpu.models.mpn.zoo.MPNTag; reference
    MPNTag.py:30-48): embeddings, ``STEPS`` steps of the type-agnostic
    MPLayer (``AGGR_TYPE: agnostic`` only, the ``agnostic`` route: no
    kernel), the tag head ``tag_pred`` (``NODE_TAG``, ``MPN.BN``). Returns
    edge and node ``[None]``, class ``None``; the loss is
    ``pure_tag_loss``."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup(mpn_cfg)
        c = self.cfg
        self.node_embedding, self.edge_embedding = _embeddings(c)
        self.mpn_node_cls = _mp_layer(c)
        self.tag_pred = MLP(c["NODE_FEATURE_DIM"], c["NODE_TAG"]["OUTPUT_SIZES"], c["BN"])

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                **unread):
        """As VanillaMPN.forward."""
        route = self._route(route)
        pre = self._pre(route, x, edge_index, edge_valid, edge_src_local, None)
        edge_features = self.edge_embedding(edge_attr.to(dtype), edge_valid)
        node_features = self.node_embedding(x.to(dtype), node_valid)
        step = self._stepper(self.mpn_node_cls, route, node_features, edge_features, dtype)
        for _ in range(self.cfg["STEPS"]):
            node_features, edge_features = step(node_features, edge_features, pre)
        tag = self.tag_pred(node_features, node_valid)[..., 0]
        return {"edge": [None], "node": [None], "class": None, "tag": [tag]}


class _Baseline(nn.Module):
    """A model that passes no message: its edge logits come from the edge
    attributes alone (pemp_tpu/models/mpn/models.py:461-508). No route is
    run, so ``route`` is not read."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        _check_flagship(dict(mpn_cfg))
        self.cfg = dict(mpn_cfg)

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                **unread):
        return {"edge": [self.edge_logits(edge_attr.to(dtype))], "node": [None],
                "class": None, "tag": [None]}


class TagThreshold(_Baseline):
    """Edge prediction 1 where the first edge attribute (the tag distance)
    is below 1, else 0 (reference TagThreshold.py)."""

    def edge_logits(self, edge_attr):
        return (edge_attr[:, 0] < 1.0).to(edge_attr.dtype)


class PlainTag(_Baseline):
    """Edge prediction the first edge attribute itself (reference
    PlainTag.py)."""

    def edge_logits(self, edge_attr):
        return edge_attr[:, 0]


class LogisticEdgeClassifier(_Baseline):
    """Logistic regression on the edge attributes, one Linear ``linear``
    (reference LogisticEdgeClassifier.py)."""

    def __init__(self, mpn_cfg: dict):
        super().__init__(mpn_cfg)
        self.linear = Linear(mpn_cfg["EDGE_INPUT_DIM"], 1)

    def edge_logits(self, edge_attr):
        return self.linear(edge_attr)[..., 0]


# the names of the reference factory (MessagePassingNetwork/__init__.py:
# 27-73) this module has; the rest of the zoo is models.mpn.zoo's
MODELS = {
    "NodeClassificationMPN": NodeClassificationMPN,
    # the reference's NodeClassificationMPNWithBackground.py is absent from
    # its tree: the flagship with the WITH_BACKGROUND labels and losses
    # (pemp_tpu/models/mpn/models.py:527-530)
    "NodeClassificationMPNWithBackground": NodeClassificationMPN,
    "VanillaMPN": VanillaMPN,
    "JointTypeClassification": JointTypeClassification,
    "NodeClassificationMPNTag": NodeClassificationMPNTag,
    "NodeClassificationMPNGroupBased": NodeClassificationMPNGroupBased,
    "MPNTag": MPNTag,
    "TagThreshold": TagThreshold,
    "PlainTag": PlainTag,
    "LogisticEdgeClassifier": LogisticEdgeClassifier,
}


def registry() -> dict:
    """Every MPN the port has by its factory name: :data:`MODELS` and the
    research zoo's (models.mpn.zoo.ZOO, which builds on this module)."""
    from pemp_tpu_torch.models.mpn.zoo import ZOO

    return {**MODELS, **ZOO}


def get_mpn_model(mpn_cfg: dict) -> nn.Module:
    """The MPN ``mpn_cfg["NAME"]`` names (pemp_tpu.models.mpn.models.
    get_mpn_model); raises ``NotImplementedError`` for a name the port does
    not have."""
    models = registry()
    name = mpn_cfg.get("NAME")
    if name not in models:
        _check_flagship(dict(mpn_cfg))
    return models[name](mpn_cfg)
