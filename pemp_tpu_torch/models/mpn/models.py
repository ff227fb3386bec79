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
G1) run in both. The layer variants, on every model whose layer reads
them (models.mpn.layers), take the form config.defaults.layer_route gives them
on that route, as the JAX layer does on a TPU: the per-type edge MLP takes
K2 where the route names the fused step, an aggregation other than one
attention head the split linear (``einsum``'s on the symmetric layout,
``dots``' on the asymmetric one) with K4 or a plain per-type sum.
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

from pemp_tpu_torch.config.defaults import (
    AGNOSTIC_MPNS,
    PLAIN_ROUTES,
    layer_route,
    msg_pass_route,
)
from pemp_tpu_torch.models.mpn.layers import (
    _HIERARCHY,
    MLP,
    Linear,
    MPLayer,
    TypeAwareMPNLayer,
    node_type_columns,
    num_summary_types,
    split_linear_plans,
    sum_node_types,
    type_order,
)
from pemp_tpu_torch.ops.gather_mm import gather_plan
from pemp_tpu_torch.ops.knn import reverse_edge_perm

# the models whose layer is MPLayer (or, VanillaMPN2, a kernel-free one of
# its own) whatever AGGR_TYPE says, and those that take NODE_STEPS
_AGNOSTIC = (*AGNOSTIC_MPNS, "MPNTag")
_NODE_STEPS = ("NodeClassificationMPN", "NodeClassificationMPNWithBackground",
               "NodeClassificationMPNTag", "NodeClassificationMPNAttention",
               "NodeClassificationMPNWithRef")
# the model-level keys: the default, the values the port runs beside it,
# and the models that read the key (the other JAX models ignore it; the
# port refuses it there)
_MODEL_KEYS = {
    "LATE_FUSION_POS": (False, (True,), ("NodeClassificationMPN",
                                         "NodeClassificationMPNWithBackground",
                                         "NodeClassificationMPNGroupBased")),
    "DROP_FEATURE": ("", ("edge_dist",), ("VanillaMPN",)),
}
# the models whose MPLayer the JAX package builds without the node update
# MLP (pemp_tpu/models/mpn/zoo.py:167-170), and VanillaMPN2, whose own
# layer reads neither EDGE_MLP nor (not ported) USE_NODE_UPDATE_MLP
_NO_UPDATE_MLP = ("NodeClassificationMPNSelfAttention", "VanillaMPN2")
# the baselines, which pass no message (pemp_tpu/models/mpn/models.py:461-508)
_BASELINES = ("TagThreshold", "PlainTag", "LogisticEdgeClassifier")


def _refuse(c: dict, key: str, default, values, name: str) -> None:
    value = c.get(key, default)
    if value != default and value not in values:
        raise NotImplementedError(f"MPN {key}={value!r}: not ported on {name} ({key}="
                                  f"{(default, *values)!r} are)")


def _check_layer_keys(c: dict, name: str, agnostic: bool) -> None:
    """The keys the model's layer reads, as the JAX layers read them on
    every model: MPLayer's per-type edge MLP (``per_type``; the JAX
    MPLayer raises on ``per_type_2``) and node update MLP; the per-type
    layer's edge MLP (``per_type_2`` the same as ``per_type``), any
    ``AGGR_SUB`` (the two attentions, else the per-type aggregation by
    ``AGGR``: add, max, mean) and the ``mlp`` or ``hierarch_mlp`` update
    (the latter at 17 or 14 types, the two counts its hierarchy is written
    for)."""
    if agnostic:
        _refuse(c, "EDGE_MLP", "agnostic", () if name == "VanillaMPN2" else ("per_type",), name)
        _refuse(c, "USE_NODE_UPDATE_MLP", False, () if name in _NO_UPDATE_MLP else (True,),
                name)
        if c.get("EDGE_MLP", "agnostic") != "agnostic" and c.get(
                "NODE_TYPE_SUMMARY", "not") != "not":
            raise NotImplementedError(
                f"{name}: MPLayer's per-type edge MLP with a NODE_TYPE_SUMMARY (the JAX models "
                f"type its ends by the raw types, or VanillaMPN its sources by the summary)")
        return
    _refuse(c, "EDGE_MLP", "agnostic", ("per_type", "per_type_2"), name)
    _refuse(c, "USE_NODE_UPDATE_MLP", False, (), name)
    sub = c.get("AGGR_SUB", "node_edge_attn")
    if sub not in ("node_edge_attn", "node_edge_attn_per_type") and c.get("AGGR") not in (
            "add", "max", "mean"):
        raise NotImplementedError(f"MPN AGGR={c.get('AGGR')!r}: add, max or mean")
    update = c.get("UPDATE_TYPE", "mlp")
    if update not in ("mlp", "hierarch_mlp"):
        raise NotImplementedError(f"MPN UPDATE_TYPE={update!r}: mlp or hierarch_mlp")
    types = num_summary_types(c.get("NODE_TYPE_SUMMARY", "not"), c["NUM_JOINTS"])
    if update == "hierarch_mlp" and types not in _HIERARCHY:
        raise NotImplementedError(
            f"MPN UPDATE_TYPE=hierarch_mlp at {types} types: its hierarchy is written for "
            f"{sorted(_HIERARCHY)} (the JAX layer indexes CrowdPose's 14 for any count but 17)")


def mpn_cfg_from_config(mpn_config) -> dict:
    """The open MPN config subtree as a plain dict."""
    d = mpn_config.to_dict() if hasattr(mpn_config, "to_dict") else dict(mpn_config)
    d.setdefault("NODE_STEPS", 0)
    return d


def _check_flagship(c: dict) -> None:
    """Raises ``NotImplementedError`` unless the port has the MPN ``c``
    asks for: a model of :func:`registry`, the model-level keys where the
    model reads them (:data:`_MODEL_KEYS`; ``NODE_STEPS`` on the models of
    :data:`_NODE_STEPS`), a known aggregation type, the keys its layer
    reads (:func:`_check_layer_keys`), and on the kernel
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
    for key, (default, values, models) in _MODEL_KEYS.items():
        _refuse(c, key, default, values if name in models else (), name)
    if name not in _NODE_STEPS:
        _refuse(c, "NODE_STEPS", 0, (), name)
    _check_layer_keys(c, name, agnostic)
    if agnostic or c.get("_PLAIN_ROUTE"):
        return
    if not c.get("SKIP"):
        raise NotImplementedError("MPN SKIP=False: the kernel routes run the flagship's skip "
                                  "connections")
    if not c.get("_BLOCKED_C") or not c.get("_NODES_PER_TYPE"):
        raise NotImplementedError("the flagship MPN needs the blocked, type-blocked layout")


def edge_width(c: dict) -> int:
    """The width of the edge carry the steps put out: ``EDGE_FEATURE_DIM``,
    or ``EDGE_FEATURE_HIDDEN`` with the per-type edge MLP, whose output is
    that wide (pemp_tpu/models/mpn/layers.py:542-544)."""
    if c.get("EDGE_MLP", "agnostic") == "agnostic":
        return c["EDGE_FEATURE_DIM"]
    return c["EDGE_FEATURE_HIDDEN"]


def _widths(c: dict, node_init: int | None = None, edge_init: int | None = None):
    """(node_in, edge_in) of a shared layer: with ``SKIP`` the step's
    inputs are its stack's initial features (the embeddings by default)
    concatenated with the carry."""
    nd, ed = c["NODE_FEATURE_DIM"], edge_width(c)
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
        edge_hidden=c["EDGE_FEATURE_HIDDEN"], num_types=num_types,
        edge_mlp=c.get("EDGE_MLP", "agnostic"), aggr=c.get("AGGR", "add"),
        aggr_sub=c.get("AGGR_SUB", "node_edge_attn"), update_type=c.get("UPDATE_TYPE", "mlp"))


def _mp_layer(c: dict, node_init=None, edge_init=None, num_types=None):
    node_in, edge_in = _widths(c, node_init, edge_init)
    return MPLayer(node_in, edge_in, c["NODE_FEATURE_DIM"], c["EDGE_FEATURE_DIM"],
                   c["EDGE_FEATURE_HIDDEN"], c["AGGR"], edge_mlp=c.get("EDGE_MLP", "agnostic"),
                   num_types=num_types or c["NUM_JOINTS"],
                   use_node_update_mlp=c.get("USE_NODE_UPDATE_MLP", False))


def _shared_layer(c: dict, num_types: int, node_init=None, edge_init=None):
    """The step's shared layer: an MPLayer for ``AGGR_TYPE: agnostic``
    (pemp_tpu/models/mpn/models.py:94-107), else the per-type layer."""
    if c["AGGR_TYPE"] == "agnostic":
        return _mp_layer(c, node_init, edge_init, num_types)
    return _type_aware_layer(c, num_types, node_init, edge_init)


class LateFusionEdgeMLP(nn.Module):
    """The edge embedding with the position fused late
    (``MPN.LATE_FUSION_POS``; pemp_tpu.models.mpn.models.LateFusionEdgeMLP,
    reference NodeClassificationMPNSimple.py:7-21): an MLP ``pos_mlp`` on the
    first two edge columns (the offsets) and one ``edge_mlp`` on the rest,
    each half of ``EDGE_EMB``'s widths but the last, then ``out`` on relu of
    both. Names are the JAX scopes (no converter records the
    reference's)."""

    def __init__(self, in_dim: int, output_sizes, bn: bool, end_with_relu: bool):
        super().__init__()
        single = [w // 2 for w in output_sizes[:-1]]
        self.pos_mlp = MLP(2, single, bn, end_with_relu)
        self.edge_mlp = MLP(in_dim - 2, single, bn, end_with_relu)
        self.out = Linear(2 * single[-1], output_sizes[-1])

    def forward(self, edge_attr, valid=None):
        p = self.pos_mlp(edge_attr[:, :2], valid)
        c = self.edge_mlp(edge_attr[:, 2:], valid)
        return self.out(torch.relu(torch.cat([p, c], dim=-1)))


def _embeddings(c: dict, bn=None, end=None):
    """(node_embedding, edge_embedding) MLPs: each with its own ``BN`` and
    ``END_WITH_RELU``, or ``bn`` and ``end`` for both (VanillaMPN); with
    ``LATE_FUSION_POS`` the edge embedding is :class:`LateFusionEdgeMLP`."""
    def mlp(key, in_dim):
        e = c[key]
        return MLP(c[in_dim], e["OUTPUT_SIZES"], e["BN"] if bn is None else bn,
                   e.get("END_WITH_RELU", False) if end is None else end)
    edge = mlp("EDGE_EMB", "EDGE_INPUT_DIM")
    if c.get("LATE_FUSION_POS"):
        e = c["EDGE_EMB"]
        edge = LateFusionEdgeMLP(c["EDGE_INPUT_DIM"], e["OUTPUT_SIZES"], e["BN"],
                                 e.get("END_WITH_RELU", False))
    return mlp("NODE_EMB", "NODE_INPUT_DIM"), edge


def plain_pre(c: dict, edge_index, edge_valid, types, num_types: int, per_type: bool) -> dict:
    """The loop-invariant index columns of the kernel-free routes
    (pemp_tpu/models/mpn/models.py:124-148): each edge's source and target
    (the target a repeat on the blocked layout), validity, and with
    ``per_type`` the source types from ``types`` (N,) and their order for
    the message projection; with the per-type edge MLP the node types'
    columns (layers.node_type_columns)."""
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
    if c.get("EDGE_MLP", "agnostic") != "agnostic":
        pre.update(node_type_columns(types, num_types))
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
        ``_MSG_PASS`` resolved for the module's mode (module docstring);
        on a kernel route the form the layer's variant takes there
        (config.defaults.layer_route)."""
        c = self.cfg
        plain = c.get("_PLAIN_ROUTE")
        why = "use_gt" if c.get("_GT_NODES") else (
            "group_based" if c["NAME"] == "NodeClassificationMPNGroupBased" else None)
        if route is None or (plain and route != plain):
            route = msg_pass_route(route or c.get("_MSG_PASS", "auto"), self.training, plain,
                                   why)
        else:
            if not plain and route in PLAIN_ROUTES:
                raise NotImplementedError(f"route {route!r}: this MPN runs the kernel routes")
            if why:
                msg_pass_route(route, self.training, None, why)   # refuses type-blocked routes
        if route in PLAIN_ROUTES:
            return route
        # the form the layer's variant takes there, as the JAX layer's
        return layer_route(route, c.get("EDGE_MLP", "agnostic"),
                           c.get("AGGR_SUB", "node_edge_attn"))

    def _pre(self, route, x, edge_index, edge_valid, edge_src_local, node_types):
        """The loop-invariant inputs of every step of ``route``
        (``_run_steps``' ``pre``): source types are index arithmetic on
        the type-blocked layout, a gather on the GT joints
        (pemp_tpu/models/mpn/models.py:147-155); on the split routes the
        source gather's plan where a gradient can flow, and the
        projection's and the reverse permutation's columns."""
        c = self.cfg
        types = None
        if node_types is not None:
            types = sum_node_types(c["NODE_TYPE_SUMMARY"], node_types.long())
        typed_edges = c.get("EDGE_MLP", "agnostic") != "agnostic"
        if types is None and (route == "segment" or typed_edges):
            raise ValueError("the per-type layer and the per-type edge MLP need node_types")
        if route in PLAIN_ROUTES:
            return plain_pre(c, edge_index, edge_valid, types, self.num_types,
                             route == "segment")
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
        if typed_edges:
            pre.update(node_type_columns(types, self.num_types))
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
        q, init_proj = layer.split_invariants(init_nodes, init_edges, dtype)

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
    layer an MPLayer (pemp_tpu/models/mpn/models.py:94-107). With
    ``NODE_STEPS`` a second stack ``mpn_node``, its own weights on the
    same route, takes the first's final features as its initial ones after
    the edge head and feeds the node and class heads (:279, 310-314).
    """

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup(mpn_cfg)
        c = self.cfg
        self.node_embedding, self.edge_embedding = _embeddings(c)
        self.mpn_node_cls = _shared_layer(c, self.num_types)
        nd, ed = c["NODE_FEATURE_DIM"], edge_width(c)
        if c.get("NODE_STEPS", 0):
            self.mpn_node = _shared_layer(c, self.num_types, nd, ed)
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
        types, which the kernel-free routes and the per-type edge MLP read
        (on the kernel routes' type-blocked layout the source types are
        index arithmetic, but for the GT joints of ``_GT_NODES``);
        ``joint_tags`` is read by the tag model only. The route is
        ``route`` when given, else ``_MSG_PASS`` resolved for the module's
        mode (module docstring)."""
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
        if c.get("NODE_STEPS", 0):
            step = self._stepper(self.mpn_node, route, node_features, edge_features, dtype)
            for _ in range(c["NODE_STEPS"]):
                node_features, edge_features = step(node_features, edge_features, pre)
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
        nd, ed = c["NODE_FEATURE_DIM"], edge_width(c)
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
        nd, ed = c["NODE_FEATURE_DIM"], edge_width(c)
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
        self.edge_classification = MLP(edge_width(c), c["EDGE_CLASS"]["OUTPUT_SIZES"], c["BN"])

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                **unread):
        """As NodeClassificationMPN.forward, on the ``agnostic`` route
        (``node_types`` is read by the per-type edge MLP only). With
        ``DROP_FEATURE: edge_dist`` the first two edge columns (the
        offsets) are zeroed (pemp_tpu/models/mpn/models.py:342-347)."""
        c = self.cfg
        route = self._route(route)
        typed = c.get("EDGE_MLP", "agnostic") != "agnostic"
        pre = self._pre(route, x, edge_index, edge_valid, edge_src_local,
                        node_types if typed else None)
        if c.get("DROP_FEATURE") == "edge_dist":
            edge_attr = torch.cat([torch.zeros_like(edge_attr[:, :2]), edge_attr[:, 2:]], dim=1)
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
