"""Message-passing layers on padded, static-shape graphs (counterpart of
pemp_tpu.models.mpn.layers).

Module and parameter names follow the original reference
(src/Models/MessagePassingNetwork/layers.py), so its ``state_dict`` keys
load unchanged. The flagship ``TypeAwareMPNLayer`` runs on the
target-major blocked layout with type-blocked nodes in the five forms of
``TPU.MSG_PASS``: the fused step (K1), and the split edge MLP followed by
the typed message kernel (``pallas``: K2, backward K2b), by the
reverse-permutation projection and the slim attention aggregation
(``hybrid``: K3, backward K3b), by the same projection and the blocked
aggregate (``einsum``: K4, backward K4b), or by the all-types projection
and the blocked aggregate (``dots``). All five read the same parameters.
The split forms gather the edge MLP's source rows through ops.gather_mm
(G1 in the backward). On an edge list (every graph but the target-major
kNN one) the layer's ``forward_segment`` runs the JAX package's unfused
form of the same layer. ``MPLayer`` is the type-agnostic layer
(``MPN.AGGR_TYPE: agnostic``, VanillaMPN), on either layout. Neither of
the last two runs a kernel: the JAX package computes them in plain XLA.
Every layer computes in its input's dtype.

The JAX package's layer variants, on every form they take there
(config.layer_route says which): the per-type edge MLP
(``MPN.EDGE_MLP: per_type``, :class:`TypeAwareEdgeUpdate`, on both
layers), the skeleton-hierarchy update (``UPDATE_TYPE: hierarch_mlp``,
:class:`HierarchUpdateMlp`), T attention heads
(``AGGR_SUB: node_edge_attn_per_type``) or a plain per-type aggregation
by ``MPN.AGGR`` (any other ``AGGR_SUB``), and MPLayer's node update MLP
(``USE_NODE_UPDATE_MLP``). No reference converter or docstring records
the reference's names of the per-type edge MLP and the hierarchical
update, so theirs follow the JAX scopes: ``mlp_edge.layer_1`` and
``mlp_edge.layer_2`` (``weight`` (T, Dout, Din), ``bias`` (T, Dout)),
``mlp_edge.edge_layer``, ``mlp_edge.out``; ``update_mlp.first_{i}``,
``update_mlp.second_{i}``, ``update_mlp.final``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pemp_tpu_torch.ops.attn_aggregate import fused_attn_aggregate
from pemp_tpu_torch.ops.blocked_attn import blocked_attn_aggregate
from pemp_tpu_torch.ops.fused_step import fused_mpn_step
from pemp_tpu_torch.ops.gather_mm import gather_plan, gather_rows_mm_or_plain
from pemp_tpu_torch.ops.segment import (
    blocked_aggregate,
    blocked_per_type_aggregate,
    per_type_aggregate,
    per_type_attention_aggregate,
    segment_aggregate,
)
from pemp_tpu_torch.ops.typed_message import fused_typed_message_aggregate
from pemp_tpu_torch.parallel import distributed

# COCO joint order: nose, eye_l, eye_r, ear_l, ear_r, sho_l, sho_r, elb_l,
# elb_r, wri_l, wri_r, hip_l, hip_r, kne_l, kne_r, ank_l, ank_r
_LEFT_RIGHT = [0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8]
_PER_BODY_PART = [0, 0, 0, 0, 0, 1, 1, 2, 3, 2, 3, 4, 5, 4, 5, 4, 5]


def sum_node_types(node_summary: str, node_types: torch.Tensor) -> torch.Tensor:
    """reference: src/Models/MessagePassingNetwork/utils.py:6-19"""
    if node_summary == "not":
        return node_types
    table = {"left_right": _LEFT_RIGHT, "per_body_part": _PER_BODY_PART}.get(node_summary)
    if table is None:
        raise NotImplementedError(node_summary)
    return torch.tensor(table, dtype=node_types.dtype, device=node_types.device)[
        node_types.long()
    ]


def num_summary_types(node_summary: str, num_joints: int) -> int:
    if node_summary == "not":
        return num_joints
    if node_summary == "left_right":
        return 9
    if node_summary == "per_body_part":
        return 6
    raise NotImplementedError(node_summary)


def type_blocked_projection(edge, w_edge, rev_perm, raw_types: int, block_slots: int,
                            sum_map=None):
    """Each slot's edge features times the weight of its source's type, as
    one batched matmul with no type waste (the ``rev_perm`` form of
    pemp_tpu.models.mpn.layers.TypeAwareSplitLinear, :224-235).

    edge (E, De) in the symmetric target-major layout with type-blocked
    nodes; w_edge (T, D, De) per-type weights in nn.Linear's layout;
    rev_perm (E,) the reverse-edge involution (ops.knn.reverse_edge_perm);
    raw_types J and block_slots K * C. Slot f of the permuted rows carries
    the features of f's reverse, whose source is node f // C, of raw type
    (f // (K*C)) mod J: so row block j of each image takes weight j
    (``sum_map[j]`` under a node-type summary), and permuting back gives
    every valid slot its source type's projection. Returns (E, D).
    """
    e, de = edge.shape
    w = w_edge if sum_map is None else w_edge[sum_map]                 # (J, D, De)
    cperm = edge[rev_perm].reshape(e // (raw_types * block_slots), raw_types, block_slots, de)
    bj = torch.einsum("bjkd,jfd->bjkf", cperm, w)
    return bj.reshape(e, -1)[rev_perm]


def typed_rows(group_slots: int, types, num_types: int):
    """Slot s's row g * T + types[s] of a (groups * T, D) table, g = s //
    ``group_slots``: the (node, type) row of ``a`` (group_slots C) or the
    (slot, type) row of the all-types projection (group_slots 1)."""
    slot = torch.arange(types.numel(), device=types.device)
    return torch.div(slot, group_slots, rounding_mode="floor") * num_types + types.long()


def split_linear_plans(types, num_nodes: int, num_types: int, all_types: bool) -> dict:
    """G1's plans (ops.gather_mm.gather_plan) for the two selections of
    :func:`type_aware_split_linear` over ``types`` (E,): ``"a"`` for the
    (node, type) rows of ``a``, and with ``all_types`` (no ``rev_perm``)
    ``"b"`` for the (slot, type) rows of the all-types projection. Built
    once per forward where a gradient can flow."""
    e, t = types.numel(), num_types
    plans = {"a": gather_plan(typed_rows(e // num_nodes, types, t), t, num_nodes * t)}
    if all_types:
        plans["b"] = gather_plan(typed_rows(1, types, t), t, e * t)
    return plans


def type_aware_split_linear(x, edge, types, weight, bias, rev_perm=None, raw_types: int = 0,
                            block_slots: int = 0, sum_map=None, plans=None):
    """pemp_tpu.models.mpn.layers.TypeAwareSplitLinear: the type-``types[s]``
    Linear of [x[s // C], edge[s]] for every slot s, its node part computed
    once per (node, type) with the bias. x (N, dn), edge (E, De), types (E,)
    source types; weight (T, D, dn + De), bias (T, D). The edge part is
    :func:`type_blocked_projection` given ``rev_perm`` (and the blocks and
    ``sum_map`` it reads), else the JAX package's all-types branch
    (pemp_tpu/models/mpn/layers.py:236-239): every slot projected onto all
    T types, an (E, T, D) tensor, then each slot's own type taken. Both
    selections are row gathers (:func:`typed_rows`) through
    ops.gather_mm.gather_rows_mm_or_plain, with T rows an image, so their
    backward is G1 and keeps no (E, T, D) tensor; ``plans`` is
    :func:`split_linear_plans` of these types, needed where a gradient can
    flow. Returns (E, D)."""
    n, dn = x.shape
    e = edge.shape[0]
    t = weight.shape[0]
    plans = plans or {}
    a = torch.einsum("ni,toi->nto", x, weight[:, :, :dn]) + bias[None]   # (N, T, D)
    a_sel = gather_rows_mm_or_plain(a.reshape(n * t, -1), typed_rows(e // n, types, t), t,
                                    plans.get("a"))
    if rev_perm is None:
        b_all = torch.einsum("ei,toi->eto", edge, weight[:, :, dn:])     # (E, T, D)
        b_sel = gather_rows_mm_or_plain(b_all.reshape(e * t, -1), typed_rows(1, types, t), t,
                                        plans.get("b"))
    else:
        b_sel = type_blocked_projection(edge, weight[:, :, dn:], rev_perm, raw_types,
                                        block_slots, sum_map)
    return a_sel + b_sel


class Linear(nn.Linear):
    """nn.Linear that computes in its input's dtype (flax Dense ``dtype``)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm1d over the element axis with a validity mask, in float32
    (float64 for float64 input), cast back
    (pemp_tpu.models.mpn.layers.MaskedBatchNorm).

    In training mode the statistics are taken over the rows ``valid``
    marks: the biased variance normalises, the unbiased one enters the
    running update, momentum 0.1, so padding never touches either. Under
    data parallelism the weighted sums and the count are summed over the
    ranks, so the moments are the global batch's, as under the JAX
    package's sharded step. In eval mode the running statistics are read.
    """

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x, valid=None):
        xf = x if x.dtype == torch.float64 else x.float()
        if self.training:
            mean, var, count = distributed.global_moments(xf, valid)
            with torch.no_grad():
                unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = 1.0 / torch.sqrt(var + self.eps)
        y = (xf - mean) * inv * self.weight + self.bias
        return y.to(x.dtype)


class MLP(nn.Sequential):
    """reference _make_mlp (layers.py:8-29): Linear / ReLU / BN stacks, in
    the reference's Sequential order, so keys read ``<name>.<seq>.weight``.
    ReLU precedes BN; the final Linear gets neither unless end_with_relu.
    ``valid`` masks the rows of the BatchNorm statistics in training."""

    def __init__(self, in_dim: int, hidden_dims, bn: bool = False,
                 end_with_relu: bool = False):
        layers = []
        dims = list(hidden_dims)
        for i, d in enumerate(dims):
            layers.append(Linear(in_dim, d))
            if i < len(dims) - 1 or end_with_relu:
                layers.append(nn.ReLU())
                if bn:
                    layers.append(MaskedBatchNorm(d))
            in_dim = d
        super().__init__(*layers)

    def forward(self, x, valid=None):
        for layer in self:
            x = layer(x, valid) if isinstance(layer, MaskedBatchNorm) else layer(x)
        return x


class _TypedNodeMLP(nn.Module):
    """reference TypeAwareNodeUpdate: one Sequential(Linear, ReLU) per type
    (keys ``mlp.<t>.0.*``). The fused step uses the stacked weights."""

    def __init__(self, num_types: int, din: int, dout: int):
        super().__init__()
        self.mlp = nn.ModuleList(
            nn.Sequential(Linear(din, dout), nn.ReLU()) for _ in range(num_types)
        )

    def stacked(self):
        """(T, Dout, Din) weights and (T, Dout) biases."""
        w = torch.stack([m[0].weight for m in self.mlp])
        b = torch.stack([m[0].bias for m in self.mlp])
        return w, b


def typed_projection(x, weight, order):
    """Row e of ``x`` (E, Din) times the weight of its type t(e):
    ``x[e] @ weight[t(e)].T`` for weight (T, Dout, Din), without the
    (E, T, Dout) tensor of every type (pemp_tpu/models/mpn/layers.py:
    236-239 builds it). ``order`` is :func:`type_order` of the types: the
    rows sorted by type, one matmul per type, then put back. Returns
    (E, Dout)."""
    perm, inverse, counts = order
    parts = [rows @ weight[t].t() for t, rows in enumerate(x[perm].split(counts))]
    return torch.cat(parts)[inverse]


def type_order(types, num_types: int):
    """(perm, inverse, counts) of :func:`typed_projection`: the rows of
    each type together, in type order (a stable sort), the permutation
    back, and each type's row count (on the host: computed once per
    forward, as the types do not change from step to step)."""
    perm = torch.sort(types.long(), stable=True)[1]
    inverse = torch.empty_like(perm)
    inverse[perm] = torch.arange(perm.numel(), device=perm.device)
    counts = torch.bincount(types.long(), minlength=num_types).tolist()
    return perm, inverse, counts


def _aggregate(m, pre, num_nodes: int, kind: str):
    """``kind`` over each node's valid in-edges: blocked over its C slots,
    else a segment op on the targets."""
    if pre["blocked_c"]:
        return blocked_aggregate(m, num_nodes, kind, pre["valid"])
    return segment_aggregate(m, pre["dst"], num_nodes, kind, pre["valid"])


def _split_edge_mlp(lin0, x, edges, pre):
    """lin0 of [x_i, x_j, edges] for every edge, as node-level products
    gathered per edge (x_i's repeated on the blocked layout) plus the edge
    part: x (N, node_in), edges (E, edge_in). Returns (E, H)."""
    dn = x.shape[1]
    w = lin0.weight.to(x.dtype)
    tgt = x @ w[:, :dn].t()
    src = x @ w[:, dn:2 * dn].t()
    h = src[pre["src"]] + edges @ w[:, 2 * dn:].t() + lin0.bias.to(x.dtype)
    if pre["blocked_c"]:
        return h + torch.repeat_interleave(tgt, pre["blocked_c"], dim=0)
    return h + tgt[pre["dst"]]


def _targets_part(lin, x, pre):
    """lin's weight columns for x_i (its first ``x.shape[1]``), projected
    per node and taken for each edge's target. Returns (E, Dout)."""
    return at_targets(x @ lin.weight.to(x.dtype)[:, :x.shape[1]].t(), pre, pre["src"].numel())


def at_targets(y, pre, num_edges: int):
    """Each edge's target row of the per-node ``y`` (N, D): a repeat over
    the C slots of the blocked layout (``pre`` without ``dst``, or with
    ``blocked_c``), else a gather by ``pre["dst"]``. Returns (E, D)."""
    if pre.get("blocked_c") or "dst" not in pre:
        return torch.repeat_interleave(y, num_edges // y.shape[0], dim=0)
    return y[pre["dst"]]


def node_type_columns(types, num_types: int) -> dict:
    """The per-node type columns the per-type edge MLP reads: ``node_type``
    (N,) and ``node_order`` (:func:`type_order` of it), once per forward."""
    return {"node_type": types.long(), "node_order": type_order(types, num_types)}


class TypeAwareLinear(nn.Module):
    """``num_types`` Linears, each row taking its type's
    (pemp_tpu.models.mpn.layers.TypeAwareLinear): ``weight`` (T, Dout, Din)
    in nn.Linear's layout, ``bias`` (T, Dout)."""

    def __init__(self, num_types: int, din: int, dout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_types, dout, din))
        self.bias = nn.Parameter(torch.zeros(num_types, dout))
        for w in self.weight:
            nn.init.kaiming_uniform_(w, a=5 ** 0.5)


class TypeAwareEdgeUpdate(nn.Module):
    """The per-type edge MLP (``MPN.EDGE_MLP: per_type`` or ``per_type_2``;
    pemp_tpu.models.mpn.layers.TypeAwareEdgeUpdate, reference layers.py:
    276-303): relu(out(relu([layer_1(x_i by the target's type),
    layer_2(x_j by the source's type), edge_layer(e)]))), ``width``
    (EDGE_FEATURE_HIDDEN) wide.

    x_i and x_j are node rows, so both typed products are taken once a node
    with its own type, (N, width), never an (E, T, width) tensor; and as
    ``out`` is linear, its thirds on them are taken per node too, then
    repeated over the target's slots and gathered by source. Only the edge
    third is computed per edge."""

    def __init__(self, num_types: int, node_in: int, edge_in: int, width: int):
        super().__init__()
        self.layer_1 = TypeAwareLinear(num_types, node_in, width)
        self.layer_2 = TypeAwareLinear(num_types, node_in, width)
        self.edge_layer = Linear(edge_in, width)
        self.out = Linear(3 * width, width)

    def node_terms(self, x, pre):
        """out's first two thirds on the per-node typed products: (r_i,
        r_j), (N, width) each; ``pre`` holds :func:`node_type_columns`."""
        dt = x.dtype
        h = self.out.weight.shape[0]
        w = torch.cat([self.layer_1.weight, self.layer_2.weight], dim=1).to(dt)
        b = torch.cat([self.layer_1.bias, self.layer_2.bias], dim=1).to(dt)
        p = torch.relu(typed_projection(x, w, pre["node_order"]) + b[pre["node_type"]])
        wo = self.out.weight.to(dt)
        return p[:, :h] @ wo[:, :h].t(), p[:, h:] @ wo[:, h:2 * h].t()

    def combine(self, r_i, r_j_src, e_pre, pre):
        """The new edges from the per-node terms (r_j taken at each source)
        and the edge layer's output before its ReLU. Returns (E, width)."""
        dt = e_pre.dtype
        h = self.out.weight.shape[0]
        e_part = torch.relu(e_pre) @ self.out.weight.to(dt)[:, 2 * h:].t()
        return torch.relu(e_part + self.out.bias.to(dt) + r_j_src
                          + at_targets(r_i, pre, e_pre.shape[0]))

    def forward(self, x, edges, pre):
        """x (N, node_in), edges (E, edge_in); ``pre`` the plain routes'
        index columns with :func:`node_type_columns`. Returns (E, width)."""
        r_i, r_j = self.node_terms(x, pre)
        return self.combine(r_i, r_j[pre["src"]], self.edge_layer(edges), pre)


# the skeleton hierarchy of HierarchUpdateMlp (reference layers.py:89-128):
# the type groups of the first level, COCO's order for 17 types and
# CrowdPose's otherwise, and the pairs of first-level groups of the second
_HIERARCHY = {
    17: [(0, 1, 2, 3, 4), (5, 6), (7, 9), (8, 10), (11, 12), (13, 15), (14, 16)],
    14: [(0, 1), (2, 3), (4, 6), (5, 7), (8, 9), (10, 12), (11, 13)],
}
_HIERARCHY_2 = [(0, 1), (1, 2), (1, 3), (1, 4), (4, 5), (4, 6)]


class HierarchUpdateMlp(nn.Module):
    """The skeleton-hierarchy update over the (N, T, D) per-type messages
    (``MPN.UPDATE_TYPE: hierarch_mlp``; pemp_tpu.models.mpn.layers.
    HierarchUpdateMlp): relu(first_i) over each group of types, relu(second_i)
    over pairs of those, relu(final) over them all; D // 2 wide inside. The
    JAX layer takes COCO's groups for 17 types and CrowdPose's for any
    other count; the port has the two counts they are written for."""

    def __init__(self, node_dim: int, num_types: int):
        super().__init__()
        half = node_dim // 2
        self.order = _HIERARCHY[num_types]
        for i, types in enumerate(self.order):
            self.add_module(f"first_{i}", Linear(len(types) * node_dim, half))
        for i in range(len(_HIERARCHY_2)):
            self.add_module(f"second_{i}", Linear(2 * half, half))
        self.final = Linear(len(_HIERARCHY_2) * half, node_dim)

    def forward(self, update):
        n = update.shape[0]
        first = torch.stack([torch.relu(getattr(self, f"first_{i}")(update[:, list(t)]
                                                                    .reshape(n, -1)))
                             for i, t in enumerate(self.order)], dim=1)
        second = [torch.relu(getattr(self, f"second_{i}")(first[:, list(pair)].reshape(n, -1)))
                  for i, pair in enumerate(_HIERARCHY_2)]
        return torch.relu(self.final(torch.cat(second, dim=1)))


def edge_mlp(node_in: int, edge_in: int, edge_dim: int, edge_hidden: int):
    """The layers' edge MLP (``MPN.EDGE_MLP: agnostic``):
    Sequential(Linear, ReLU, Linear, ReLU) on [x_i, x_j, e]."""
    return nn.Sequential(Linear(2 * node_in + edge_in, edge_hidden), nn.ReLU(),
                         Linear(edge_hidden, edge_dim), nn.ReLU())


def run_edge_mlp(mlp_edge, x, edges, pre):
    """The new edges of :func:`edge_mlp`'s module: x (N, node_in), edges
    (E, edge_in), ``pre`` the index columns (MPLayer.forward)."""
    h = torch.relu(_split_edge_mlp(mlp_edge[0], x, edges, pre))
    return torch.relu(mlp_edge[2](h))


def _edge_module(node_in, edge_in, edge_dim, edge_hidden, num_types, kind):
    """The layers' edge MLP ``mlp_edge`` by ``MPN.EDGE_MLP``: the agnostic
    :func:`edge_mlp` (``edge_dim`` wide), or :class:`TypeAwareEdgeUpdate`
    (``per_type``, ``per_type_2``: ``edge_hidden`` wide, as the JAX layer
    builds it)."""
    if kind == "agnostic":
        return edge_mlp(node_in, edge_in, edge_dim, edge_hidden)
    if kind in ("per_type", "per_type_2"):
        return TypeAwareEdgeUpdate(num_types, node_in, edge_in, edge_hidden)
    raise NotImplementedError(f"MPN EDGE_MLP={kind!r}")


def new_edges(mlp_edge, x, edges, pre):
    """The new edges of either edge MLP on the plain routes."""
    if isinstance(mlp_edge, TypeAwareEdgeUpdate):
        return mlp_edge(x, edges, pre)
    return run_edge_mlp(mlp_edge, x, edges, pre)


class MPLayer(nn.Module):
    """Type-agnostic message-passing layer (pemp_tpu.models.mpn.layers.
    MPLayer; reference layers.py:32-86): the edge MLP on [x_i, x_j, e]
    (Sequential(Linear, ReLU, Linear, ReLU) as ``mlp_edge``, or the per-type
    :class:`TypeAwareEdgeUpdate` with ``edge_mlp`` per_type), the message
    relu(mlp_node([x_i, e'])), ``aggr`` over each node's valid in-edges
    (``add``, ``max``, ``mean``; blocked on the target-major layout, a
    segment op on an edge list), and with ``use_node_update_mlp``
    relu(update_mlp(.)). State-dict names are the reference's
    (pemp_tpu/train/convert.py:354-381). Products with x_i and x_j are
    taken per node and gathered."""

    def __init__(self, node_in: int, edge_in: int, node_dim: int, edge_dim: int,
                 edge_hidden: int, aggr: str = "max", edge_mlp: str = "agnostic",
                 num_types: int = 17, use_node_update_mlp: bool = False):
        super().__init__()
        self.aggr = aggr
        self.mlp_edge = _edge_module(node_in, edge_in, edge_dim, edge_hidden, num_types,
                                     edge_mlp)
        width = edge_dim if edge_mlp == "agnostic" else edge_hidden
        self.mlp_node = nn.Sequential(Linear(node_in + width, node_dim), nn.ReLU())
        if use_node_update_mlp:
            self.update_mlp = nn.Sequential(Linear(node_dim, node_dim), nn.ReLU())

    def forward(self, x, edges, pre):
        """x (N, node_in) nodes, edges (E, edge_in); ``pre`` the
        loop-invariant index columns (``src``, ``dst`` (E,) each edge's
        source and target, ``blocked_c`` (C, or 0 on an edge list),
        ``valid``; with the per-type edge MLP :func:`node_type_columns`).
        Returns (new nodes (N, node_dim), new edges (E, width))."""
        n = x.shape[0]
        new_edge = new_edges(self.mlp_edge, x, edges, pre)
        lin = self.mlp_node[0]
        w = lin.weight.to(x.dtype)
        m = torch.relu(_targets_part(lin, x, pre) + new_edge @ w[:, x.shape[1]:].t()
                       + lin.bias.to(x.dtype))
        out = _aggregate(m, pre, n, self.aggr)
        if hasattr(self, "update_mlp"):
            out = self.update_mlp(out)
        return out, new_edge


class TypeAwareMPNLayer(nn.Module):
    """Flagship layer. reference: layers.py:157-258. ``forward`` is the
    fused-step form (K1); ``forward_typed`` (K2, differentiable through
    K2b), ``forward_hybrid`` (K3, through K3b) and ``forward_einsum`` (K4,
    through K4b; the ``einsum`` and ``dots`` routes) are the split forms;
    ``forward_segment`` is the edge-list form.

    ``node_in`` / ``edge_in`` are the widths of the skip-concatenated node
    and edge inputs; ``init_edge_dim`` is the width of their loop-invariant
    first half. The flagship's layer has the agnostic edge MLP,
    ``node_edge_attn`` aggregation and the ``mlp`` update; ``edge_mlp``,
    ``aggr_sub`` (with ``aggr``) and ``update_type`` take the JAX layer's
    other values (module docstring). The fused step runs the flagship's
    edge MLP and one attention head only, and K2 and K3 one head
    (config.layer_route keeps the other variants off them).
    """

    def __init__(self, node_in: int, edge_in: int, init_edge_dim: int,
                 node_dim: int, edge_dim: int, edge_hidden: int, num_types: int,
                 edge_mlp: str = "agnostic", aggr: str = "add",
                 aggr_sub: str = "node_edge_attn", update_type: str = "mlp"):
        super().__init__()
        self.node_in = node_in
        self.init_edge_dim = init_edge_dim
        self.num_types = num_types
        self.node_dim = node_dim
        self.aggr = aggr
        self.mlp_edge = _edge_module(node_in, edge_in, edge_dim, edge_hidden, num_types,
                                     edge_mlp)
        width = edge_dim if edge_mlp == "agnostic" else edge_hidden
        self.mlp_node = _TypedNodeMLP(num_types, node_in + width, node_dim)
        heads = {"node_edge_attn": 1, "node_edge_attn_per_type": num_types}.get(aggr_sub)
        if heads:
            self.attn_net = nn.Sequential(Linear(width, heads))
        if update_type == "mlp":
            self.update_mlp = nn.Sequential(Linear(num_types * node_dim, node_dim), nn.ReLU())
        elif update_type == "hierarch_mlp":
            self.update_mlp = HierarchUpdateMlp(node_dim, num_types)
        else:
            raise NotImplementedError(f"MPN UPDATE_TYPE={update_type!r}")

    def _update(self, updates, dt):
        """The node update on the (N, T, D) per-type messages, in ``dt``."""
        u = updates.to(dt)
        if isinstance(self.update_mlp, HierarchUpdateMlp):
            return self.update_mlp(u)
        return self.update_mlp(u.reshape(u.shape[0], -1))

    def _typed_aggregate(self, m, new_edge, pre, num_nodes: int):
        """The (N, T, D) per-type aggregate of the messages ``m`` (E, D):
        the softmax of one attention head, or of each slot's source type's
        head (``node_edge_attn_per_type``), within each (node, source type)
        group, then the weighted sum (K4 on the blocked layout); or
        ``MPN.AGGR`` over each group (plain: the JAX package has no Pallas
        form of it). The scores drop their bias, one constant within each
        group (a group's slots share their source type, so their head), as
        the other routes' logits do."""
        t, dt = self.num_types, m.dtype
        src_type, valid = pre["src_type"], pre["valid"]
        edge_list = "dst" in pre and not pre.get("blocked_c")
        if not hasattr(self, "attn_net"):
            if edge_list:
                return per_type_aggregate(m, pre["dst"], src_type, num_nodes, t, self.aggr, valid)
            return blocked_per_type_aggregate(m, src_type, num_nodes, t, self.aggr, valid)
        scores = new_edge @ self.attn_net[0].weight.to(dt).t()          # (E, heads)
        if scores.shape[1] == 1:
            scores = scores[:, 0]
        else:
            scores = torch.gather(scores, 1, src_type.long()[:, None])[:, 0]
        if edge_list:
            return per_type_attention_aggregate(m, scores, pre["dst"], src_type, num_nodes, t,
                                                valid)
        return blocked_attn_aggregate(m.contiguous(), scores, src_type, num_nodes, t, valid)

    def step_weights(self, dtype):
        """Loop-invariant weight views for the fused step, in ``dtype``."""
        dn, dec = self.node_in, self.init_edge_dim
        w0 = self.mlp_edge[0].weight.to(dtype)          # (H, 2dn + da)
        wn, bn = self.mlp_node.stacked()                 # (T, D, dn + De), (T, D)
        t, d = wn.shape[:2]
        return {
            "w_target": w0[:, :dn],
            "b_target": self.mlp_edge[0].bias.to(dtype),
            "w_source": w0[:, dn:2 * dn],
            "w_init_edge": w0[:, 2 * dn:2 * dn + dec],
            "w_cur": w0[:, 2 * dn + dec:].t().contiguous(),
            "w_e1": self.mlp_edge[2].weight.to(dtype).t().contiguous(),
            "b_e1": self.mlp_edge[2].bias.to(dtype).contiguous(),
            "w_node": wn[:, :, :dn].reshape(t * d, dn).to(dtype),
            "b_node": bn.to(dtype),
            # we_flat[k, t*D + o] = W_t[o, dn + k]
            "we": wn[:, :, dn:].permute(2, 0, 1).reshape(-1, t * d).to(dtype).contiguous(),
            "w_attn": self.attn_net[0].weight.to(dtype).t().contiguous(),
        }

    def forward(self, x, q, cur, pre, sw):
        """One step. x (N, node_in) skip-concatenated nodes; q (E, H) the
        loop-invariant init-edge projection; cur (E, Dc) the edge carry;
        ``pre`` the loop-invariant index columns (with the forward's
        ``gather_plan``, None without a gradient); ``sw`` from
        step_weights. Returns (new nodes (N, D), new edge carry (E, De))."""
        n = x.shape[0]
        dt = q.dtype
        xd = x.to(dt)
        h_node = (xd @ sw["w_target"].t() + sw["b_target"]).contiguous()
        p = (xd @ sw["w_source"].t()).contiguous()
        a = (xd @ sw["w_node"].t()).reshape(n, self.num_types, self.node_dim)
        a = (a + sw["b_node"][None]).contiguous()
        updates, new_edge = fused_mpn_step(
            p, h_node, q, cur.to(dt).contiguous(), a,
            pre["src_local"], pre["src_type"], pre["valid"],
            sw["w_cur"], sw["w_e1"], sw["b_e1"], sw["we"], sw["w_attn"],
            n, self.num_types, pre["nodes_per_image"], plan=pre["gather_plan"],
        )
        return self._update(updates, dt), new_edge

    def split_invariants(self, init_nodes, init_edges, dtype):
        """The loop-invariant halves of the split routes' edge MLP for the
        stack whose initial features are ``init_nodes`` and ``init_edges``:
        (q (E, H), the init-edge projection; init_proj (N, H), the init half
        of the source projection, None for the per-type edge MLP, whose
        node products are per node and type)."""
        dn, dec = self.node_in, self.init_edge_dim
        if isinstance(self.mlp_edge, TypeAwareEdgeUpdate):
            lin = self.mlp_edge.edge_layer
            return init_edges @ lin.weight.to(dtype)[:, :dec].t() + lin.bias.to(dtype), None
        w0 = self.mlp_edge[0].weight.to(dtype)
        q = init_edges @ w0[:, 2 * dn:2 * dn + dec].t()
        return q, init_nodes @ w0[:, dn:dn + (dn - self.node_dim)].t()

    def _edge_mlp(self, x, q, init_proj, cur, pre):
        """The blocked split edge MLP of the JAX package
        (pemp_tpu/models/mpn/layers.py:465-533), in x's dtype: x (N,
        node_in) skip-concatenated nodes; q (E, H) the loop-invariant
        init-edge projection; init_proj (N, H) the loop-invariant init half
        of the source projection; cur (E, De) the edge carry. The source
        half is gathered by ``pre["src"]`` (E,) through
        ops.gather_mm.gather_rows_mm_or_plain with ``pre["n_img"]`` nodes an
        image and the forward's ``pre["gather_plan"]`` (None without a
        gradient). Returns the new edge carry (E, De). The per-type edge MLP
        (:class:`TypeAwareEdgeUpdate`) takes its typed products per node,
        gathers the source's through the same plan, and adds q (its edge
        layer's init half with the bias) to the carry's half."""
        dt = x.dtype
        if isinstance(self.mlp_edge, TypeAwareEdgeUpdate):
            mlp = self.mlp_edge
            r_i, r_j = mlp.node_terms(x, pre)
            r_src = gather_rows_mm_or_plain(r_j, pre["src"], pre["n_img"], pre["gather_plan"])
            e_pre = q + cur @ mlp.edge_layer.weight.to(dt)[:, self.init_edge_dim:].t()
            return mlp.combine(r_i, r_src, e_pre, pre)
        dn, di = self.node_in, self.node_in - self.node_dim
        lin0, lin1 = self.mlp_edge[0], self.mlp_edge[2]
        w0 = lin0.weight.to(dt)
        h_node = x @ w0[:, :dn].t() + lin0.bias.to(dt)                 # (N, H)
        xproj = x[:, di:] @ w0[:, dn + di:2 * dn].t()                   # (N, H)
        src = gather_rows_mm_or_plain(init_proj + xproj, pre["src"], pre["n_img"],
                                      pre["gather_plan"])
        h_edge = src + q + cur @ w0[:, 2 * dn + self.init_edge_dim:].t()
        c = h_edge.shape[0] // x.shape[0]
        h = torch.relu(h_edge + torch.repeat_interleave(h_node, c, dim=0))
        return torch.relu(lin1(h))                                      # (E, De)

    def forward_typed(self, x, q, init_proj, cur, pre):
        """One step of the JAX package's ``pallas`` path (the split edge MLP,
        then pemp_tpu/models/mpn/layers.py:561-614): arguments as
        :meth:`_edge_mlp`, ``pre`` the loop-invariant index columns. In x's
        dtype up to K2 (``ops.typed_message``, float32 in training, bf16 at
        eval), which computes and returns float32. Returns (new nodes (N,
        D), new edge carry (E, De))."""
        n, dt = x.shape[0], x.dtype
        dn = self.node_in
        new_edge = self._edge_mlp(x, q, init_proj, cur, pre)
        wn, bn = self.mlp_node.stacked()              # (T, D, dn + De), (T, D)
        wn, bn = wn.to(dt), bn.to(dt)
        t, d = wn.shape[:2]
        a = torch.einsum("ni,toi->nto", x, wn[:, :, :dn]) + bn[None]
        we = wn[:, :, dn:].permute(2, 0, 1).reshape(-1, t * d)   # we[k, t*D+o]
        updates = fused_typed_message_aggregate(
            new_edge.contiguous(), a.contiguous(), pre["src_type"], pre["valid"],
            we.contiguous(), self.attn_net[0].weight.to(dt).t().contiguous(), n, t)
        return self._update(updates, dt), new_edge

    def forward_hybrid(self, x, q, init_proj, cur, pre):
        """One step of the ``hybrid`` path (pemp_tpu/models/mpn/layers.py:
        580-604): the typed projection by :func:`type_blocked_projection`,
        the logits without their bias (constant within each softmax group),
        then K3 (``ops.attn_aggregate``). In x's dtype up to the aggregate,
        which computes and returns float32. ``pre`` adds ``rev_perm``,
        ``blocks`` (J, K * C) and ``type_sum_map`` to the index columns."""
        n, dt = x.shape[0], x.dtype
        dn = self.node_in
        new_edge = self._edge_mlp(x, q, init_proj, cur, pre)
        wn, bn = self.mlp_node.stacked()
        wn, bn = wn.to(dt), bn.to(dt)
        a = torch.einsum("ni,toi->nto", x, wn[:, :, :dn]) + bn[None]
        b = type_blocked_projection(new_edge, wn[:, :, dn:], pre["rev_perm"], *pre["blocks"],
                                    pre["type_sum_map"])
        logits = (new_edge @ self.attn_net[0].weight.to(dt).t())[:, 0]
        logits = logits.to(torch.promote_types(dt, torch.float32))
        updates = fused_attn_aggregate(b.contiguous(), a.contiguous(), pre["src_type"],
                                       pre["valid"], logits.contiguous(), n, self.num_types)
        return self._update(updates, dt), new_edge

    def forward_einsum(self, x, q, init_proj, cur, pre):
        """One step of the ``einsum`` and ``dots`` paths
        (pemp_tpu/models/mpn/layers.py:627-676): messages by
        :func:`type_aware_split_linear` and ReLU, then
        :meth:`_typed_aggregate` (K4, backward K4b, for the attention
        aggregations), all in x's dtype. On ``einsum`` ``pre`` is as
        :meth:`forward_hybrid`'s; on ``dots`` it has no ``rev_perm`` and the
        projection takes the all-types branch."""
        n, dt = x.shape[0], x.dtype
        new_edge = self._edge_mlp(x, q, init_proj, cur, pre)
        wn, bn = self.mlp_node.stacked()
        m = torch.relu(type_aware_split_linear(
            x, new_edge, pre["src_type"], wn.to(dt), bn.to(dt), pre.get("rev_perm"),
            *pre.get("blocks", (0, 0)), pre.get("type_sum_map"), pre.get("select_plans")))
        return self._update(self._typed_aggregate(m, new_edge, pre, n), dt), new_edge

    def forward_segment(self, x, edges, pre):
        """One step on an edge list (the ``segment`` route): the JAX
        package's unfused layer (pemp_tpu/models/mpn/layers.py:526-545,
        630-676) in x's dtype. x (N, node_in), edges (E, edge_in)
        skip-concatenated; ``pre`` as MPLayer's, with ``src_type`` and
        ``type_order`` (:func:`type_order` of ``src_type``). The edge MLP's
        products with x_i and x_j, and the message's with x_i, are taken per
        node and gathered; the message's edge part is
        :func:`typed_projection`. Returns (new nodes (N, D), new edges)."""
        n, dt = x.shape[0], x.dtype
        dn = self.node_in
        new_edge = new_edges(self.mlp_edge, x, edges, pre)
        wn, bn = self.mlp_node.stacked()                # (T, D, dn + De), (T, D)
        wn, bn = wn.to(dt), bn.to(dt)
        t = self.num_types
        a = torch.einsum("ni,toi->nto", x, wn[:, :, :dn]) + bn[None]
        a_sel = a.reshape(n * t, -1)[pre["dst"] * t + pre["src_type"]]
        m = torch.relu(a_sel + typed_projection(new_edge, wn[:, :, dn:], pre["type_order"]))
        return self._update(self._typed_aggregate(m, new_edge, pre, n), dt), new_edge
