"""Batched, static-shape graph construction (counterpart of
pemp_tpu.graph.constructor), with the training labels of edge label
methods 1-7 when ground truth is given.

Detection (NMS + per-type top-K) gives J*K padded nodes per image, or under
``MODEL.GC.USE_GT`` the GT joints themselves (person-major, padded or cut
to J*K; reference ConstructGraph.py:76-87); the
target-major kNN builder gives C = k + cap_in in-edge slots per node, the
other graphs of ``MODEL.GC.GRAPH_TYPE`` (fully connected, the root-joint
graphs, the per-type top-k graph, kNN among the node features, and the kNN
graph itself with ``TPU.TARGET_MAJOR`` false) an edge list of fixed length
with a validity mask (ops.knn). The per-image graphs are flattened into one
disjoint graph by offsetting node ids (reference:
src/graph_constructor/ConstructGraph.py:221-231), so the MPN runs once over
(B*N, B*E). Edge features are the sets of ``MODEL.GC.EDGE_FEATURES_TO_USE``
the JAX package builds (:func:`_edge_features`).

Labels (reference ConstructGraph.py:577-942): an OKS-style similarity
between every GT joint and every detection, thresholded at the matching
radius, is matched with the auction or the greedy matcher (method 6:
same-type pairs, then cross-type pairs for the rows the first pass left
unmatched); matched detections take their GT row's person and type, an
optional neighbour pass adds the unmatched detections near exactly one
matched GT joint, and an edge is positive when both ends belong to one
person. Methods 1 and 2 (the ``USE_GT`` labels) are one same-type pass at
the node or edge matching radius; method 7 slots the GT joints into the
free padded slots of their type block (reference ConstructGraph.py:88-98
concatenates them) and matches the real detections type-agnostically.

The JAX package's ablations that draw from a graph key (method 7's +-2 px
jitter of the injected joints, image-centric sampling, node dropout) never
act in its trainer, which passes the model no key
(pemp_tpu/train/train_step.py:57-67): method 7 injects without jitter
here, and the training path refuses the other two by name.
``WEIGHT_CLASS_LOSS`` weights the class loss by the GT heatmap at each
node.

Map lookups at a node clamp each index into its axis, as XLA's gather does:
GT joints are clamped to ``max(H, W) - 1`` on both axes, which passes the
shorter one on a map that is not square.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from pemp_tpu_torch.ops.detection import joint_det_from_scoremaps
from pemp_tpu_torch.ops.knn import (
    feature_knn_edges,
    fully_connected_edges,
    knn_edges,
    knn_edges_target_major,
    score_based_edges,
    score_based_per_type_edges,
    top_k_per_type_edges,
)
from pemp_tpu_torch.ops.matching import auction_assignment, greedy_assignment


@dataclasses.dataclass(frozen=True)
class GCConfig:
    """Static graph settings from config.MODEL.GC and the TPU sizing keys.

    Only what the port's paths read. The target-major kNN layout is
    symmetric exactly when ``TPU.MSG_PASS`` is ``hybrid`` or ``einsum``,
    whose reverse-edge permutation needs it
    (pemp_tpu/graph/constructor.py:74-82,104); ``auto`` runs the asymmetric
    layout of ``fused_step`` and ``pallas``.
    """

    num_joints: int = 17
    nodes_per_type: int = 40
    knn_k: int = 50
    knn_cap_in: int = 30
    target_major: bool = True   # the kNN graph in blocks of C in-edge slots
    graph_type: str = "knn"
    pool_kernel: int = 3
    detect_threshold: float | None = 0.1
    hybrid_k: int = 5
    edge_features: tuple = ("position", "connection_type")
    norm_node_distance: bool = False
    mask_crowds: bool = True
    edge_label_method: int = 6
    matching_radius: float = 0.5
    inclusion_radius: float = 0.75
    node_matching_radius: float = 0.5
    node_inclusion_radius: float = 0.7
    use_neighbours: bool = False
    matcher: str = "auction"   # auction | greedy
    knn_symmetric: bool = False
    use_gt: bool = False
    weight_class_loss: bool = False
    with_background: bool = False

    @classmethod
    def from_config(cls, config) -> "GCConfig":
        gc = config.MODEL.GC
        cap_in = config.TPU.KNN_CAP_IN
        return cls(
            num_joints=config.DATASET.NUM_JOINTS,
            nodes_per_type=config.TPU.NODES_PER_TYPE,
            knn_k=config.TPU.KNN_K,
            knn_cap_in=cap_in if cap_in > 0 else config.TPU.KNN_K,
            target_major=bool(config.TPU.TARGET_MAJOR),
            graph_type=gc.GRAPH_TYPE,
            pool_kernel=gc.POOL_KERNEL_SIZE,
            detect_threshold=gc.DETECT_THRESHOLD if gc.DETECT_THRESHOLD <= 1.5 else None,
            hybrid_k=gc.HYBRID_K,
            edge_features=tuple(gc.EDGE_FEATURES_TO_USE),
            norm_node_distance=gc.NORM_NODE_DISTANCE,
            mask_crowds=gc.MASK_CROWDS,
            edge_label_method=gc.EDGE_LABEL_METHOD,
            matching_radius=gc.MATCHING_RADIUS,
            inclusion_radius=gc.INCLUSION_RADIUS,
            node_matching_radius=gc.NODE_MATCHING_RADIUS,
            node_inclusion_radius=gc.NODE_INCLUSION_RADIUS,
            use_neighbours=gc.USE_NEIGHBOURS,
            matcher="greedy" if config.TPU.MATCHER == "greedy" else "auction",
            knn_symmetric=config.TPU.MSG_PASS in ("hybrid", "einsum"),
            use_gt=gc.USE_GT,
            weight_class_loss=gc.WEIGHT_CLASS_LOSS,
            with_background=gc.WITH_BACKGROUND,
        )

    @property
    def blocked(self) -> bool:
        """Whether the edges come in target-major blocks (the kNN graph
        with ``target_major``); every other graph is an edge list."""
        return self.graph_type == "knn" and self.target_major

    @property
    def slots(self) -> int:
        """C: in-edge slots per node of the blocked layout (mirrors the
        builder's k clamp)."""
        n = self.num_joints * self.nodes_per_type
        return min(self.knn_k, max(n - 1, 1)) + self.knn_cap_in

    @property
    def blocked_c(self) -> int:
        """C on the blocked layout, 0 on an edge list: the decode's and the
        MPN's layout argument (pemp_tpu/tta/multi_scale.py:66-78)."""
        return self.slots if self.blocked else 0


@dataclasses.dataclass
class GraphBatch:
    """Flattened batch graph. Shapes: N* = B*J*K, E* = B*E (E = N*C on the
    blocked layout)."""

    x: Any                 # (N*, F) node features
    edge_attr: Any         # (E*, width of the edge-feature set)
    edge_index: Any        # (2, E*) into flattened node ids
    joint_det: Any         # (N*, 3) x, y, type
    joint_scores: Any      # (N*,)
    joint_tags: Any        # (N*,) or (N*, S)
    batch_index: Any       # (N*,)
    node_valid: Any        # (N*,) bool
    edge_valid: Any        # (E*,) bool
    edge_src_local: Any    # (E*,) source index WITHIN its image
    # training labels (None without ground truth)
    edge_labels: Any = None      # (E*,)
    node_labels: Any = None      # (N*,)
    node_classes: Any = None     # (N*,)
    node_persons: Any = None     # (N*,)
    label_mask: Any = None       # (E*,)
    label_mask_node: Any = None  # (N*,)
    class_mask: Any = None       # (N*,)


def _build_edges(cfg: GCConfig, det, valid, scores, node_feats):
    """The graph ``cfg.graph_type`` names, per image
    (pemp_tpu/graph/constructor.py:143-170): det (B, N, 3), valid and
    scores (B, N), node_feats (B, N, F) the node features (``feature_knn``
    reads them). Returns edge_index (B, 2, E) and edge_valid (B, E)."""
    pos = det[..., :2].float()
    kind = cfg.graph_type
    if kind == "knn":
        if cfg.target_major:
            return knn_edges_target_major(pos, valid, cfg.knn_k, cfg.knn_cap_in,
                                          cfg.knn_symmetric)
        return knn_edges(pos, valid, cfg.knn_k)
    if kind == "fully":
        return fully_connected_edges(valid)
    if kind == "feature_knn":
        return feature_knn_edges(node_feats, valid, cfg.knn_k)
    if kind == "topk":
        return top_k_per_type_edges(pos, valid, det[..., 2], cfg.num_joints, 10)
    if kind == "score_based":
        return score_based_edges(pos, valid, scores, 75)
    if kind == "score_based_per_type":
        return score_based_per_type_edges(pos, valid, det[..., 2], scores, cfg.num_joints, 2,
                                          cfg.nodes_per_type)
    raise NotImplementedError(f"MODEL.GC.GRAPH_TYPE={kind!r}")


# the edge-feature sets of the JAX package (pemp_tpu/graph/constructor.py:
# 237-268), each as the columns it concatenates, in order
_FEATURE_SETS = {
    frozenset({"position", "connection_type"}): ("dx", "dy", "conn"),
    frozenset({"connection_type"}): ("conn",),
    frozenset({"position"}): ("dx", "dy"),
    frozenset({"nothing"}): ("zero",),
    frozenset({"position", "angle", "connection_type"}): ("dx", "dy", "theta", "conn"),
    frozenset({"ae"}): ("tag_dist",),
    frozenset({"ae_normed"}): ("ae_normed",),
    frozenset({"ae_tracking_1"}): ("ae_tracking",),
    frozenset({"position", "connection_type", "ae_normed"}): ("dx", "dy", "conn", "tag_dist"),
}


def _edge_features(cfg: GCConfig, det, scores, tags, edge_index, hw):
    """The edge features ``cfg.edge_features`` names, on the flat graph
    (reference: ConstructGraph.py:288-359; pemp_tpu/graph/constructor.py:
    173-269): position offsets, the connection-type hot vector, the angle
    of the offset, and the tag distance (the norm over the tag channels,
    several under flip), alone or as the JAX package combines them
    (:data:`_FEATURE_SETS`), or a zero column for ``nothing``.

    det (N*, 3), scores (N*,), tags (N*,) or (N*, S), edge_index (2, E*).
    Types are index arithmetic on the type-blocked layout of detections
    (type(n) == (n // K) mod J), and the nodes' own under ``use_gt``
    (person-major GT joints). On the blocked layout the target of slot s is
    s // C, so its row is a repeat; on an edge list a gather. ``ae_normed``
    alone is the rounded tag distance times 100 less the source's score.
    """
    feats = frozenset(cfg.edge_features)
    if feats not in _FEATURE_SETS:
        raise NotImplementedError(f"MODEL.GC.EDGE_FEATURES_TO_USE={list(cfg.edge_features)}")
    src, dst = edge_index[0].long(), edge_index[1].long()
    e = src.shape[0]
    columns = _FEATURE_SETS[feats]
    if columns == ("zero",):
        return torch.zeros((e, 1), dtype=torch.float32, device=det.device)

    def at_dst(x):
        if cfg.blocked:
            return torch.repeat_interleave(x, e // x.shape[0], dim=0)
        return x[dst]

    cols = {}
    norm = float(max(hw)) if cfg.norm_node_distance else 1.0
    row = det[:, :2].float()
    rs, rd = row[src], at_dst(row)
    cols["dx"] = (rd[:, 0] - rs[:, 0]) / norm
    cols["dy"] = (rd[:, 1] - rs[:, 1]) / norm
    if "theta" in columns:
        ax, ay = rs[:, 0] - rd[:, 0], rs[:, 1] - rd[:, 1]
        denom = torch.sqrt(ax * ax + ay * ay)
        cos = torch.where(denom > 0, ax / torch.clamp(denom, min=1e-12), torch.ones_like(ax))
        cols["theta"] = torch.where(denom > 0, torch.abs(torch.arccos(cos)),
                                    torch.zeros_like(ax))
    if "conn" in columns:
        j = cfg.num_joints
        if cfg.use_gt:
            types = det[:, 2].long()
            ts, td = types[src], at_dst(types)
        else:
            ts, td = (src // cfg.nodes_per_type) % j, (dst // cfg.nodes_per_type) % j
        # a same-type edge keeps a single hot at its type (the reference
        # sets the same position twice)
        cols["conn"] = torch.clamp(F.one_hot(ts, j).float() + F.one_hot(td, j).float(), 0.0, 1.0)
    if {"tag_dist", "ae_normed", "ae_tracking"} & set(columns):
        t2 = (tags if tags.dim() == 2 else tags[:, None]).float()
        diff = at_dst(t2) - t2[src]
        # the square root in float64, rounded once: with two tag channels
        # (flip) a float32 root differs from XLA's in the last place on
        # ~0.7 % of pairs, the float64 one on ~5e-6 of them (200,000 drawn
        # pairs on the CPU), and ae_normed rounds the distance
        dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0).double()).float()
        cols["tag_dist"] = dist
        cols["ae_normed"] = torch.round(dist) * 100.0 - scores.float()[src]
        cols["ae_tracking"] = (1.8425 - dist) / 1.8425
    return torch.cat([cols[c] if cols[c].dim() == 2 else cols[c][:, None] for c in columns],
                     dim=-1)


def _similarity(det, det_valid, joints_gt, factors, hw):
    """OKS-style similarity between every GT joint (rows: person-major
    (person, joint) entries) and every detection, per image.

    det (B, N, 3), det_valid (B, N), joints_gt (B, P, J, 3), factors
    (B, P, J). reference: ConstructGraph.py:775-782.
    """
    b, p, j = joints_gt.shape[:3]
    gt = joints_gt.reshape(b, p * j, 3).float()
    gt_valid = gt[..., 2] > 0
    fac = factors.reshape(b, p * j).float()
    gt_type = torch.arange(j, device=det.device).repeat(p)
    gt_person = torch.arange(p, device=det.device).repeat_interleave(j)
    gt_xy = torch.clamp(torch.round(gt[..., :2]), 0, float(max(hw)))
    diff = gt_xy[:, :, None, :] - det[:, None, :, :2].float()
    d2 = torch.sum(diff ** 2, dim=-1)
    # exp in float64, rounded once to float32: the same bits on the CPU and
    # on the card (their float32 exp differ in the last place, and the
    # agnostic matching of method 7 turns on such near-ties), and closer to
    # XLA's float32 exp than torch's own
    sim = torch.exp((-d2 / torch.clamp(fac[:, :, None], min=1e-12)).double()).float()
    sim = torch.where(gt_valid[:, :, None] & det_valid[:, None, :], sim, torch.zeros_like(sim))
    same_type = gt_type[None, :, None] == det[:, None, :, 2]
    return sim, same_type, gt_valid, gt_person, gt_type


def _labels_from_matching(num_det, col_of_row, row_valid, gt_person, gt_type):
    """Scatter matched GT attributes onto detections, per image. Where two
    rows claim one detection the largest row index wins, as the
    reference's ordered index_put (ConstructGraph.py:929-940)."""
    b, r = col_of_row.shape
    matched = row_valid & (col_of_row >= 0)
    row_ids = torch.arange(r, device=col_of_row.device).expand(b, r)
    tgt = torch.where(matched, col_of_row, torch.full_like(col_of_row, num_det))
    winner = torch.full((b, num_det + 1), -1, dtype=torch.int64, device=col_of_row.device)
    winner = winner.scatter_reduce(1, tgt, torch.where(matched, row_ids, -1), "amax",
                                   include_self=True)[:, :num_det]
    has = winner >= 0
    w = torch.clamp(winner, 0, r - 1)
    node_labels = has.float()
    node_persons = torch.where(has, gt_person[w], -1).to(torch.int32)
    node_classes = torch.where(has, gt_type[w], 0).to(torch.int32)
    return node_labels, node_persons, node_classes


def _assign(cfg: GCConfig, sims):
    """Column of each row for the problems ``sims (P, R, C)``, by the
    configured matcher."""
    if cfg.matcher == "greedy":
        return greedy_assignment(sims)
    return auction_assignment(sims)


def _neighbour_pass(sim, col, matched_row, gt_person, gt_type, inclusion_radius,
                    node_labels, node_persons, node_classes):
    """Second pass, per image: an unmatched detection within
    ``inclusion_radius`` of exactly one matched GT row joins its person;
    one claimed by several rows is ambiguous. reference:
    ConstructGraph.py:883-912. Returns the labels and ``ambiguous (B, N)``."""
    b, r, n = sim.shape
    zero = torch.zeros_like(sim)
    cost = torch.where(sim < inclusion_radius, zero, sim)
    # the columns pass 1 chose are taken
    chosen = torch.zeros((b, n + 1), dtype=torch.bool, device=sim.device)
    chosen.scatter_(1, torch.where(col >= 0, col, torch.full_like(col, n)), True)
    cost = torch.where(chosen[:, None, :n], zero, cost)
    # ambiguity counts the claims of ALL GT rows, also those pass 1 left
    # unmatched; only the claiming itself is restricted to matched rows
    # (reference order: ConstructGraph.py:886-899 before :900-903)
    ambiguous = (cost > 0).sum(dim=1) > 1
    cost = torch.where(ambiguous[:, None, :] | ~matched_row[:, :, None], zero, cost)
    claimed = (cost > 0).any(dim=1)
    claim_row = cost.argmax(dim=1)          # the one claimant where claimed
    node_labels = torch.where(claimed, 1.0, node_labels)
    node_persons = torch.where(claimed, gt_person[claim_row].to(torch.int32), node_persons)
    node_classes = torch.where(claimed, gt_type[claim_row].to(torch.int32), node_classes)
    return node_labels, node_persons, node_classes, ambiguous


def _construct_labels(cfg: GCConfig, det, det_valid, edge_index, joints_gt, factors, hw,
                      injected=None):
    """Edge label methods 1-7 for the images of a batch at once
    (pemp_tpu.graph.constructor._construct_labels); edge_index (B, 2, E)
    holds per-image node ids. Returns per-image labels and masks.

    Method 6 (semi-agnostic two-pass, reference method==2 branch,
    ConstructGraph.py:807-829): same-type pairs, then cross-type pairs for
    the rows the first pass left unmatched; the neighbour pass under
    ``use_neighbours``, whose ambiguous detections leave the node, class
    and edge losses. Methods 3, 4 and 5: one same-type pass (5 at the node
    matching radius), the neighbour pass, the edge loss only between
    label-positive nodes (3), and nodes whose best same-type similarity
    lies in [0.1, 0.8] out of the node loss (5). Methods 1 and 2: one
    same-type pass at the node (1) or edge (2) matching radius, the edge
    loss only in an image with two GT joints or more. Method 7: one
    type-agnostic pass over the real detections; ``injected`` (mask,
    person, class), each (B, N), labels the injected GT slots with their own
    person and class (None: no slot is injected).
    """
    b, n = det.shape[:2]
    method = cfg.edge_label_method
    if method not in range(1, 8):
        raise NotImplementedError(f"MODEL.GC.EDGE_LABEL_METHOD={method}")
    sim, same_type, gt_valid, gt_person, gt_type = _similarity(
        det, det_valid, joints_gt, factors, hw)
    zero = torch.zeros_like(sim)

    def cut(s, radius):
        return torch.where(s < radius, zero, s)

    sim_same = torch.where(same_type, sim, zero)
    radius, inclusion = cfg.matching_radius, cfg.inclusion_radius
    if method == 6:
        sim_diff = torch.where(same_type, zero, sim)
        sims = torch.cat([sim_same, sim_diff], dim=0)
        # both passes of every image in one batched matching
        cols = _assign(cfg, torch.where(sims < radius, torch.zeros_like(sims), sims))
        col = torch.where(cols[:b] >= 0, cols[:b], cols[b:])
        matched_row = gt_valid & (col >= 0)
        col = torch.where(matched_row, col, torch.full_like(col, -1))
    elif method == 7:
        # the real detections only; the injected slots carry their GT
        if injected is not None:
            cut_sim = torch.where(injected[0][:, None, :], zero, cut(sim, radius))
        else:
            cut_sim = cut(sim, radius)
        col = _assign(cfg, cut_sim)
    else:
        if method in (1, 5):
            radius, inclusion = cfg.node_matching_radius, cfg.node_inclusion_radius
        col = _assign(cfg, cut(sim_same, radius))
        matched_row = gt_valid & (col >= 0)

    node_labels, node_persons, node_classes = _labels_from_matching(
        n, col, gt_valid, gt_person, gt_type)
    if method == 7 and injected is not None:
        mask, person, cls = injected
        node_labels = torch.where(mask, 1.0, node_labels)
        node_persons = torch.where(mask, person, node_persons)
        node_classes = torch.where(mask, cls, node_classes)
    ambiguous = torch.zeros_like(det_valid)
    if cfg.use_neighbours and method in (3, 4, 5, 6):
        node_labels, node_persons, node_classes, ambiguous = _neighbour_pass(
            sim, col, matched_row, gt_person, gt_type, inclusion,
            node_labels, node_persons, node_classes)
    src, dst = edge_index[:, 0].long(), edge_index[:, 1].long()
    ps, pd = torch.gather(node_persons, 1, src), torch.gather(node_persons, 1, dst)
    edge_labels = ((ps >= 0) & (ps == pd)).float()
    # reference create_loss_mask (ConstructGraph.py:1136-1158), and no edge
    # loss in an image without a positive edge
    bad = torch.gather(ambiguous, 1, src) | torch.gather(ambiguous, 1, dst)
    any_pos = edge_labels.amax(dim=1, keepdim=True) > 0
    if method in (1, 2):
        any_pos = any_pos & (gt_valid.sum(dim=1, keepdim=True) >= 2)
    label_mask = (~bad & any_pos).float()
    node_mask = (~ambiguous).float()
    if method == 3:
        # the edge loss only on the GT-node subgraph (ConstructGraph.py:619)
        on_gt = (torch.gather(node_labels, 1, src) == 1.0) & (torch.gather(node_labels, 1, dst) == 1.0)
        label_mask = label_mask * on_gt.float()
    if method == 6:
        class_mask = node_labels * node_mask
        if cfg.with_background:
            # the background class J for every node not labelled positive,
            # and the class loss over all nodes
            # (pemp_tpu/graph/constructor.py:482-486)
            node_classes = torch.where(node_labels != 1.0,
                                       torch.full_like(node_classes, cfg.num_joints), node_classes)
            class_mask = torch.ones_like(node_labels)
        return dict(edge_labels=edge_labels, node_labels=node_labels,
                    node_classes=node_classes, node_persons=node_persons,
                    label_mask=label_mask, label_mask_node=node_mask,
                    class_mask=class_mask)
    label_mask_node = torch.ones_like(node_labels)
    if method == 5:
        best = sim_same.amax(dim=1)
        has_gt = gt_valid.any(dim=1, keepdim=True)
        label_mask_node = torch.where((best >= 0.1) & (best <= 0.8) & has_gt, 0.0, 1.0)
    return dict(edge_labels=edge_labels, node_labels=node_labels, node_classes=node_classes,
                node_persons=node_persons, label_mask=label_mask,
                label_mask_node=label_mask_node, class_mask=node_labels)


def _gt_grid(b, p, j, device):
    """(type, person) of each person-major GT row (B, P*J), int32."""
    types = torch.arange(j, dtype=torch.int32, device=device).repeat(p)
    persons = torch.arange(p, dtype=torch.int32, device=device).repeat_interleave(j)
    return types.expand(b, p * j), persons.expand(b, p * j)


def _gt_as_detections(joints_gt, hw, n):
    """``USE_GT``: the GT joints (B, P, J, 3) as the node set
    (pemp_tpu/graph/constructor.py:715-733): P*J person-major nodes,
    rounded and clamped to ``max(H, W) - 1`` on both axes, score 1 where
    visible, zero-padded (type 0, invalid) or cut to ``n``. Returns det
    (B, n, 3) int32, scores (B, n), valid (B, n)."""
    b, p, j = joints_gt.shape[:3]
    gt = joints_gt.reshape(b, p * j, 3).float()
    valid = gt[..., 2] > 0
    xy = torch.clamp(torch.round(gt[..., :2]), 0, max(hw) - 1).to(torch.int32)
    types, _ = _gt_grid(b, p, j, gt.device)
    det = torch.cat([xy, types[..., None]], dim=-1)
    scores = valid.float()
    m = p * j
    if m < n:
        det = torch.cat([det, det.new_zeros((b, n - m, 3))], dim=1)
        scores = torch.cat([scores, scores.new_zeros((b, n - m))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((b, n - m))], dim=1)
    return det[:, :n], scores[:, :n], valid[:, :n]


def _inject_gt_detections(cfg: GCConfig, det, scores, valid, sm, joints_gt):
    """Method 7's GT injection (pemp_tpu/graph/constructor.py:736-800, with
    no key: no jitter): each visible GT joint of type t, rounded and
    clamped to ``max(H, W) - 1``, takes the next free
    padded slot of type block t, in GT order (a stable sort by type and
    the rank within the type); the joints a full block has no slot for are
    dropped. Injected slots become valid with the score map's value at
    their position. sm (B, J, H, W). Returns det, scores, valid and
    ``(mask, person, class)`` of the injected slots, each (B, N)."""
    b, j, h, w = sm.shape
    k = cfg.nodes_per_type
    p = joints_gt.shape[1]
    m, nslots = p * j, j * k
    dev = det.device
    gt = joints_gt.reshape(b, m, 3).float()
    gt_valid = gt[..., 2] > 0
    gt_type, gt_person = _gt_grid(b, p, j, dev)
    xy = torch.clamp(torch.round(gt[..., :2]).to(torch.int32), 0, max(h, w) - 1)

    # rank of each GT row within its type, among the visible rows
    key = torch.where(gt_valid, gt_type, j).long()
    order = torch.argsort(key, dim=1, stable=True)
    t_sorted = torch.gather(key, 1, order)
    counts = torch.zeros((b, j + 1), dtype=torch.long, device=dev).scatter_add_(
        1, t_sorted, torch.ones_like(t_sorted))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(m, device=dev) - torch.gather(starts, 1, t_sorted)
    # the free slots of each type block, in slot order
    vb = valid.reshape(b, j, k)
    free_order = torch.argsort(vb.to(torch.int8), dim=2, stable=True)
    n_free = (~vb).sum(dim=2)
    t_safe = t_sorted.clamp(0, j - 1)
    slot = free_order.reshape(b, nslots).gather(1, t_safe * k + rank.clamp(0, k - 1))
    ok = (t_sorted < j) & (rank < torch.gather(n_free, 1, t_safe)) & (rank < k)
    # JAX's mode="drop" scatters: the rows with no slot go to a spare one
    dest = torch.where(ok, t_safe * k + slot, nslots)
    xy_sorted = torch.gather(xy, 1, order[..., None].expand(b, m, 2))
    person_sorted = torch.gather(gt_person, 1, order)
    spare = torch.cat([det, det.new_zeros((b, 1, 3))], dim=1)
    for axis in (0, 1):
        spare[..., axis].scatter_(1, dest, torch.where(ok, xy_sorted[..., axis], 0))
    det_new = spare[:, :nslots]
    inj = torch.zeros((b, nslots + 1), dtype=torch.bool, device=dev).scatter_(1, dest, ok)[:, :nslots]
    inj_person = torch.full((b, nslots + 1), -1, dtype=torch.int32, device=dev).scatter_(
        1, dest, torch.where(ok, person_sorted, -1))[:, :nslots]
    sc_at = _at(sm.permute(0, 2, 3, 1), det_new, types=True)
    return (det_new, torch.where(inj, sc_at, scores), valid | inj,
            (inj, inj_person, det_new[..., 2].to(torch.int32)))


def _at(maps, det, types=False):
    """``maps`` (B, H, W, ...) at each node of det (B, N, 3), and with
    ``types`` at its type's channel: each index clamped into its axis, as
    XLA clamps a gather (the GT joints may pass the shorter axis)."""
    b, h, w = maps.shape[:3]
    bi = torch.arange(b, device=det.device)[:, None]
    ys = det[..., 1].long().clamp(0, h - 1)
    xs = det[..., 0].long().clamp(0, w - 1)
    if types:
        return maps[bi, ys, xs, det[..., 2].long().clamp(0, maps.shape[3] - 1)]
    return maps[bi, ys, xs]


def construct_graph_batch(cfg: GCConfig, scoremaps, features, tagmaps, masks=None,
                          joints_gt=None, factors=None, testing: bool = False,
                          gt_heatmaps=None):
    """Graph construction, with training labels when ``joints_gt`` is given.

    scoremaps (B, H, W, J), features (B, H, W, F), tagmaps (B, H, W, J) or
    (B, H, W, J, S) with test-time augmentation's S tag channels (original
    and flipped), masks (B, H, W) crowd masks (or the canvas's valid region
    at test time) or None, joints_gt (B, P, J, 3) GT joints in
    map coordinates, factors (B, P, J) their OKS factors. Under
    ``use_gt`` the GT joints are the nodes. ``testing`` (the JAX package's
    eval mode) turns off method 7's injection.
    ``gt_heatmaps`` (B, h, w, J), the last scale's GT heatmaps, weight the
    class loss under ``weight_class_loss``. Returns the flattened
    GraphBatch.
    """
    b, h, w, j = scoremaps.shape
    n = j * cfg.nodes_per_type
    sm = scoremaps.permute(0, 3, 1, 2)
    det, scores, valid = joint_det_from_scoremaps(
        sm, cfg.nodes_per_type, cfg.detect_threshold,
        cfg.pool_kernel, mask=masks if cfg.mask_crowds else None,
        hybrid_k=cfg.hybrid_k,
    )
    dev = det.device
    training = joints_gt is not None and not testing
    if cfg.use_gt and joints_gt is not None:
        # reference: ConstructGraph.py:76-87
        det, scores, valid = _gt_as_detections(joints_gt, (h, w), n)
    injected = None
    if cfg.edge_label_method == 7 and training and not cfg.use_gt:
        det, scores, valid, injected = _inject_gt_detections(
            cfg, det, scores, valid, sm, joints_gt)
    node_feats = _at(features, det)                         # (B, N, F)
    tags_at = _at(tagmaps, det, types=True)                 # (B, N[, S])
    ei, ev = _build_edges(cfg, det, valid, scores, node_feats)   # (B, 2, E), (B, E)
    labels = None
    if joints_gt is not None:
        labels = _construct_labels(cfg, det, valid, ei, joints_gt, factors, (h, w), injected)
    e = ei.shape[-1]
    offsets = (torch.arange(b, dtype=torch.int32, device=dev) * n)[:, None, None]
    edge_index = (ei + offsets).transpose(0, 1).reshape(2, b * e)
    det_flat = det.reshape(b * n, 3)
    gb = GraphBatch(
        x=node_feats.reshape(b * n, -1),
        edge_attr=_edge_features(cfg, det_flat, scores.reshape(b * n),
                                 tags_at.reshape(b * n, *tags_at.shape[2:]), edge_index, (h, w)),
        edge_index=edge_index,
        joint_det=det_flat,
        joint_scores=scores.reshape(b * n),
        joint_tags=tags_at.reshape(b * n, *tags_at.shape[2:]),
        batch_index=torch.arange(b, device=dev).repeat_interleave(n),
        node_valid=valid.reshape(b * n),
        edge_valid=ev.reshape(b * e),
        edge_src_local=ei[:, 0].reshape(b * e),
    )
    if labels is None:
        return gb
    for name, value in labels.items():
        setattr(gb, name, value.reshape(-1))
    if cfg.weight_class_loss and gt_heatmaps is not None:
        # the GT heatmap at each node's class, at least 0.1
        # (reference: ConstructGraph.py:171-176)
        cls = gb.node_classes.long().clamp(0, cfg.num_joints - 1)
        hh, ww = gt_heatmaps.shape[1:3]
        yy = det_flat[:, 1].long().clamp(0, hh - 1)
        xx = det_flat[:, 0].long().clamp(0, ww - 1)
        weights = gt_heatmaps[gb.batch_index, yy, xx, cls].float()
        gb.class_mask = gb.class_mask * torch.clamp(weights, min=0.1)
    return gb
