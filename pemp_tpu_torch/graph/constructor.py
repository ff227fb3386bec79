"""Batched, static-shape graph construction (counterpart of
pemp_tpu.graph.constructor), with the training labels of edge label
methods 3-6 when ground truth is given.

Detection (NMS + per-type top-K) gives J*K padded nodes per image; the
target-major kNN builder gives C = k + cap_in in-edge slots per node, the
other graphs of ``MODEL.GC.GRAPH_TYPE`` (fully connected, the root-joint
graphs) an edge list of fixed length with a validity mask (ops.knn). The
per-image graphs are flattened into one disjoint graph by offsetting node
ids (reference: src/graph_constructor/ConstructGraph.py:221-231), so the MPN
runs once over (B*N, B*E). Edge features are the sets of
``MODEL.GC.EDGE_FEATURES_TO_USE`` that the files of configs/ use:
position and connection type together or alone, or nothing.

Labels (reference ConstructGraph.py:577-942): an OKS-style similarity
between every GT joint and every detection, thresholded at the matching
radius, is matched with the auction or the greedy matcher (method 6:
same-type pairs, then cross-type pairs for the rows the first pass left
unmatched); matched detections take their GT row's person and type, an
optional neighbour pass adds the unmatched detections near exactly one
matched GT joint, and an edge is positive when both ends belong to one
person. Methods 1, 2 and 7 (GT joints as or among the detections) are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from pemp_tpu_torch.ops.detection import joint_det_from_scoremaps
from pemp_tpu_torch.ops.knn import (
    fully_connected_edges,
    knn_edges_target_major,
    score_based_edges,
    score_based_per_type_edges,
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

    @classmethod
    def from_config(cls, config) -> "GCConfig":
        # the config fixes graphs on detections (config.defaults.FIXED)
        gc = config.MODEL.GC
        cap_in = config.TPU.KNN_CAP_IN
        return cls(
            num_joints=config.DATASET.NUM_JOINTS,
            nodes_per_type=config.TPU.NODES_PER_TYPE,
            knn_k=config.TPU.KNN_K,
            knn_cap_in=cap_in if cap_in > 0 else config.TPU.KNN_K,
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
        )

    @property
    def blocked(self) -> bool:
        """Whether the edges come in target-major blocks (the kNN graph);
        every other graph is an edge list."""
        return self.graph_type == "knn"

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


def _build_edges(cfg: GCConfig, det, valid, scores):
    """The graph ``cfg.graph_type`` names, per image
    (pemp_tpu/graph/constructor.py:143-170): det (B, N, 3), valid and
    scores (B, N). Returns edge_index (B, 2, E) and edge_valid (B, E)."""
    pos = det[..., :2].float()
    kind = cfg.graph_type
    if kind == "knn":
        return knn_edges_target_major(pos, valid, cfg.knn_k, cfg.knn_cap_in, cfg.knn_symmetric)
    if kind == "fully":
        return fully_connected_edges(valid)
    if kind == "score_based":
        return score_based_edges(pos, valid, scores, 75)
    if kind == "score_based_per_type":
        return score_based_per_type_edges(pos, valid, det[..., 2], scores, cfg.num_joints, 2,
                                          cfg.nodes_per_type)
    raise NotImplementedError(f"MODEL.GC.GRAPH_TYPE={kind!r}")


def _edge_features(cfg: GCConfig, det, edge_index, hw):
    """The edge features ``cfg.edge_features`` names, on the flat graph:
    position offsets and the connection-type hot vector, either alone, or a
    zero column for ``nothing``.

    reference: ConstructGraph.py:288-359 (pemp_tpu/graph/constructor.py:
    173-269). det (N*, 3), edge_index (2, E*). Types are index arithmetic
    on the type-blocked layout (type(n) == (n // K) mod J). On the blocked
    layout the target of slot s is s // C, so its row is a repeat; on an
    edge list a gather. The angle and tag-distance sets wait for a
    configuration that uses them.
    """
    feats = set(cfg.edge_features)
    src, dst = edge_index[0].long(), edge_index[1].long()
    e = src.shape[0]
    if feats == {"nothing"}:
        return torch.zeros((e, 1), dtype=torch.float32, device=det.device)
    if not feats or not feats <= {"position", "connection_type"}:
        raise NotImplementedError(f"MODEL.GC.EDGE_FEATURES_TO_USE={list(cfg.edge_features)}")
    norm = float(max(hw)) if cfg.norm_node_distance else 1.0
    j = cfg.num_joints
    row = det[:, :2].float()
    rs = row[src]
    if cfg.blocked:
        rd = torch.repeat_interleave(row, e // row.shape[0], dim=0)
    else:
        rd = row[dst]
    dx = (rd[:, 0] - rs[:, 0]) / norm
    dy = (rd[:, 1] - rs[:, 1]) / norm
    hot_s = F.one_hot((src // cfg.nodes_per_type) % j, j).float()
    hot_d = F.one_hot((dst // cfg.nodes_per_type) % j, j).float()
    # a same-type edge keeps a single hot at its type (the reference sets
    # the same position twice)
    conn = torch.clamp(hot_s + hot_d, 0.0, 1.0)
    parts = {"position": [dx[:, None], dy[:, None]], "connection_type": [conn]}
    return torch.cat([p for name in ("position", "connection_type") if name in feats
                      for p in parts[name]], dim=-1)


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
    sim = torch.exp(-d2 / torch.clamp(fac[:, :, None], min=1e-12))
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


def _construct_labels(cfg: GCConfig, det, det_valid, edge_index, joints_gt, factors, hw):
    """Edge label methods 3-6 for the images of a batch at once
    (pemp_tpu.graph.constructor._construct_labels); edge_index (B, 2, E)
    holds per-image node ids. Returns per-image labels and masks.

    Method 6 (semi-agnostic two-pass, reference method==2 branch,
    ConstructGraph.py:807-829): same-type pairs, then cross-type pairs for
    the rows the first pass left unmatched; the neighbour pass under
    ``use_neighbours``, whose ambiguous detections leave the node, class
    and edge losses. Methods 3, 4 and 5: one same-type pass (5 at the node
    matching radius), the neighbour pass, the edge loss only between
    label-positive nodes (3), and nodes whose best same-type similarity
    lies in [0.1, 0.8] out of the node loss (5).
    """
    b, n = det.shape[:2]
    method = cfg.edge_label_method
    if method not in (3, 4, 5, 6):
        raise NotImplementedError(f"MODEL.GC.EDGE_LABEL_METHOD={method}")
    sim, same_type, gt_valid, gt_person, gt_type = _similarity(
        det, det_valid, joints_gt, factors, hw)
    zero = torch.zeros_like(sim)
    sim_same = torch.where(same_type, sim, zero)
    if method == 6:
        radius, inclusion = cfg.matching_radius, cfg.inclusion_radius
        sim_diff = torch.where(same_type, zero, sim)
        sims = torch.cat([sim_same, sim_diff], dim=0)
        # both passes of every image in one batched matching
        cols = _assign(cfg, torch.where(sims < radius, torch.zeros_like(sims), sims))
        col = torch.where(cols[:b] >= 0, cols[:b], cols[b:])
        matched_row = gt_valid & (col >= 0)
        col = torch.where(matched_row, col, torch.full_like(col, -1))
    else:
        five = method == 5
        radius = cfg.node_matching_radius if five else cfg.matching_radius
        inclusion = cfg.node_inclusion_radius if five else cfg.inclusion_radius
        col = _assign(cfg, torch.where(sim_same < radius, zero, sim_same))
        matched_row = gt_valid & (col >= 0)

    node_labels, node_persons, node_classes = _labels_from_matching(
        n, col, gt_valid, gt_person, gt_type)
    ambiguous = torch.zeros_like(det_valid)
    if cfg.use_neighbours:
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
    label_mask = (~bad & any_pos).float()
    node_mask = (~ambiguous).float()
    if method == 3:
        # the edge loss only on the GT-node subgraph (ConstructGraph.py:619)
        on_gt = (torch.gather(node_labels, 1, src) == 1.0) & (torch.gather(node_labels, 1, dst) == 1.0)
        label_mask = label_mask * on_gt.float()
    if method == 6:
        return dict(edge_labels=edge_labels, node_labels=node_labels,
                    node_classes=node_classes, node_persons=node_persons,
                    label_mask=label_mask, label_mask_node=node_mask,
                    class_mask=node_labels * node_mask)
    label_mask_node = torch.ones_like(node_labels)
    if method == 5:
        best = sim_same.amax(dim=1)
        has_gt = gt_valid.any(dim=1, keepdim=True)
        label_mask_node = torch.where((best >= 0.1) & (best <= 0.8) & has_gt, 0.0, 1.0)
    return dict(edge_labels=edge_labels, node_labels=node_labels, node_classes=node_classes,
                node_persons=node_persons, label_mask=label_mask,
                label_mask_node=label_mask_node, class_mask=node_labels)


def construct_graph_batch(cfg: GCConfig, scoremaps, features, tagmaps, masks=None,
                          joints_gt=None, factors=None):
    """Graph construction, with training labels when ``joints_gt`` is given.

    scoremaps (B, H, W, J), features (B, H, W, F), tagmaps (B, H, W, J) or
    (B, H, W, J, S) with test-time augmentation's S tag channels (original
    and flipped), masks (B, H, W) crowd masks (or the canvas's valid region
    at test time) or None, joints_gt (B, P, J, 3) GT joints in
    map coordinates, factors (B, P, J) their OKS factors. Returns the
    flattened GraphBatch.
    """
    b, h, w, j = scoremaps.shape
    n = j * cfg.nodes_per_type
    det, scores, valid = joint_det_from_scoremaps(
        scoremaps.permute(0, 3, 1, 2), cfg.nodes_per_type, cfg.detect_threshold,
        cfg.pool_kernel, mask=masks if cfg.mask_crowds else None,
        hybrid_k=cfg.hybrid_k,
    )
    bi = torch.arange(b, device=det.device)[:, None]
    xs, ys, ts = det[..., 0].long(), det[..., 1].long(), det[..., 2].long()
    node_feats = features[bi, ys, xs]                       # (B, N, F)
    tags_at = tagmaps[bi, ys, xs, ts]                       # (B, N[, S])
    ei, ev = _build_edges(cfg, det, valid, scores)          # (B, 2, E), (B, E)
    e = ei.shape[-1]
    offsets = (torch.arange(b, dtype=torch.int32, device=det.device) * n)[:, None, None]
    edge_index = (ei + offsets).transpose(0, 1).reshape(2, b * e)
    det_flat = det.reshape(b * n, 3)
    gb = GraphBatch(
        x=node_feats.reshape(b * n, -1),
        edge_attr=_edge_features(cfg, det_flat, edge_index, (h, w)),
        edge_index=edge_index,
        joint_det=det_flat,
        joint_scores=scores.reshape(b * n),
        joint_tags=tags_at.reshape(b * n, *tags_at.shape[2:]),
        batch_index=torch.arange(b, device=det.device).repeat_interleave(n),
        node_valid=valid.reshape(b * n),
        edge_valid=ev.reshape(b * e),
        edge_src_local=ei[:, 0].reshape(b * e),
    )
    if joints_gt is not None:
        labels = _construct_labels(cfg, det, valid, ei, joints_gt, factors, (h, w))
        for name, value in labels.items():
            setattr(gb, name, value.reshape(-1))
    return gb
