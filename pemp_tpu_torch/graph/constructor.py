"""Batched, static-shape graph construction for eval (counterpart of
pemp_tpu.graph.constructor, ``testing=True`` without labels).

Detection (NMS + per-type top-K) gives J*K padded nodes per image; the
target-major kNN builder gives C = k + cap_in in-edge slots per node. The
per-image graphs are flattened into one disjoint graph by offsetting node
ids (reference: src/graph_constructor/ConstructGraph.py:221-231), so the MPN
runs once over (B*N, B*N*C).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from pemp_tpu_torch.ops.detection import joint_det_from_scoremaps
from pemp_tpu_torch.ops.knn import knn_edges_target_major


@dataclasses.dataclass(frozen=True)
class GCConfig:
    """Static graph settings from config.MODEL.GC and the TPU sizing keys.

    Only what the eval path reads; the kNN layout is the asymmetric one that
    ``TPU.MSG_PASS=fused_step`` selects in the JAX package.
    """

    num_joints: int = 17
    nodes_per_type: int = 40
    knn_k: int = 50
    knn_cap_in: int = 30
    pool_kernel: int = 3
    detect_threshold: float | None = 0.1
    hybrid_k: int = 5
    edge_features: tuple = ("position", "connection_type")
    norm_node_distance: bool = False
    mask_crowds: bool = True

    @classmethod
    def from_config(cls, config) -> "GCConfig":
        # the config fixes the target-major kNN graph on detections
        # (config.defaults.FIXED)
        gc = config.MODEL.GC
        cap_in = config.TPU.KNN_CAP_IN
        return cls(
            num_joints=config.DATASET.NUM_JOINTS,
            nodes_per_type=config.TPU.NODES_PER_TYPE,
            knn_k=config.TPU.KNN_K,
            knn_cap_in=cap_in if cap_in > 0 else config.TPU.KNN_K,
            pool_kernel=gc.POOL_KERNEL_SIZE,
            detect_threshold=gc.DETECT_THRESHOLD if gc.DETECT_THRESHOLD <= 1.5 else None,
            hybrid_k=gc.HYBRID_K,
            edge_features=tuple(gc.EDGE_FEATURES_TO_USE),
            norm_node_distance=gc.NORM_NODE_DISTANCE,
            mask_crowds=gc.MASK_CROWDS,
        )

    @property
    def slots(self) -> int:
        """C: in-edge slots per node (mirrors the builder's k clamp)."""
        n = self.num_joints * self.nodes_per_type
        return min(self.knn_k, max(n - 1, 1)) + self.knn_cap_in


@dataclasses.dataclass
class GraphBatch:
    """Flattened batch graph. Shapes: N* = B*J*K, E* = B*N*C."""

    x: Any                 # (N*, F) node features
    edge_attr: Any         # (E*, 2 + J)
    edge_index: Any        # (2, E*) into flattened node ids
    joint_det: Any         # (N*, 3) x, y, type
    joint_scores: Any      # (N*,)
    joint_tags: Any        # (N*,)
    batch_index: Any       # (N*,)
    node_valid: Any        # (N*,) bool
    edge_valid: Any        # (E*,) bool
    edge_src_local: Any    # (E*,) source index WITHIN its image


def _edge_features(cfg: GCConfig, det, edge_index, hw):
    """Position offsets + connection-type hot vector per edge.

    reference: ConstructGraph.py:288-359. Types are index arithmetic on the
    type-blocked layout (type(n) == (n // K) mod J); the target of slot s is
    s // C, so its row is a repeat.
    """
    feats = set(cfg.edge_features)
    if feats != {"position", "connection_type"}:
        raise NotImplementedError(cfg.edge_features)
    src, dst = edge_index[0].long(), edge_index[1].long()
    norm = float(max(hw)) if cfg.norm_node_distance else 1.0
    j = cfg.num_joints
    row = det[:, :2].float()
    rs = row[src]
    rd = torch.repeat_interleave(row, edge_index.shape[1] // row.shape[0], dim=0)
    dx = (rd[:, 0] - rs[:, 0]) / norm
    dy = (rd[:, 1] - rs[:, 1]) / norm
    hot_s = F.one_hot((src // cfg.nodes_per_type) % j, j).float()
    hot_d = F.one_hot((dst // cfg.nodes_per_type) % j, j).float()
    conn = torch.clamp(hot_s + hot_d, 0.0, 1.0)
    return torch.cat([dx[:, None], dy[:, None], conn], dim=-1)


def construct_graph_batch(cfg: GCConfig, scoremaps, features, tagmaps, masks=None):
    """Eval graph construction.

    scoremaps (B, H, W, J), features (B, H, W, F), tagmaps (B, H, W, J),
    masks (B, H, W) crowd masks or None. Returns the flattened GraphBatch.
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
    tags_at = tagmaps[bi, ys, xs, ts]                       # (B, N)
    ei, ev = knn_edges_target_major(
        det[..., :2].float(), valid, cfg.knn_k, cfg.knn_cap_in
    )                                                       # (B, 2, E), (B, E)
    e = ei.shape[-1]
    offsets = (torch.arange(b, dtype=torch.int32, device=det.device) * n)[:, None, None]
    edge_index = (ei + offsets).transpose(0, 1).reshape(2, b * e)
    det_flat = det.reshape(b * n, 3)
    return GraphBatch(
        x=node_feats.reshape(b * n, -1),
        edge_attr=_edge_features(cfg, det_flat, edge_index, (h, w)),
        edge_index=edge_index,
        joint_det=det_flat,
        joint_scores=scores.reshape(b * n),
        joint_tags=tags_at.reshape(b * n),
        batch_index=torch.arange(b, device=det.device).repeat_interleave(n),
        node_valid=valid.reshape(b * n),
        edge_valid=ev.reshape(b * e),
        edge_src_local=ei[:, 0].reshape(b * e),
    )
