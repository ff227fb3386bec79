"""Flagship MPN (counterpart of pemp_tpu.models.mpn.models.NodeClassificationMPN,
eval with per-step collection off).

Forward contract as in the reference
(src/Models/MessagePassingNetwork/NodeClassificationMPNSimple.py:62-97):

    (x, edge_attr, edge_index, ...) ->
        dict(edge=[(E,) logits], node=[(N,)], class=[(N, C)])

The JAX package scans the shared-weight step with ``nn.scan``; here it is a
Python loop over the same module. The index columns, the init-edge
projection ``q`` and the step's weight views are loop-invariant and are
computed once per forward.
"""

from __future__ import annotations

import torch
from torch import nn

from pemp_tpu_torch.models.mpn.layers import (
    MLP,
    TypeAwareMPNLayer,
    num_summary_types,
    sum_node_types,
)


def mpn_cfg_from_config(mpn_config) -> dict:
    """The open MPN config subtree as a plain dict."""
    d = mpn_config.to_dict() if hasattr(mpn_config, "to_dict") else dict(mpn_config)
    d.setdefault("NODE_STEPS", 0)
    return d


def _check_fused_path(c: dict) -> None:
    want = {
        "NAME": "NodeClassificationMPN", "AGGR_TYPE": "per_type", "EDGE_MLP": "agnostic",
        "AGGR_SUB": "node_edge_attn", "UPDATE_TYPE": "mlp", "SKIP": True,
        "LATE_FUSION_POS": False, "NODE_STEPS": 0,
    }
    for key, value in want.items():
        if c.get(key) != value:
            raise NotImplementedError(
                f"MPN {key}={c.get(key)!r}: only the fused-step flagship path "
                f"({key}={value!r}) is ported"
            )
    if not c.get("_BLOCKED_C") or not c.get("_NODES_PER_TYPE"):
        raise NotImplementedError("the fused step needs the blocked, type-blocked layout")


class NodeClassificationMPN(nn.Module):
    """Flagship: shared-weight MP steps + edge/node/class heads.

    reference: NodeClassificationMPNSimple.py:23-97. ``mpn_cfg`` is the
    plain-dict MPN config plus ``_BLOCKED_C`` (slots per node) and
    ``_NODES_PER_TYPE`` (K), as the JAX package's build_pose_model sets them.
    """

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        c = dict(mpn_cfg)
        _check_fused_path(c)
        self.cfg = c
        self.num_types = num_summary_types(c["NODE_TYPE_SUMMARY"], c["NUM_JOINTS"])
        node_emb = c["NODE_EMB"]["OUTPUT_SIZES"]
        edge_emb = c["EDGE_EMB"]["OUTPUT_SIZES"]
        self.node_embedding = MLP(c["NODE_INPUT_DIM"], node_emb, c["NODE_EMB"]["BN"],
                                  c["NODE_EMB"].get("END_WITH_RELU", False))
        self.edge_embedding = MLP(c["EDGE_INPUT_DIM"], edge_emb, c["EDGE_EMB"]["BN"],
                                  c["EDGE_EMB"].get("END_WITH_RELU", False))
        nd, ed = c["NODE_FEATURE_DIM"], c["EDGE_FEATURE_DIM"]
        self.mpn_node_cls = TypeAwareMPNLayer(
            node_in=node_emb[-1] + nd, edge_in=edge_emb[-1] + ed,
            init_edge_dim=edge_emb[-1], node_dim=nd, edge_dim=ed,
            edge_hidden=c["EDGE_FEATURE_HIDDEN"], num_types=self.num_types,
        )
        self.edge_classification = MLP(ed, c["EDGE_CLASS"]["OUTPUT_SIZES"], c["BN"])
        self.node_classification = MLP(nd, c["NODE_CLASS"]["OUTPUT_SIZES"], c["BN"])
        self.classification = MLP(nd, c["CLASS"]["OUTPUT_SIZES"], c["BN"])

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype):
        """x (N, F) f32, edge_attr (E, 2+J), edge_index (2, E) flat ids,
        edge_valid (E,), edge_src_local (E,) source ids within their image;
        ``dtype`` is the working type. Node types are not an input: on the
        type-blocked layout they are index arithmetic."""
        c = self.cfg
        npt = c["_NODES_PER_TYPE"]
        e = edge_index.shape[1]
        edge_features = self.edge_embedding(edge_attr.to(dtype))
        node_features = self.node_embedding(x.to(dtype))

        # loop-invariant inputs of every step (_run_steps' ``pre``): source
        # types are index arithmetic on the type-blocked layout
        raw = (edge_index[0].long() // npt) % c["NUM_JOINTS"]
        pre = {
            "src_type": sum_node_types(c["NODE_TYPE_SUMMARY"], raw).to(torch.int32).reshape(e),
            "valid": edge_valid.to(torch.int32).reshape(e),
            "src_local": edge_src_local.to(torch.int32).reshape(e),
            "nodes_per_image": c["NUM_JOINTS"] * npt,
        }
        layer = self.mpn_node_cls
        sw = layer.step_weights(dtype)
        init_nodes, init_edges = node_features, edge_features
        q = (init_edges @ sw["w_init_edge"].t()).contiguous()
        for _ in range(c["STEPS"]):
            nf = torch.cat([init_nodes, node_features], dim=-1)
            node_features, edge_features = layer(nf, q, edge_features, pre, sw)

        return {
            "edge": [self.edge_classification(edge_features)[..., 0]],
            "node": [self.node_classification(node_features)[..., 0]],
            "class": [self.classification(node_features)],
        }

