"""Flagship MPN (counterpart of pemp_tpu.models.mpn.models.NodeClassificationMPN).

Forward contract as in the reference
(src/Models/MessagePassingNetwork/NodeClassificationMPNSimple.py:62-97):

    (x, edge_attr, edge_index, ...) ->
        dict(edge=[(E,) logits], node=[(N,)], class=[(N, C)])

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
projection's selections'. The module's mode decides the rest: training
collects per-step outputs, with the heads on the last
``AUX_LOSS_STEPS + 1`` steps and on the final features
(pemp_tpu/models/mpn/models.py:288-316), and takes the embeddings'
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

from pemp_tpu_torch.config.defaults import msg_pass_route
from pemp_tpu_torch.models.mpn.layers import (
    MLP,
    TypeAwareMPNLayer,
    num_summary_types,
    split_linear_plans,
    sum_node_types,
)
from pemp_tpu_torch.ops.gather_mm import gather_plan
from pemp_tpu_torch.ops.knn import reverse_edge_perm


def mpn_cfg_from_config(mpn_config) -> dict:
    """The open MPN config subtree as a plain dict."""
    d = mpn_config.to_dict() if hasattr(mpn_config, "to_dict") else dict(mpn_config)
    d.setdefault("NODE_STEPS", 0)
    return d


def _check_flagship(c: dict) -> None:
    """Raises unless ``c`` is the flagship MPN the port implements."""
    want = {
        "NAME": "NodeClassificationMPN", "AGGR_TYPE": "per_type", "EDGE_MLP": "agnostic",
        "AGGR_SUB": "node_edge_attn", "UPDATE_TYPE": "mlp", "SKIP": True,
        "LATE_FUSION_POS": False, "NODE_STEPS": 0,
    }
    for key, value in want.items():
        if c.get(key) != value:
            raise NotImplementedError(
                f"MPN {key}={c.get(key)!r}: only the flagship MPN "
                f"({key}={value!r}) is ported"
            )
    if not c.get("_BLOCKED_C") or not c.get("_NODES_PER_TYPE"):
        raise NotImplementedError("the flagship MPN needs the blocked, type-blocked layout")


class NodeClassificationMPN(nn.Module):
    """Flagship: shared-weight MP steps + edge/node/class heads.

    reference: NodeClassificationMPNSimple.py:23-97. ``mpn_cfg`` is the
    plain-dict MPN config plus ``_BLOCKED_C`` (slots per node) and
    ``_NODES_PER_TYPE`` (K), as the JAX package's build_pose_model sets them,
    and ``_MSG_PASS`` (``TPU.MSG_PASS``, ``auto`` when absent).
    """

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        c = dict(mpn_cfg)
        _check_flagship(c)
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

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None):
        """x (N, F) f32, edge_attr (E, 2+J), edge_index (2, E) flat ids,
        edge_valid (E,), edge_src_local (E,) source ids within their image;
        ``dtype`` is the working type; ``node_valid`` (N,) masks the
        BatchNorm statistics in training. Node types are not an input: on
        the type-blocked layout they are index arithmetic. The route is
        ``route`` when given, else ``_MSG_PASS`` resolved for the module's
        mode (module docstring)."""
        c = self.cfg
        route = route or msg_pass_route(c.get("_MSG_PASS", "auto"), self.training)
        npt = c["_NODES_PER_TYPE"]
        e = edge_index.shape[1]
        edge_features = self.edge_embedding(edge_attr.to(dtype), edge_valid)
        node_features = self.node_embedding(x.to(dtype), node_valid)

        # loop-invariant inputs of every step (_run_steps' ``pre``): source
        # types are index arithmetic on the type-blocked layout
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
