"""Message-passing layers on padded, static-shape graphs (counterpart of
pemp_tpu.models.mpn.layers).

Module and parameter names follow the original reference
(src/Models/MessagePassingNetwork/layers.py), so its ``state_dict`` keys
load unchanged. Two forms of the flagship ``TypeAwareMPNLayer`` are
ported, both with an agnostic edge MLP, ``node_edge_attn`` aggregation,
skip connections, the target-major blocked layout with type-blocked nodes
and an ``mlp`` update: the fused step (K1, eval) and the split edge MLP
followed by the typed message kernel (K2 and its backward K2b, training).
Every layer computes in its input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pemp_tpu_torch.ops.fused_step import fused_mpn_step
from pemp_tpu_torch.ops.typed_message import fused_typed_message_aggregate

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


class Linear(nn.Linear):
    """nn.Linear that computes in its input's dtype (flax Dense ``dtype``)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm1d over the element axis with a validity mask, in float32,
    cast back (pemp_tpu.models.mpn.layers.MaskedBatchNorm).

    In training mode the statistics are taken over the rows ``valid``
    marks: the biased variance normalises, the unbiased one enters the
    running update, momentum 0.1, so padding never touches either. In eval
    mode the running statistics are read.
    """

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x, valid=None):
        xf = x.float()
        if self.training:
            w = valid.to(torch.float32)[:, None]
            count = torch.clamp(w.sum(), min=1.0)
            mean = (xf * w).sum(dim=0) / count
            var = (torch.square(xf - mean) * w).sum(dim=0) / count
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


class TypeAwareMPNLayer(nn.Module):
    """Flagship layer. reference: layers.py:157-258. ``forward`` is the
    fused-step form (K1), ``forward_typed`` the split form with the typed
    message kernel (K2, differentiable through K2b).

    ``node_in`` / ``edge_in`` are the widths of the skip-concatenated node
    and edge inputs; ``init_edge_dim`` is the width of their loop-invariant
    first half.
    """

    def __init__(self, node_in: int, edge_in: int, init_edge_dim: int,
                 node_dim: int, edge_dim: int, edge_hidden: int, num_types: int):
        super().__init__()
        self.node_in = node_in
        self.init_edge_dim = init_edge_dim
        self.num_types = num_types
        self.node_dim = node_dim
        self.mlp_edge = nn.Sequential(
            Linear(2 * node_in + edge_in, edge_hidden), nn.ReLU(),
            Linear(edge_hidden, edge_dim), nn.ReLU(),
        )
        self.mlp_node = _TypedNodeMLP(num_types, node_in + edge_dim, node_dim)
        self.attn_net = nn.Sequential(Linear(edge_dim, 1))
        self.update_mlp = nn.Sequential(Linear(num_types * node_dim, node_dim), nn.ReLU())

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
        ``pre`` the loop-invariant index columns; ``sw`` from step_weights.
        Returns (new nodes (N, D), new edge carry (E, De))."""
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
            n, self.num_types, pre["nodes_per_image"],
        )
        out = self.update_mlp(updates.reshape(n, -1).to(dt))
        return out, new_edge

    def forward_typed(self, x, q, init_proj, cur, pre):
        """One step of the JAX package's ``pallas`` path
        (pemp_tpu/models/mpn/layers.py:465-533 with the blocked split edge
        MLP, then :561-614): x (N, node_in) skip-concatenated nodes; q (E, H)
        the loop-invariant init-edge projection; init_proj (N, H) the
        loop-invariant init half of the source projection, gathered by
        source; cur (E, De) the edge carry; ``pre`` the loop-invariant index
        columns. Returns (new nodes (N, D), new edge carry (E, De))."""
        n = x.shape[0]
        dn, di = self.node_in, self.node_in - self.node_dim
        lin0, lin1 = self.mlp_edge[0], self.mlp_edge[2]
        w0 = lin0.weight
        h_node = x @ w0[:, :dn].t() + lin0.bias                          # (N, H)
        xproj = x[:, di:] @ w0[:, dn + di:2 * dn].t()                    # (N, H)
        src = pre["src"]
        h_edge = (init_proj + xproj)[src] + q + cur @ w0[:, 2 * dn + self.init_edge_dim:].t()
        c = h_edge.shape[0] // n
        h = torch.relu(h_edge + torch.repeat_interleave(h_node, c, dim=0))
        new_edge = torch.relu(lin1(h))                                   # (E, De)
        wn, bn = self.mlp_node.stacked()              # (T, D, dn + De), (T, D)
        t, d = wn.shape[:2]
        a = torch.einsum("ni,toi->nto", x, wn[:, :, :dn]) + bn[None]
        we = wn[:, :, dn:].permute(2, 0, 1).reshape(-1, t * d)   # we[k, t*D+o]
        updates = fused_typed_message_aggregate(
            new_edge.contiguous(), a.contiguous(), pre["src_type"], pre["valid"],
            we.contiguous(), self.attn_net[0].weight.t().contiguous(), n, t)
        out = self.update_mlp(updates.reshape(n, -1))
        return out, new_edge
