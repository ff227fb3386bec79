"""Connected components on padded pose graphs (counterpart of
pemp_tpu.ops.components, dense blocked path).

At pose-graph sizes (680 nodes per image) the transitive closure is
ceil(log2(N)) squarings of the dense adjacency, batched over images with
``torch.matmul``. Labels are the minimum node index of each component
(reference: scipy connected_components in src/Utils/Utils.py:686-693).
"""

from __future__ import annotations

import math

import torch


def connected_components(edge_index, edge_valid, num_nodes: int, blocked_c: int,
                         node_valid=None):
    """Label each node with the minimum node index of its component.

    edge_index: (B, 2, N*C) in the target-major blocked layout
    (edge_index[:, 1] == slot // C), per-image node ids; edge_valid
    (B, N*C); node_valid (B, N) or None. Edges are undirected.
    Returns labels (B, N) int64; invalid nodes keep their own index.
    """
    b = edge_index.shape[0]
    if edge_index.shape[-1] != num_nodes * blocked_c:
        raise ValueError("edges are not in the blocked layout")
    dev = edge_index.device
    src = edge_index[:, 0].reshape(b, num_nodes, blocked_c).long()
    ev = edge_valid.reshape(b, num_nodes, blocked_c)
    # row n of the forward adjacency: which sources reach n through a valid slot
    hits = torch.zeros((b, num_nodes, num_nodes), dtype=torch.float32, device=dev)
    hits.scatter_add_(2, src, ev.float())
    fwd = hits > 0
    und = fwd | fwd.transpose(1, 2)
    if node_valid is not None:
        und = und & node_valid[:, None, :] & node_valid[:, :, None]
    a = und.float() + torch.eye(num_nodes, device=dev)
    a = torch.clamp(a, max=1.0)
    rounds = max(1, math.ceil(math.log2(max(num_nodes, 2))))
    for _ in range(rounds):
        a = (torch.matmul(a, a) > 0).float()
    # first reachable index == min label of the component
    return torch.argmax(a, dim=2)


def relabel_compact(labels: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Map component labels (B, N) to compact ids [0, n_components) in order
    of each component's representative index."""
    nodes = torch.arange(num_nodes, device=labels.device)
    is_rep = labels == nodes
    compact_of_rep = torch.cumsum(is_rep.long(), dim=1) - 1
    return torch.gather(compact_of_rep, 1, labels)
