"""Target-major kNN edges (counterpart of pemp_tpu.ops.knn).

``knn_edges_target_major`` in both layouts: the asymmetric one of the
``fused_step`` and ``pallas`` message paths and the symmetric one of
``hybrid`` and ``einsum``, with ``reverse_edge_perm``, the reverse-edge
involution those two read.

Convention as in the reference MPN: ``edge_index[0]`` is the message
source j, ``edge_index[1]`` the target i (reference layers.py:210).

Tie order is part of the contract: detections sit on integer pixels, so
equal distances are common. ``lax.top_k(-d2)`` takes the lower index first,
which a stable ascending sort on ``d2`` reproduces; the transpose edges are
placed by a stable sort on the target id.
"""

from __future__ import annotations

import torch

BIG = 1e9


def pairwise_dist2(pos: torch.Tensor) -> torch.Tensor:
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def knn_edges_target_major(pos: torch.Tensor, valid: torch.Tensor, k: int,
                           cap_in: int | None = None, symmetric: bool = False):
    """Undirected kNN edges in a *target-major blocked* layout.

    pos: (B, N, 2) or (N, 2); valid: matching (B, N) or (N,).
    The in-edges of node ``i`` occupy slots ``[i*C, (i+1)*C)``, C = k + cap_in:

      * slots [i*C, i*C+k): sources = knn(i)
      * slots [i*C+k, (i+1)*C): sources j with i in knn(j) and j not in
        knn(i), placed by rank; entries beyond ``cap_in`` are dropped.

    ``symmetric=True`` also drops the A-side reverse of every truncated
    B-edge, so every valid edge's reverse is a valid slot
    (pemp_tpu/ops/knn.py:172-177, 235-244).

    Returns edge_index (B, 2, N*C) int32 (edge_index[:, 1] == slot // C)
    and edge_valid (B, N*C) bool, without the batch axis for unbatched input.
    """
    if pos.dim() == 2:
        ei, ev = knn_edges_target_major(pos[None], valid[None], k, cap_in, symmetric)
        return ei[0], ev[0]
    b, n, _ = pos.shape
    dev = pos.device
    k = min(k, max(n - 1, 1))
    if cap_in is None:
        cap_in = k
    c = k + cap_in

    d2 = pairwise_dist2(pos.float())
    invalid = ~valid
    zero = torch.zeros((), dtype=d2.dtype, device=dev)
    big = torch.full((), BIG, dtype=d2.dtype, device=dev)
    d2 = d2 + torch.where(invalid[:, None, :], big, zero)
    d2 = d2 + torch.where(invalid[:, :, None], big, zero)
    d2 = d2 + torch.eye(n, dtype=d2.dtype, device=dev) * BIG
    d_sorted, nbr = torch.sort(d2, dim=-1, stable=True)
    d_sorted, nbr = d_sorted[..., :k], nbr[..., :k]          # (B, N, k)
    nbr_ok = (d_sorted < BIG / 2) & valid[:, :, None]

    # block A: j -> i for j in knn(i)
    src_a = nbr.to(torch.int32)

    # block B: transpose edges i' -> t for t = knn(i')[m], minus mutual pairs
    nodes = torch.arange(n, device=dev)
    nbr_of_nbr = torch.gather(
        nbr, 1, nbr.reshape(b, n * k, 1).expand(b, n * k, k)
    ).reshape(b, n, k, k)
    mutual = torch.any(nbr_of_nbr == nodes[None, :, None, None], dim=-1)
    fwd_src = nodes[None, :, None].expand(b, n, k).reshape(b, n * k)
    fwd_keep = (nbr_ok & ~mutual).reshape(b, n * k)
    tgt = torch.where(fwd_keep, nbr.reshape(b, n * k), torch.full_like(fwd_src, n))
    tgt_sorted, order = torch.sort(tgt, dim=-1, stable=True)
    src_sorted = torch.gather(fwd_src, 1, order)
    # per-target run lengths of the sorted list (slot n parks dropped edges)
    counts = torch.zeros((b, n + 1), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, tgt_sorted, torch.ones_like(tgt_sorted))
    counts = counts[:, :n]
    starts = torch.cumsum(counts, dim=1) - counts
    if symmetric:
        # kept[f]: forward edge f survived its target's B-region cap. A-slot
        # (i, m) is the reverse of forward edge i*k+m, so A-edges whose
        # non-mutual reverse was cut are dropped; the stable sort's order is
        # the slot-id payload that scatters the flags back
        rank = torch.arange(n * k, device=dev) - torch.gather(
            starts, 1, torch.clamp(tgt_sorted, max=n - 1))
        kept_sorted = (rank < cap_in) & (tgt_sorted < n)
        kept = torch.zeros_like(kept_sorted).scatter(1, order, kept_sorted)
        nbr_ok = nbr_ok & (mutual | kept.reshape(b, n, k))
    r_iota = torch.arange(cap_in, device=dev)
    slot = starts[:, :, None] + r_iota[None, None, :]        # (B, N, cap)
    valid_b = r_iota[None, None, :] < torch.clamp(counts, max=cap_in)[:, :, None]
    slot = torch.clamp(slot, 0, n * k - 1).reshape(b, n * cap_in)
    src_b = torch.gather(src_sorted, 1, slot).reshape(b, n, cap_in)
    src_b = torch.where(valid_b, src_b, torch.zeros_like(src_b)).to(torch.int32)

    edge_src = torch.cat([src_a, src_b], dim=2).reshape(b, n * c)
    edge_valid = torch.cat([nbr_ok, valid_b], dim=2).reshape(b, n * c)
    edge_dst = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(c)
    edge_index = torch.stack([edge_src, edge_dst[None].expand(b, n * c)], dim=1)
    return edge_index, edge_valid


def reverse_edge_perm(edge_src: torch.Tensor, edge_valid: torch.Tensor, num_nodes: int,
                      c: int) -> torch.Tensor:
    """Slot of each edge's reverse in the symmetric target-major layout
    (pemp_tpu.ops.knn.reverse_edge_perm): R (E,) with R[R[e]] == e on valid
    edges. The first matching slot of block src(e) is taken; an invalid slot
    e gets src(e) * C. Same dtype as ``edge_src``. Builds an (E, C) table
    of candidates once per forward (139 MB in int32 at the flagship eval
    size)."""
    src = edge_src.long()
    dst = torch.arange(num_nodes, device=edge_src.device).repeat_interleave(c)
    cand = edge_src.reshape(num_nodes, c)[src]                       # (E, C)
    match = (cand == dst[:, None]) & edge_valid.reshape(num_nodes, c)[src]
    first = torch.argmax(match.to(torch.uint8), dim=1)   # the first maximum
    return (src * c + first).to(edge_src.dtype)
