"""Graph builders on padded detections (counterpart of pemp_tpu.ops.knn).

``knn_edges_target_major`` in both layouts: the asymmetric one of the
``fused_step`` and ``pallas`` message paths and the symmetric one of
``hybrid`` and ``einsum``, with ``reverse_edge_perm``, the reverse-edge
involution those two read. The other builders of the files of configs/
give an edge list of static length with a validity mask (the reference's
``to_undirected + remove_self_loops`` by masking, ConstructGraph.py:
376-381, 405-449): ``fully_connected_edges``, ``score_based_edges`` and
``score_based_per_type_edges``, the kNN edge list ``knn_edges``
(``TPU.TARGET_MAJOR`` false), ``feature_knn_edges`` (kNN among the node
features) and ``top_k_per_type_edges`` (the k nearest of every type). They
take a batch axis: (B, N, ...) in, edge_index (B, 2, E) int32 and
edge_valid (B, E) out, E the same for every image.

Convention as in the reference MPN: ``edge_index[0]`` is the message
source j, ``edge_index[1]`` the target i (reference layers.py:210).

Tie order is part of the contract: detections sit on integer pixels, so
equal distances are common. ``lax.top_k(-d2)`` takes the lower index first,
which a stable ascending sort on ``d2`` reproduces (and ``lax.top_k(s)`` a
stable descending sort on ``s``); the transpose edges are placed by a
stable sort on the target id. The masking sums (``BIG`` added to the
distances of invalid or excluded pairs) are taken in the JAX package's
order in float32, so that the padded slots' indices tie and order alike.
"""

from __future__ import annotations

import torch

BIG = 1e9


def pairwise_dist2(pos: torch.Tensor) -> torch.Tensor:
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def _masked_dist2(d2, valid, sources: bool):
    """``d2`` (B, N, N) + BIG on the invalid columns (and with ``sources``
    on the invalid rows) + BIG on the diagonal, in that order."""
    n = d2.shape[-1]
    zero = torch.zeros((), dtype=d2.dtype, device=d2.device)
    big = torch.full((), BIG, dtype=d2.dtype, device=d2.device)
    d2 = d2 + torch.where(~valid[:, None, :], big, zero)
    if sources:
        d2 = d2 + torch.where(~valid[:, :, None], big, zero)
    return d2 + torch.eye(n, dtype=d2.dtype, device=d2.device) * BIG


def _nearest(d2, k: int):
    """(distances, indices) of the k smallest along the last axis, lower
    index first among equals (``lax.top_k(-d2, k)``)."""
    d, idx = torch.sort(d2, dim=-1, stable=True)
    return d[..., :k], idx[..., :k]


def knn_edges(pos: torch.Tensor, valid: torch.Tensor, k: int):
    """The kNN graph as an edge list (pemp_tpu.ops.knn.knn_edges;
    reference ConstructGraph.py:363-368): each node's k nearest valid
    nodes (euclidean on (B, N, D) positions, no self loops) as a forward
    block source-major (edge s * k + m is s -> its m-th neighbour), then
    the reverse of each, invalid where the pair is mutual (the forward
    block holds it) or touches an invalid node. Returns edge_index
    (B, 2, 2*N*k) int32, edge_valid (B, 2*N*k)."""
    b, n = valid.shape
    k = min(k, max(n - 1, 1))
    d2 = _masked_dist2(pairwise_dist2(pos.float()), valid, True)
    d, nbr = _nearest(d2, k)                                       # (B, N, k)
    fwd_valid = valid[:, :, None] & _gather(valid, nbr) & (d < BIG / 2)
    src = torch.arange(n, device=pos.device)[None, :, None].expand(b, n, k)
    # mutual: s is among the neighbours of its neighbour, whose forward
    # edge to s the reverse copy would duplicate
    nbr_of_nbr = torch.gather(nbr, 1, nbr.reshape(b, n * k, 1).expand(b, n * k, k))
    mutual = (nbr_of_nbr.reshape(b, n, k, k) == src[..., None]).any(-1)
    return _forward_and_reverse(src, nbr, fwd_valid, fwd_valid & ~mutual)


def feature_knn_edges(features: torch.Tensor, valid: torch.Tensor, k: int):
    """kNN in the space of the node features (B, N, F), cast to float32
    (pemp_tpu.ops.knn.feature_knn_edges; reference ConstructGraph.py:
    370-374): :func:`knn_edges` on them. The squared distances sum F
    products, in another order than XLA's, so two candidates within
    float32 rounding of each other can trade places. The (B, N, N, F)
    differences are taken one image at a time."""
    parts = [knn_edges(features[i:i + 1].float(), valid[i:i + 1], k)
             for i in range(features.shape[0])]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def top_k_per_type_edges(pos: torch.Tensor, valid: torch.Tensor, types: torch.Tensor,
                         num_types: int, k: int):
    """Each node to its k nearest of every type (pemp_tpu.ops.knn.
    top_k_per_type_edges; reference ConstructGraph.py:383-403, k = 10): the
    forward block node-major, then type-major, then by distance (edge
    (s * T + t) * k + m is s -> its m-th nearest node of type t), then its
    reverse, invalid where mutual. pos (B, N, 2), valid and types (B, N).
    Returns edge_index (B, 2, 2*N*T*k) int32, edge_valid."""
    b, n = valid.shape
    dev = pos.device
    d2 = _masked_dist2(pairwise_dist2(pos.float()), valid, False)
    other = types.long()[:, None, :] != torch.arange(num_types, device=dev)[None, :, None]
    zero = torch.zeros((), dtype=d2.dtype, device=dev)
    big = torch.full((), BIG, dtype=d2.dtype, device=dev)
    d2t = d2[:, :, None, :] + torch.where(other, big, zero)[:, None]      # (B, N, T, N)
    d, nbr = _nearest(d2t.reshape(b, n * num_types, n), k)              # (B, N*T, k)
    src = torch.arange(n, device=dev).repeat_interleave(num_types)[None, :, None]
    src = src.expand(b, n * num_types, k)
    fwd_valid = (d < BIG / 2) & _gather(valid, src) & _gather(valid, nbr)
    # mutual: s is among the per-type neighbours of its neighbour
    nbr_flat = nbr.reshape(b, n, num_types * k).to(torch.int32)
    tk = num_types * k
    of_dst = torch.gather(nbr_flat, 1, nbr.reshape(b, -1, 1).expand(b, n * tk, tk))
    mutual = (of_dst.reshape(b, n * num_types, k, tk) == src[..., None]).any(-1)
    return _forward_and_reverse(src, nbr, fwd_valid, fwd_valid & ~mutual)


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


def _largest(s, k: int):
    """Indices of the k largest along the last axis, lower index first
    among equals (``lax.top_k(s, k)``)."""
    return torch.sort(s, dim=-1, descending=True, stable=True)[1][..., :k]


def _gather(x, idx):
    """x (B, N) at idx (B, ...) per image."""
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def _forward_and_reverse(src_fwd, dst_fwd, fwd_valid, rev_valid):
    """The forward block (src -> dst) and its reverse block as one list."""
    b = src_fwd.shape[0]
    src = torch.cat([src_fwd.reshape(b, -1), dst_fwd.reshape(b, -1)], dim=1)
    dst = torch.cat([dst_fwd.reshape(b, -1), src_fwd.reshape(b, -1)], dim=1)
    ev = torch.cat([fwd_valid.reshape(b, -1), rev_valid.reshape(b, -1)], dim=1)
    return torch.stack([src, dst], dim=1).to(torch.int32), ev


def fully_connected_edges(valid: torch.Tensor):
    """All directed pairs without self loops, source major, each source's
    targets ascending (pemp_tpu.ops.knn.fully_connected_edges; reference
    ConstructGraph.py:376-381). valid (B, N). Returns edge_index
    (B, 2, N*(N-1)), edge_valid."""
    b, n = valid.shape
    dev = valid.device
    src = torch.arange(n, device=dev).repeat_interleave(n - 1)
    rank = torch.arange(n - 1, device=dev).repeat(n)
    dst = rank + (rank >= src).long()
    edge_index = torch.stack([src, dst]).to(torch.int32)[None].expand(b, 2, n * (n - 1))
    return edge_index, valid[:, src] & valid[:, dst]


def score_based_edges(pos: torch.Tensor, valid: torch.Tensor, scores: torch.Tensor, k: int):
    """Root-joint graph (pemp_tpu.ops.knn.score_based_edges; reference
    ConstructGraph.py:405-422): the k best-scoring nodes connect to all,
    both ways; a root-root pair is kept once in each direction.

    pos (B, N, 2), valid and scores (B, N). Returns edge_index
    (B, 2, 2*k*N), edge_valid.
    """
    b, n = valid.shape
    dev = valid.device
    s = torch.where(valid, scores.float(), torch.full_like(scores, float("-inf"),
                                                            dtype=torch.float32))
    roots = _largest(s, min(k, n))                              # (B, k)
    k = roots.shape[1]
    src_fwd = roots[:, :, None].expand(b, k, n)
    dst_fwd = torch.arange(n, device=dev)[None, None, :].expand(b, k, n)
    is_root = torch.zeros_like(valid).scatter(1, roots, True)
    root_dst = is_root[:, None, :].expand(b, k, n)
    fwd_valid = _gather(valid, src_fwd) & valid[:, None, :] & (src_fwd != dst_fwd)
    # root -> root pairs appear in both roots' blocks: keep the src < dst copy
    fwd_valid = fwd_valid & ~(root_dst & (src_fwd > dst_fwd))
    return _forward_and_reverse(src_fwd, dst_fwd, fwd_valid, fwd_valid & ~root_dst)


def score_based_per_type_edges(pos: torch.Tensor, valid: torch.Tensor, types: torch.Tensor,
                               scores: torch.Tensor, num_types: int, k_per_type: int,
                               nodes_per_type: int, score_threshold: float = 0.1):
    """Root joints per type (pemp_tpu.ops.knn.score_based_per_type_edges;
    reference ConstructGraph.py:424-449, k = 2, threshold 0.1): the k best
    of each type's block and every valid node scoring above the threshold
    are roots; the fully connected list keeps the edges with a root at
    either end. Detections are type-blocked (N = T * K). Returns
    edge_index (B, 2, N*(N-1)), edge_valid."""
    del pos, types    # the roots come from the scores of each type's block
    b, n = valid.shape
    dev = valid.device
    sc = scores.float()
    s = torch.where(valid, sc, torch.full_like(sc, float("-inf")))
    top = _largest(s.reshape(b, num_types, nodes_per_type), k_per_type)     # (B, T, k)
    base = (torch.arange(num_types, device=dev) * nodes_per_type)[None, :, None]
    roots = (top + base).reshape(b, -1)
    is_root = torch.zeros_like(valid).scatter(1, roots, True)
    is_root = (is_root | (torch.where(valid, sc, torch.zeros_like(sc)) > score_threshold)) & valid
    edge_index, edge_valid = fully_connected_edges(valid)
    src, dst = edge_index[0, 0].long(), edge_index[0, 1].long()
    return edge_index, edge_valid & (is_root[:, src] | is_root[:, dst])
