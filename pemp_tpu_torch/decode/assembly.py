"""On-device pose assembly: clustering -> persons -> refinement.

Counterpart of pemp_tpu.decode.assembly (reference: src/Utils/Utils.py
pred_to_person / graph_cluster_to_persons :499-743, refine :1026-1104,
adjust :917-936), batched over images with a leading axis B. Score and tag
maps are NHWC (the JAX package's ``channels_last=True`` branch).

Tie-breaks follow the JAX package: ``torch.argmax`` returns the first
maximum as ``jnp.argmax`` does, and the per-(person, type) winner is the
lowest node index among equal scores. ``torch.round`` and ``jnp.round``
both round half to even.
"""

from __future__ import annotations

import torch

from pemp_tpu_torch.ops.components import connected_components, relabel_compact


def cluster_threshold(edge_index, edge_valid, edge_pred, num_nodes, node_keep,
                      threshold: float = 0.8, blocked_c: int = 0):
    """Connected components over confident edges between kept nodes."""
    ev = edge_valid & (edge_pred > threshold)
    return connected_components(edge_index, ev, num_nodes, blocked_c, node_keep)


def persons_from_clusters(joint_det, joint_scores, cluster_labels, node_keep,
                          num_joints: int, max_persons: int = 30,
                          class_probs=None):
    """Per-cluster per-type argmax-score keypoint selection.

    joint_det (B, N, 3), joint_scores (B, N), cluster_labels (B, N),
    node_keep (B, N), class_probs (B, N, J) or None.
    Returns persons (B, P, J, 3) and person_valid (B, P).
    """
    b, n = joint_scores.shape
    dev = joint_scores.device
    compact = relabel_compact(cluster_labels, n)               # (B, N)
    types = joint_det[..., 2].long()
    if class_probs is not None:
        types = torch.argmax(class_probs, dim=-1)

    keepf = node_keep.float()
    sizes = torch.zeros((b, n), device=dev).scatter_add_(1, compact, keepf)
    eligible = sizes >= 2

    # stable slot assignment: eligible clusters in representative order
    rank = torch.cumsum(eligible.long(), dim=1) - 1
    slot = torch.where(eligible & (rank < max_persons), rank,
                       torch.full_like(rank, max_persons))
    node_slot = torch.gather(slot, 1, compact)
    node_slot = torch.where(node_keep, node_slot, torch.full_like(node_slot, max_persons))

    seg = node_slot * num_joints + torch.clamp(types, 0, num_joints - 1)
    nseg = (max_persons + 1) * num_joints
    neg = float("-inf")
    sc = torch.where(node_keep, joint_scores.float(), torch.full_like(joint_scores, neg, dtype=torch.float32))
    best = torch.full((b, nseg), neg, device=dev).scatter_reduce_(
        1, seg, sc, reduce="amax", include_self=True
    )
    is_best = (sc >= torch.gather(best, 1, seg) - 1e-12) & node_keep
    node_ids = torch.arange(n, device=dev).expand(b, n)
    cand = torch.where(is_best, node_ids, torch.full_like(node_ids, n))
    winner = torch.full((b, nseg), n, device=dev).scatter_reduce_(
        1, seg, cand, reduce="amin", include_self=True
    )
    has = (winner < n) & (best > neg / 2)

    winner_c = torch.clamp(winner, 0, n - 1)
    kx = torch.gather(joint_det[..., 0], 1, winner_c).float()
    ky = torch.gather(joint_det[..., 1], 1, winner_c).float()
    zero = torch.zeros_like(best)
    persons = torch.stack(
        [torch.where(has, kx, zero), torch.where(has, ky, zero), torch.where(has, best, zero)],
        dim=-1,
    ).reshape(b, max_persons + 1, num_joints, 3)[:, :max_persons]
    person_valid = torch.any(persons[..., 2] > 0, dim=2)
    return persons, person_valid


def fill_mean(persons, person_valid):
    """Missing joints <- mean of present joints (reference: Utils.py:1470-1472)."""
    present = persons[..., 2] > 0
    cnt = torch.clamp(present.sum(dim=-1, keepdim=True), min=1)
    xy = persons[..., :2]
    mean_xy = torch.where(present[..., None], xy, torch.zeros_like(xy)).sum(
        dim=-2, keepdim=True
    ) / cnt[..., None]
    filled_xy = torch.where(present[..., None], xy, mean_xy)
    out = torch.cat([filled_xy, persons[..., 2:]], dim=-1)
    return torch.where(person_valid[..., None, None], out, persons)


def _at(maps, yy, xx):
    """maps (B, H, W); yy, xx (B, P) -> (B, P)."""
    b, _, w = maps.shape
    return torch.gather(maps.reshape(b, -1), 1, yy * w + xx)


def refine_ae(scoremaps, tagmaps, persons, person_valid):
    """AE-based missing-joint fill-in (reference refine: Utils.py:1026-1104).

    scoremaps (B, H, W, J); tagmaps (B, H, W, J) or (B, H, W, J, S).
    Per person: mean tag over present joints; per joint type the argmax over
    the map of score - round(||tag - mean||); joints not yet present are
    added with score 1e-3.
    """
    b, h, w, j = scoremaps.shape
    if tagmaps.dim() == 4:
        tagmaps = tagmaps[..., None]
    s = tagmaps.shape[-1]
    p = persons.shape[1]

    present = persons[..., 2] > 0                                 # (B, P, J)
    px = torch.clamp(persons[..., 0].long(), 0, w - 1)
    py = torch.clamp(persons[..., 1].long(), 0, h - 1)
    flat_tags = tagmaps.reshape(b, h * w * j, s)
    jt = torch.arange(j, device=scoremaps.device)
    tag_idx = (py * w + px) * j + jt                              # (B, P, J)
    tag_at = torch.gather(
        flat_tags, 1, tag_idx.reshape(b, p * j, 1).expand(b, p * j, s)
    ).reshape(b, p, j, s)
    cnt = torch.clamp(present.sum(dim=-1), min=1)
    mean_tag = torch.where(present[..., None], tag_at, torch.zeros_like(tag_at)).sum(
        dim=2
    ) / cnt[..., None]                                            # (B, P, S)

    ans = []
    for ji in range(j):
        tj = tagmaps[:, :, :, ji, :]                              # (B, H, W, S)
        smj = scoremaps[..., ji]                                  # (B, H, W)
        diff = tj[:, None] - mean_tag[:, :, None, None, :]        # (B, P, H, W, S)
        tt = torch.sqrt(torch.clamp((diff * diff).sum(dim=-1), min=0.0))
        tmp2 = smj[:, None] - torch.round(tt)                     # (B, P, H, W)
        idx = torch.argmax(tmp2.reshape(b, p, h * w), dim=2)
        yy, xx = idx // w, idx % w
        val = _at(smj, yy, xx)
        x = xx.float() + 0.5
        y = yy.float() + 0.5
        right = _at(smj, yy, torch.clamp(xx + 1, max=w - 1))
        left = _at(smj, yy, torch.clamp(xx - 1, min=0))
        x = x + torch.where(right > left, 0.25, -0.25)
        down = _at(smj, torch.clamp(yy + 1, max=h - 1), xx)
        up = _at(smj, torch.clamp(yy - 1, min=0), xx)
        y = y + torch.where(down > up, 0.25, -0.25)
        ans.append(torch.stack([x, y, val.float()], dim=-1))    # (B, P, 3)
    ans = torch.stack(ans, dim=2)                                 # (B, P, J, 3)
    add = (~present) & (ans[..., 2] > 0) & person_valid[..., None]
    new_xy = torch.where(add[..., None], ans[..., :2], persons[..., :2])
    new_s = torch.where(add, torch.full_like(persons[..., 2], 1e-3), persons[..., 2])
    return torch.cat([new_xy, new_s[..., None]], dim=-1)


def adjust_quarter(scoremaps, persons):
    """Quarter-pixel shift toward the larger neighbour + 0.5 offset.

    reference adjust: Utils.py:917-936. scoremaps (B, H, W, J).
    """
    b, h, w, j = scoremaps.shape
    p = persons.shape[1]
    flat = scoremaps.reshape(b, h * w * j)
    jt = torch.arange(j, device=scoremaps.device)

    def sm_at(yy, xx):
        return torch.gather(flat, 1, ((yy * w + xx) * j + jt).reshape(b, p * j)).reshape(b, p, j)

    x = persons[..., 0]
    y = persons[..., 1]
    xi = torch.clamp(x.long(), 0, w - 1)
    yi = torch.clamp(y.long(), 0, h - 1)
    right = sm_at(yi, torch.clamp(xi + 1, max=w - 1))
    left = sm_at(yi, torch.clamp(xi - 1, min=0))
    down = sm_at(torch.clamp(yi + 1, max=h - 1), xi)
    up = sm_at(torch.clamp(yi - 1, min=0), xi)
    nx = xi.float() + torch.where(right > left, 0.25, -0.25) + 0.5
    ny = yi.float() + torch.where(down > up, 0.25, -0.25) + 0.5
    has = persons[..., 2] > 0
    return torch.stack(
        [torch.where(has, nx, x), torch.where(has, ny, y), persons[..., 2]], dim=-1
    )


def decode_poses(
    scoremaps,       # (B, H, W, J)
    tagmaps,         # (B, H, W, J)
    joint_det,       # (B, N, 3)
    node_scores,     # (B, N) sigmoid node preds
    edge_index,      # (B, 2, N*C) per-image ids, target-major blocked
    edge_valid,      # (B, N*C)
    edge_pred,       # (B, N*C) sigmoid edge preds
    node_valid,      # (B, N)
    node_threshold: float,
    num_joints: int,
    blocked_c: int,
    class_probs=None,
    cc_threshold: float = 0.8,
    max_persons: int = 30,
):
    """Threshold -> cluster -> assemble -> fill mean -> refine -> adjust.

    reference pred_to_ann: Utils.py:1445-1478 (everything before
    reverse_affine_map). Returns persons (B, P, J, 3), person_valid (B, P).
    """
    n = joint_det.shape[1]
    node_keep = node_valid & (node_scores > node_threshold)
    labels = cluster_threshold(
        edge_index, edge_valid, edge_pred, n, node_keep, cc_threshold, blocked_c
    )
    persons, person_valid = persons_from_clusters(
        joint_det, node_scores, labels, node_keep, num_joints, max_persons, class_probs
    )
    persons = fill_mean(persons, person_valid)
    persons = refine_ae(scoremaps, tagmaps, persons, person_valid)
    return adjust_quarter(scoremaps, persons), person_valid
