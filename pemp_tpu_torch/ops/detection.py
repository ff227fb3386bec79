"""Keypoint candidate extraction: max-pool NMS + per-type top-K.

Counterpart of pemp_tpu.ops.detection (reference:
src/graph_constructor/ConstructGraph.py:1161-1196). Every image yields
exactly ``J * K`` padded detections with a validity mask:

    valid = (score > 0) & ((rank < hybrid_k) | (score >= threshold))

Tie order is part of the contract. Scoremaps computed in bf16 repeat peak
values often, and ``lax.top_k`` orders equal values by lower index under
the IEEE total order (so +0.0 ranks above -0.0). The top-K here is a
descending stable sort on total-order integer keys, which gives the same
order on the CPU and on the card; ``torch.topk`` promises no tie order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nms_mask(scoremaps: torch.Tensor, pool_kernel: int) -> torch.Tensor:
    """Boolean local-maxima mask via max-pool equality.

    scoremaps: (B, J, H, W). reference: src/Utils/Utils.py:15-20.
    """
    if pool_kernel % 2 != 1:
        raise ValueError("pool_kernel must be odd")
    pooled = F.max_pool2d(scoremaps, pool_kernel, stride=1, padding=pool_kernel // 2)
    return pooled == scoremaps


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose order is the IEEE total order of float32 ``x``."""
    bits = x.float().contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def top_k_lower_index(values: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: largest first, equal values by
    lower index, float order total. Returns (values, int64 indices)."""
    keys = total_order_key(values)
    idx = torch.sort(keys, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(values, -1, idx), idx


def joint_det_from_scoremaps(
    scoremaps: torch.Tensor,
    k_per_type: int,
    threshold: float | None,
    pool_kernel: int = 3,
    mask: torch.Tensor | None = None,
    hybrid_k: int = 5,
):
    """Batched fixed-shape detection.

    scoremaps: (B, J, H, W) float; mask: (B, H, W) crowd mask or None.

    Returns joint_det (B, J*K, 3) int32 (x, y, type) in the type-blocked
    layout (node ``n`` has type ``n // K``), joint_scores (B, J*K) and
    valid (B, J*K) bool. Invalid detections are parked at (0, 0) with
    their type kept.
    """
    b, j, h, w = scoremaps.shape
    peaks = nms_mask(scoremaps, pool_kernel).to(scoremaps.dtype)
    if mask is not None:
        peaks = peaks * mask[:, None, :, :].to(scoremaps.dtype)
    masked = scoremaps * peaks  # zero where not an NMS peak (or crowd-masked)

    scores, idx = top_k_lower_index(masked.reshape(b, j, h * w), k_per_type)
    idx = idx.to(torch.int32)
    xs = idx % w
    ys = idx // w
    types = torch.arange(j, dtype=torch.int32, device=scoremaps.device)
    types = types[None, :, None].expand(b, j, k_per_type)

    if threshold is not None:
        rank = torch.arange(k_per_type, device=scoremaps.device)[None, None, :]
        valid = (scores > 0) & ((rank < hybrid_k) | (scores >= threshold))
    else:
        # reference no-threshold mode: every top-K entry kept, scores + 1e-10
        valid = torch.ones_like(scores, dtype=torch.bool)
        scores = scores + 1e-10

    zero = torch.zeros_like(xs)
    xs = torch.where(valid, xs, zero)
    ys = torch.where(valid, ys, zero)
    joint_det = torch.stack([xs, ys, types], dim=-1).reshape(b, j * k_per_type, 3)
    return joint_det, scores.reshape(b, j * k_per_type), valid.reshape(b, j * k_per_type)
