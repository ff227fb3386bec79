"""Segment and blocked aggregations (counterpart of pemp_tpu.ops.segment;
the reference's torch_scatter calls, layers.py:5, 234-251).

The segment ops take edges as a list with a fixed number of segments and a
validity mask (invalid rows contribute nothing, an empty segment gives 0):
``segment_sum``, ``segment_max``, ``segment_mean``, ``segment_softmax``,
``segment_aggregate``, and the per-(target, source type) forms
``per_type_aggregate`` and ``per_type_attention_aggregate`` over the
combined index ``target * T + type``. They run on the edge-list routes,
where the JAX package computes them in plain XLA. The blocked forms
(``blocked_aggregate``, ``blocked_per_type_aggregate``,
``blocked_per_type_attention_aggregate``) reduce the target-major layout's
C slots of each node densely. The per-type sums by ``MPN.AGGR``
(``AGGR_SUB`` other than an attention) are plain on every device: the JAX
package has no Pallas form of them.

``blocked_per_type_attention_aggregate`` is also the plain version of K4
(``ops.blocked_attn``), the einsum and dots message paths' aggregate on
CPU tensors, and the softmax-and-sum part of the plain versions of K3
(``ops.attn_aggregate``) and K2 (``ops.typed_message``).
:func:`group_weights` is the scalar part of the factored plain backwards
of K3b and K4b.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def _mask_rows(data, valid, fill: float):
    """``data`` with the rows ``valid`` marks false set to ``fill``."""
    if valid is None:
        return data
    v = valid.reshape(valid.shape + (1,) * (data.dim() - valid.dim())).bool()
    return torch.where(v, data, torch.full_like(data, fill))


def segment_sum(data, segment_ids, num_segments: int, valid=None):
    """Sum of the valid rows of each segment: data (E, ...) -> (S, ...)."""
    data = _mask_rows(data, valid, 0.0)
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype, device=data.device)
    return out.index_add(0, segment_ids.long(), data)


def segment_max(data, segment_ids, num_segments: int, valid=None):
    """Largest valid row of each segment, elementwise; 0 for an empty one
    (as torch_scatter; the JAX package's segment_max gives -inf, then 0)."""
    data = _mask_rows(data, valid, _NEG)
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = torch.full((num_segments,) + data.shape[1:], _NEG, dtype=data.dtype,
                     device=data.device)
    out = out.scatter_reduce(0, idx, data, "amax", include_self=False)
    return torch.where(out <= _NEG / 2, torch.zeros_like(out), out)


def segment_mean(data, segment_ids, num_segments: int, valid=None):
    """Mean of the valid rows of each segment (count clamped at 1)."""
    ones = torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
    ones = _mask_rows(ones, valid, 0.0)
    total = segment_sum(data, segment_ids, num_segments, valid)
    count = segment_sum(ones, segment_ids, num_segments).clamp_min(1.0)
    return total / count.reshape(count.shape + (1,) * (total.dim() - 1))


def segment_softmax(scores, segment_ids, num_segments: int, valid=None):
    """Softmax of ``scores`` (E,) within each segment (torch_scatter's
    scatter_softmax, reference layers.py:249); invalid entries weigh 0, the
    denominator is clamped at 1e-16. The segment's largest score is the
    shift, held constant under autograd (the softmax does not depend on
    it)."""
    ids = segment_ids.long()
    scores = _mask_rows(scores, valid, _NEG)
    mx = torch.full((num_segments,), _NEG, dtype=scores.dtype, device=scores.device)
    mx = mx.scatter_reduce(0, ids, scores.detach(), "amax", include_self=False)
    mx = torch.where(mx <= _NEG / 2, torch.zeros_like(mx), mx)
    ex = _mask_rows(torch.exp(scores - mx[ids]), valid, 0.0)
    den = segment_sum(ex, ids, num_segments).clamp_min(1e-16)
    return ex / den[ids]


def segment_aggregate(data, segment_ids, num_segments: int, kind: str, valid=None):
    """``MPN.AGGR``: ``add``, ``max`` or ``mean`` over each segment."""
    ops = {"add": segment_sum, "max": segment_max, "mean": segment_mean}
    if kind not in ops:
        raise NotImplementedError(f"MPN.AGGR={kind!r}")
    return ops[kind](data, segment_ids, num_segments, valid)


def per_type_aggregate(data, target_ids, source_types, num_nodes: int, num_types: int,
                       kind: str, valid=None):
    """``kind`` (``MPN.AGGR``) over each (target, source type) group of
    valid edges: data (E, D) -> (N, T, D) (pemp_tpu/ops/segment.py:74-85)."""
    combined = target_ids.long() * num_types + source_types.long()
    out = segment_aggregate(data, combined, num_nodes * num_types, kind, valid)
    return out.reshape(num_nodes, num_types, data.shape[-1])


def per_type_attention_aggregate(data, attn_scores, target_ids, source_types,
                                 num_nodes: int, num_types: int, valid=None):
    """Softmax of ``attn_scores`` (E,) within each (target, source type)
    group, then the weighted sum of ``data`` (E, D) (reference layers.py:
    242-251). The softmax is taken in float32 (float64 for float64 data).
    Returns (N, T, D) in ``data``'s dtype."""
    combined = target_ids.long() * num_types + source_types.long()
    groups = num_nodes * num_types
    wide = torch.promote_types(data.dtype, torch.float32)
    w = segment_softmax(attn_scores.to(wide), combined, groups, valid)
    out = segment_sum(data.to(wide) * w[:, None], combined, groups, valid)
    return out.reshape(num_nodes, num_types, data.shape[-1]).to(data.dtype)


def blocked_aggregate(data, num_nodes: int, kind: str, valid=None):
    """data (N*C, D) in the target-major layout -> (N, D): ``kind`` over each
    node's valid slots (0 for none; the mean's count clamped at 1)."""
    d = data.shape[-1]
    x = data.reshape(num_nodes, -1, d)
    v = None if valid is None else valid.reshape(num_nodes, -1, 1).bool()
    if kind == "add":
        return (x if v is None else torch.where(v, x, torch.zeros_like(x))).sum(dim=1)
    if kind == "max":
        out = (x if v is None else torch.where(v, x, torch.full_like(x, _NEG))).amax(dim=1)
        return torch.where(out <= _NEG / 2, torch.zeros_like(out), out)
    if kind == "mean":
        if v is None:
            return x.sum(dim=1) / x.shape[1]
        total = torch.where(v, x, torch.zeros_like(x)).sum(dim=1)
        return total / v.sum(dim=1).to(x.dtype).clamp_min(1.0)
    raise NotImplementedError(f"MPN.AGGR={kind!r}")


def blocked_per_type_aggregate(data, source_types, num_nodes: int, num_types: int, kind: str,
                               valid=None):
    """(N*C, D) in the target-major layout -> (N, T, D): ``kind`` over each
    node's valid slots of each source type, 0 for none (the mean's count
    clamped at 1) (pemp_tpu/ops/segment.py:147-169). The sums are one-hot
    products as the JAX package's; the maximum is a scatter over the
    (node, type) groups, where the JAX package builds an (N, C, T, D)
    tensor."""
    d = data.shape[-1]
    c = data.shape[0] // num_nodes
    t = source_types.reshape(num_nodes, c).long()
    if kind == "max":
        node = torch.arange(num_nodes, device=data.device).repeat_interleave(c)
        return per_type_aggregate(data, node, t.reshape(-1), num_nodes, num_types, "max", valid)
    if kind not in ("add", "mean"):
        raise NotImplementedError(f"MPN.AGGR={kind!r}")
    hot = (t[:, :, None] == torch.arange(num_types, device=data.device)).to(data.dtype)
    if valid is not None:
        hot = hot * (valid.reshape(num_nodes, c, 1) != 0).to(data.dtype)
    out = torch.einsum("nct,ncd->ntd", hot, data.reshape(num_nodes, c, d))
    if kind == "mean":
        out = out / hot.sum(dim=1).clamp_min(1.0)[..., None]
    return out


def blocked_per_type_attention_aggregate(m, attn, types, num_nodes: int, num_types: int,
                                         valid=None):
    """Softmax of ``attn`` within each (node, source type) group of valid
    slots, then the weighted sum of the messages: out[n, t] = sum over
    n's valid type-t slots s of softmax(attn)[s] * m[s].

    m (N*C, D) messages in the target-major blocked layout (slot s belongs
    to node s // C); attn (N*C,) logits; types, valid (N*C,). The group's
    largest logit is the shift (held constant under autograd); an empty
    group gives 0 and the denominator is clamped at 1e-16. Computes in
    float32, as the TPU kernel pemp_tpu/ops/pallas/blocked_attn.py does,
    and returns (N, T, D) in ``m.dtype``. (The JAX package's jnp version
    computes its softmax in ``m.dtype``, so in bfloat16 the two differ by
    bfloat16 rounding.) Float64 messages are computed in float64.
    Differentiable by autograd.
    """
    e, d = m.shape
    c = e // num_nodes
    dev = m.device
    f32 = torch.promote_types(m.dtype, torch.float32)
    tv = types.reshape(num_nodes, c).long()
    hot = tv[:, :, None] == torch.arange(num_types, device=dev)          # (N, C, T)
    if valid is not None:
        hot = hot & (valid.reshape(num_nodes, c, 1) != 0)
    neg = torch.tensor(_NEG, dtype=f32, device=dev)
    scores = torch.where(hot, attn.reshape(num_nodes, c, 1).to(f32), neg)
    mx = torch.amax(scores, dim=1, keepdim=True).detach()
    mx = torch.where(mx <= _NEG / 2, torch.zeros_like(mx), mx)
    ex = torch.where(hot, torch.exp(scores - mx), torch.zeros_like(scores))
    w = ex / torch.clamp(ex.sum(dim=1, keepdim=True), min=1e-16)
    out = torch.einsum("nct,ncd->ntd", w, m.reshape(num_nodes, c, d).to(f32))
    return out.to(m.dtype)


def group_weights(logits, types, valid, num_nodes: int, num_types: int):
    """The softmax weights of the factored backwards, from the logits
    alone: per (node, type) group of valid slots the largest logit, e =
    exp(logit - max), den = max(sum of e, 1e-16) and w = e / den, in
    float32. Returns (ok, key, w): ok (E,) the valid slots, key (E,) each
    valid slot's group n * T + t (0 elsewhere), w (E,) (0 for the invalid
    slots)."""
    e = types.numel()
    dev = types.device
    ok = valid.reshape(-1) != 0
    node = torch.arange(e, device=dev) // (e // num_nodes)
    key = torch.where(ok, node * num_types + types.reshape(-1).long(), 0)
    groups = num_nodes * num_types
    kv = key[ok]
    lg = logits.reshape(-1).float()
    mx = torch.full((groups,), float("-inf"), device=dev).scatter_reduce(0, kv, lg[ok], "amax")
    ex = torch.where(ok, torch.exp(lg - mx[key]), 0.0)
    den = torch.zeros(groups, device=dev).index_add(0, kv, ex[ok]).clamp_min(1e-16)
    return ok, key, ex / den[key]
