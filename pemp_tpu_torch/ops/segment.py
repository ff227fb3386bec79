"""The blocked per-type attention aggregate (counterpart of
pemp_tpu.ops.segment.blocked_per_type_attention_aggregate).

It is the plain version of K4 (``ops.blocked_attn``), the einsum and dots
message paths' aggregate on CPU tensors, and the softmax-and-sum part of
the plain versions of K3 (``ops.attn_aggregate``) and K2
(``ops.typed_message``). :func:`group_weights` is the scalar part of the
factored plain backwards of K3b and K4b.
"""

from __future__ import annotations

import torch

_NEG = -1e30


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
    bfloat16 rounding.) Differentiable by autograd.
    """
    e, d = m.shape
    c = e // num_nodes
    dev = m.device
    f32 = torch.float32
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
