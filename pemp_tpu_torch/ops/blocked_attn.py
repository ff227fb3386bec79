"""K4 and K4b: the blocked per-type attention aggregate of the einsum and
dots message paths, forward and backward (counterpart of
pemp_tpu.ops.pallas.blocked_attn.blocked_per_type_attention_aggregate_pallas).

``blocked_attn_aggregate`` replaces the TPU kernel ``_kernel`` (via
``blocked_per_type_attention_aggregate_pallas``'s ``pl.pallas_call``). It
is a ``torch.autograd.Function``: on CUDA tensors its forward launches the
hand-written Hopper kernel K4 and its backward K4b
(``csrc/blocked_attn.cu``), or raises; on CPU tensors it runs the plain
version, ops.segment.blocked_per_type_attention_aggregate, and autograd
supplies the backward. There is no fallback from one to the other. K4b
has no Pallas source: the JAX package trains these routes by
differentiating its jnp aggregate (pemp_tpu/ops/segment.py:172-195).
``blocked_attn_aggregate_bwd_plain`` is K4b's factored math in PyTorch.

The kernels are node-major, on K3's and K3b's design: a warp owns one node
for all its types and takes the softmax weights from the logits alone. K4
reads the node's valid message rows once, sorted by type, and writes each
(n, t) row once (zeros for an empty group). K4b stages g[n], reads the
same rows once and writes dm and dlogit for all C slots of n (zeros for
the slots of no group). Every output is written whole, so the wrapper
allocates with ``torch.empty``. T is at most 32, since lane t of a warp
keeps type t's scalars: the types are the joint types
(``models.mpn.layers.num_summary_types``: 17 on COCO, 14 on CrowdPose, or
the 9 or 6 summary types), so no configuration of the repo needs more. C
is at most 256. The backward runs in float32 only (training is float32).

Bound on an H100 (see the kernel source): K4 reads the valid slots'
message rows and the logit and index columns and writes (N, T, D); K4b
also reads g and writes every dm row and dlogit; both bound by bytes.

``LAUNCHES`` and ``LAUNCHES_BWD`` count kernel launches (the plain
versions do not count).
"""

from __future__ import annotations

import ctypes

import torch

from pemp_tpu_torch.ops.segment import blocked_per_type_attention_aggregate, group_weights

LAUNCHES = 0
LAUNCHES_BWD = 0

_WIDTH = 64                 # the kernels' one row width (kWidth in the source)
_MAX_SLOTS = 256            # C (kMaxSlots in the source)
_MAX_TYPES = 32             # T: lane t of a warp keeps type t's scalars
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_WARPS_ARGTYPES = [ctypes.c_int] * 2


def blocked_attn_aggregate_bwd_plain(m, attn, types, valid, g, num_nodes: int,
                                     num_types: int):
    """Plain PyTorch version of K4b's factored backward, without autograd:
    the weights w from the logits alone (ops.segment.group_weights), then
    per valid slot dm = w g[n, t_s], u = <g[n, t_s], m[s]>, q[n, t] = sum
    of w u and dlogit = w (u - q[n, t_s]). The slots of no group get zero
    dm and dlogit. Returns (dm, dlogit) in float32, shaped as m and attn."""
    d = m.shape[1]
    groups = num_nodes * num_types
    ok, key, w = group_weights(attn, types, valid, num_nodes, num_types)
    g_sel = g.reshape(groups, d).float()[key]
    dm = torch.where(ok[:, None], w[:, None] * g_sel, 0.0)
    u = (g_sel * m.float()).sum(1)
    q = torch.zeros(groups, device=m.device).index_add(0, key[ok], (w * u)[ok])
    dlogit = torch.where(ok, w * (u - q[key]), 0.0)
    return dm, dlogit.view(attn.shape)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"blocked_attn_aggregate: {msg}")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _checked(m, attn, types, valid, num_nodes, num_types):
    """Strict checks of what the kernels take; returns C."""
    for name, t in dict(m=m, attn=attn, types=types, valid=valid).items():
        _check(t.device == m.device, f"{name} is on {t.device}, m on {m.device}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    _check(m.dtype in _DTYPES, f"m is {m.dtype} (float32 or bfloat16)")
    e, w = m.shape
    c = e // max(num_nodes, 1)
    _check(w == _WIDTH, f"row width {w} (the kernel is built for {_WIDTH})")
    _check(num_nodes > 0 and e == num_nodes * c, "E must be N * C")
    _check(0 < c <= _MAX_SLOTS, f"C = {c} slots per node (1 to {_MAX_SLOTS})")
    _check(0 < num_types <= _MAX_TYPES, f"T = {num_types} types (1 to {_MAX_TYPES})")
    _check(attn.dtype == torch.float32 and attn.numel() == e, "attn must be E float32")
    for name, t in dict(types=types, valid=valid).items():
        _check(t.dtype == torch.int32 and t.numel() == e, f"{name} must be E int32")
    _check(m.data_ptr() % (2 * m.element_size()) == 0,
           "m must be aligned to two of its values (a lane's paired loads)")
    return c


def _fn(symbol, argtypes):
    from pemp_tpu_torch.ops import _build

    return _build.function("blocked_attn", symbol, argtypes)


def _launch_forward(m, attn, types, valid, num_nodes, num_types):
    global LAUNCHES
    c = _checked(m, attn, types, valid, num_nodes, num_types)
    fn = _fn("pemp_blocked_attn_fwd", _ARGTYPES)
    out = torch.empty((num_nodes, num_types, _WIDTH), dtype=m.dtype, device=m.device)
    stream = torch.cuda.current_stream(m.device).cuda_stream
    err = fn(_ptr(m), _ptr(attn), _ptr(types), _ptr(valid), _ptr(out), num_nodes, c, num_types,
             _DTYPES[m.dtype], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"K4 (blocked attention aggregate) failed to launch: error {err}")
    LAUNCHES += 1
    return out


def _launch_backward(m, attn, types, valid, g, num_nodes, num_types):
    global LAUNCHES_BWD
    c = _checked(m, attn, types, valid, num_nodes, num_types)
    _check(m.dtype == torch.float32,
           f"the backward kernel runs in float32 only (m is {m.dtype})")
    _check(g.device == m.device and g.dtype == torch.float32 and g.is_contiguous()
           and tuple(g.shape) == (num_nodes, num_types, _WIDTH) and g.data_ptr() % 16 == 0,
           "g must be (N, T, 64) contiguous float32, 16-byte aligned")
    fn = _fn("pemp_blocked_attn_bwd", _BWD_ARGTYPES)
    dm = torch.empty_like(m)                       # both written whole by K4b
    dlogit = torch.empty_like(attn)
    stream = torch.cuda.current_stream(m.device).cuda_stream
    err = fn(_ptr(m), _ptr(attn), _ptr(types), _ptr(valid), _ptr(g), _ptr(dm), _ptr(dlogit),
             num_nodes, c, num_types, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"K4b (blocked attention backward) failed to launch: error {err}")
    LAUNCHES_BWD += 1
    return dm, dlogit


class _BlockedAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, attn, types, valid, num_nodes, num_types):
        ctx.save_for_backward(m, attn, types, valid)
        ctx.dims = (num_nodes, num_types)
        return _launch_forward(m, attn, types, valid, num_nodes, num_types)

    @staticmethod
    def backward(ctx, g):
        m, attn, types, valid = ctx.saved_tensors
        dm, dlogit = _launch_backward(m, attn, types, valid, g.contiguous(), *ctx.dims)
        return dm, dlogit, None, None, None, None


def blocked_attn_aggregate(m, attn, types, num_nodes: int, num_types: int, valid):
    """Per-(node, source type) softmax of ``attn`` over the valid slots and
    the weighted sum of the messages ``m`` (E, D), computed in float32;
    returns (N, T, D) in ``m.dtype``, differentiable in m and attn (in
    float32). attn (E,) is read as float32; types and valid (E,) int32. On
    CUDA tensors K4 forward and K4b backward, on CPU tensors the plain
    version."""
    if m.device.type == "cpu":
        return blocked_per_type_attention_aggregate(m, attn, types, num_nodes, num_types, valid)
    _check(m.device.type == "cuda", f"unsupported device {m.device}")
    attn = attn.reshape(-1).float().contiguous()
    return _BlockedAttn.apply(m, attn, types, valid, num_nodes, num_types)


def resident_warps(c: int, dtype) -> int:
    """How many warps of K4 (one node each) one SM of the current card
    holds at once at C slots per node, for m of ``dtype``; -1 if the card
    does not say."""
    fn = _fn("pemp_blocked_attn_resident_warps", _WARPS_ARGTYPES)
    return fn(c, _DTYPES[dtype])
