"""K3 and K3b: the slim attention aggregation of the hybrid message path,
forward and backward (counterpart of
pemp_tpu.ops.pallas.fused_typed_message.fused_attn_aggregate).

``fused_attn_aggregate`` replaces the TPU kernels ``_attn_kernel`` (via
``_attn_forward``'s ``pl.pallas_call``) and ``_attn_bwd_kernel`` (via
``_attn_bwd_rule``'s). It is a ``torch.autograd.Function``: on CUDA
tensors its forward launches the hand-written Hopper kernel K3 and its
backward K3b (``csrc/attn_aggregate.cu``), or raises; on CPU tensors it
runs ``fused_attn_aggregate_plain``, a plain PyTorch translation of
``_attn_tile``'s math, and autograd supplies the backward. There is no
fallback from one to the other.

Per slot s of target node n = s // C with source type t_s:

    m[s]      = relu(a[n, t_s] + b[s])
    out[n, t] = softmax over n's valid type-t slots of logits, weighted sum of m

with an empty (n, t) group giving 0 and the softmax denominator clamped at
1e-16. The typed projection ``b`` and the logits come from the caller.
Invalid slots contribute nothing, to any output or gradient.

The kernels are node-major: a warp owns one node for all its types, takes
the softmax weights w from the logits alone, then reads the node's valid b
rows once. K3 writes out[n] whole (T rows, zeros for the empty groups). K3b
writes da[n] whole and db and dlogit for all C slots of n (zeros for the
slots of no group), from ``fused_attn_aggregate_bwd_plain``'s factored
math, so the wrapper allocates all outputs with ``torch.empty`` and
launches nothing else. Each warp stages the node's T rows of a (and g) in
shared memory. T is at most 32 (lane t keeps type t's scalars) and C at
most 256.

Bound on an H100 (reckoned from the shapes, see the kernel source): at the
model_58_4 training shapes (B = 8: N = 5440, C = 80, T = 17, width 64,
f32) with about 70 % of the slots valid, K3 moves ~130 MB (~0.039 ms) and
K3b ~266 MB (~0.080 ms): the valid b rows, a, g and the index columns read
once, every output written once. Both are bound by bytes.

``LAUNCHES_FWD`` and ``LAUNCHES_BWD`` count kernel launches (the plain
versions do not count).
"""

from __future__ import annotations

import ctypes

import torch

from pemp_tpu_torch.ops.segment import blocked_per_type_attention_aggregate, group_weights

LAUNCHES_FWD = 0
LAUNCHES_BWD = 0

_WIDTH = 64                 # the kernels' one row width (kWidth in the source)
_MAX_SLOTS = 256            # C (kMaxSlots in the source)
_MAX_TYPES = 32             # T: lane t of a warp keeps type t's scalars
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def fused_attn_aggregate_plain(b, a, types, valid, logits, num_nodes: int, num_types: int):
    """Plain PyTorch version of K3 (the math of ``_attn_tile``): a[n, t_s]
    selected exactly and added to b in float32, ReLU, then the per-(node,
    type) softmax and weighted sum of ops.segment. Differentiable by
    autograd. Returns (N, T, D) float32 (float64 for float64 inputs)."""
    e, d = b.shape
    c = e // num_nodes
    node = torch.arange(e, device=b.device) // c
    wide = torch.promote_types(b.dtype, torch.float32)
    a_sel = a.reshape(num_nodes, num_types, d).to(wide)[node, types.reshape(-1).long()]
    m = torch.relu(a_sel + b.to(wide))
    return blocked_per_type_attention_aggregate(m, logits.reshape(-1), types, num_nodes,
                                                num_types, valid)


def fused_attn_aggregate_bwd_plain(b, a, types, valid, logits, g, num_nodes: int,
                                   num_types: int):
    """Plain PyTorch version of K3b's factored backward, without autograd:
    the scalars from the logits alone (per-(node, type) max, e, den, w =
    e / den), then per valid slot pre = a[n, t_s] + b[s], db = w g[n, t_s]
    1[pre > 0], u = <g[n, t_s], relu(pre)>, da[n, t] = sum of db, q[n, t]
    = sum of w u and dlogit = w (u - q[n, t_s]). The slots of no group get
    zero db and dlogit, the empty groups zero da. Returns (db, da, dlogit)
    in float32, shaped as b, a and logits."""
    d = b.shape[1]
    groups = num_nodes * num_types
    ok, key, w = group_weights(logits, types, valid, num_nodes, num_types)
    kv = key[ok]
    pre = a.reshape(groups, d).float()[key] + b.float()
    g_sel = g.reshape(groups, d).float()[key]
    db = torch.where(ok[:, None] & (pre > 0), w[:, None] * g_sel, 0.0)
    u = (g_sel * torch.relu(pre)).sum(1)
    da = torch.zeros(groups, d, device=b.device).index_add(0, kv, db[ok])
    q = torch.zeros(groups, device=b.device).index_add(0, kv, (w * u)[ok])
    dlogit = torch.where(ok, w * (u - q[key]), 0.0)
    return db, da.view(a.shape), dlogit.view(logits.shape)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_attn_aggregate: {msg}")


def _checked(b, a, types, valid, logits, num_nodes, num_types):
    """Strict checks of what the kernels take; returns C."""
    for name, t in dict(b=b, a=a, types=types, valid=valid, logits=logits).items():
        _check(t.device == b.device, f"{name} is on {t.device}, b on {b.device}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    _check(b.dtype in _DTYPES and a.dtype == b.dtype,
           f"b and a are {b.dtype} and {a.dtype} (both float32 or both bfloat16)")
    e, w = b.shape
    c = e // max(num_nodes, 1)
    _check(w == _WIDTH, f"row width {w} (the kernels are built for {_WIDTH})")
    _check(num_nodes > 0 and e == num_nodes * c, "E must be N * C")
    _check(0 < c <= _MAX_SLOTS, f"C = {c} slots per node (1 to {_MAX_SLOTS})")
    _check(0 < num_types <= _MAX_TYPES, f"T = {num_types} types (1 to {_MAX_TYPES})")
    _check(tuple(a.shape) == (num_nodes, num_types, w),
           f"a has shape {tuple(a.shape)}, expected {(num_nodes, num_types, w)}")
    for name, t in dict(types=types, valid=valid).items():
        _check(t.dtype == torch.int32 and t.numel() == e, f"{name} must be E int32")
    _check(logits.dtype == torch.float32 and logits.numel() == e, "logits must be E float32")
    _check(a.data_ptr() % 16 == 0 and b.data_ptr() % 8 == 0,
           "a must be 16-byte and b 8-byte aligned (cp.async and paired loads)")
    return c


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _fn(symbol, argtypes):
    from pemp_tpu_torch.ops import _build

    return _build.function("attn_aggregate", symbol, argtypes)


def _launch_forward(b, a, types, valid, logits, num_nodes, num_types):
    global LAUNCHES_FWD
    c = _checked(b, a, types, valid, logits, num_nodes, num_types)
    fn = _fn("pemp_attn_aggregate_fwd", _FWD_ARGTYPES)
    out = torch.empty((num_nodes, num_types, _WIDTH), dtype=torch.float32, device=b.device)
    # launch on the tensors' card, whichever is current
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = fn(_ptr(b), _ptr(a), _ptr(types), _ptr(valid), _ptr(logits), _ptr(out),
                 num_nodes, c, num_types, _DTYPES[b.dtype], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"K3 (attention aggregation forward) failed to launch: error {err}")
    LAUNCHES_FWD += 1
    return out


def _launch_backward(b, a, types, valid, logits, g, num_nodes, num_types):
    global LAUNCHES_BWD
    c = _checked(b, a, types, valid, logits, num_nodes, num_types)
    _check(b.dtype == torch.float32,
           f"the backward kernel runs in float32 only (b and a are {b.dtype})")
    _check(g.device == b.device and g.dtype == torch.float32 and g.is_contiguous()
           and tuple(g.shape) == tuple(a.shape) and g.data_ptr() % 16 == 0,
           "g must match a (contiguous f32, 16-byte aligned)")
    fn = _fn("pemp_attn_aggregate_bwd", _BWD_ARGTYPES)
    db = torch.empty_like(b)                       # all three written whole by K3b
    dlogit = torch.empty_like(logits)
    da = torch.empty_like(a)
    # launch on the tensors' card, whichever is current
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = fn(_ptr(b), _ptr(a), _ptr(types), _ptr(valid), _ptr(logits), _ptr(g), _ptr(db),
                 _ptr(da), _ptr(dlogit), num_nodes, c, num_types, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"K3b (attention aggregation backward) failed to launch: error {err}")
    LAUNCHES_BWD += 1
    return db, da, dlogit


class _AttnAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, a, types, valid, logits, num_nodes, num_types):
        ctx.save_for_backward(b, a, types, valid, logits)
        ctx.dims = (num_nodes, num_types)
        return _launch_forward(b, a, types, valid, logits, num_nodes, num_types)

    @staticmethod
    def backward(ctx, g):
        b, a, types, valid, logits = ctx.saved_tensors
        db, da, dlogit = _launch_backward(b, a, types, valid, logits, g.contiguous(), *ctx.dims)
        return db, da, None, None, dlogit, None, None


def fused_attn_aggregate(b, a, types, valid, logits, num_nodes: int, num_types: int):
    """Selection, ReLU, per-(node, type) softmax and aggregation,
    differentiable in b, a and logits. Returns (N, T, D) float32.

    b (E, D) the typed edge projection; a (N, T, D) node part including the
    per-type bias, in b's dtype (float32, or bfloat16 at eval: the backward
    takes float32 only); types, valid (E,) int32; logits (E,) float32. On
    CUDA tensors K3 runs forward and K3b backward; on CPU tensors the plain
    version.
    """
    if b.device.type == "cpu":
        return fused_attn_aggregate_plain(b, a, types, valid, logits, num_nodes, num_types)
    if b.device.type != "cuda":
        raise ValueError(f"fused_attn_aggregate: unsupported device {b.device}")
    return _AttnAggregate.apply(b, a, types, valid, logits, num_nodes, num_types)
