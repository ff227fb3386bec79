"""K2 and K2b: the typed message + attention aggregation of the training
path, forward and backward (counterpart of
pemp_tpu.ops.pallas.fused_typed_message.fused_typed_message_aggregate).

``fused_typed_message_aggregate`` replaces the TPU kernels ``_kernel``
(via ``_fused_forward``'s ``pl.pallas_call``) and ``_bwd_kernel`` (via
``_fused_bwd_rule``'s). It is a ``torch.autograd.Function``: on CUDA
tensors its forward launches the hand-written Hopper kernel K2 and its
backward K2b (``csrc/typed_message.cu``), or raises; on CPU tensors it runs
``fused_typed_message_plain``, a plain PyTorch translation of
``_tile_forward``'s math, and autograd supplies the backward. There is no
fallback from one to the other.

Per slot s of target node n = s // C with source type t_s:

    m[s]      = relu(a[n, t_s] + ef[s] @ we[:, t_s])
    logit[s]  = ef[s] @ w_attn
    out[n, t] = softmax over n's valid type-t slots of logit, weighted sum of m

with an empty (n, t) group giving 0 and the softmax denominator clamped at
1e-16. Invalid slots contribute nothing, to any output or gradient.

Both kernels share one design (see the kernel source): a block owns one
type t and up to ``_CHUNK`` nodes, every ceil(N / _CHUNK)-th node; one
scan lists its type-t slots, and it works through them in batches of whole
nodes (up to 128 rows, 256 when C > 128) with register-tiled f32 products
on the CUDA cores. K2 writes each batch's pre over its ef rows, which
leaves room for three blocks per SM; K2b also takes the backward's steps
in each batch. Neither uses float atomics: two calls give the same bits.

Bound on an H100 (reckoned from the shapes, see the kernel source): at the
model_58_4 training shapes (B = 8: N = 5440, C = 80, T = 17, widths 64,
f32) with about 70 % of the slots valid, K2 moves ~128 MB and does ~2.6
GFLOP (~0.038 ms either way); K2b moves ~265 MB and does ~7.6 GFLOP
(~0.114 ms at the f32 rate: bound by operations).

K2 also has a bf16 form, for the ``pallas`` eval path: ef, a, we and
w_attn all bf16 (out stays float32), a kernel of its own on the tensor
cores (``mma.sync`` with bf16 inputs and float32 sums, as the TPU kernel's
bf16 branch runs the MXU): the same plan, with a coalesced scan, the ef
rows staged as bf16 by ``cp.async`` and a[n, t] added once a (node, type)
group that holds a slot, in the softmax step. bf16 products are exact in
float32, so it computes what the plain version computes on the same
inputs up to the order of the sums.
``FORMS`` says which form serves which dtype. K2b is float32 only: a bf16
input that needs a gradient is refused.

``LAUNCHES_FWD`` and ``LAUNCHES_BWD`` count kernel launches of either form
(the plain version does not count).
"""

from __future__ import annotations

import ctypes

import torch

from pemp_tpu_torch.ops.attn_aggregate import fused_attn_aggregate_plain

LAUNCHES_FWD = 0
LAUNCHES_BWD = 0

_WIDTH = 64                 # the kernels' one row width (kWidth in the source)
_MAX_SLOTS = 256            # C: one thread per slot in the type scan
_CHUNK = 64                 # most nodes per block (kChunkNodes in the source)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
FORMS = {
    torch.float32: "f32 CUDA-core form (typed_message_fwd: register-tiled rows, cp.async, "
                   "a block per (type, 64-node chunk))",
    torch.bfloat16: "bf16 tensor-core form (tc::typed_message_fwd_bf16: mma.sync m16n8k16, "
                    "ldmatrix, cp.async, coalesced scan, a block per (type, 64-node chunk))",
}


def fused_typed_message_plain(ef, a, types, valid, we, w_attn, num_nodes: int,
                              num_types: int):
    """Plain PyTorch version of K2 (the math of ``_tile_forward``): the
    typed projection onto every type and the selection of each slot's own,
    the logits, then K3's plain version (selection of a, ReLU, per-(node,
    type) softmax and weighted sum). Differentiable by autograd. Returns
    (N, T, D) float32 (float64 for float64 inputs, which the kernels do not
    take: a reference evaluation on the CPU)."""
    e = ef.shape[0]
    d = a.shape[-1]
    f32 = torch.promote_types(ef.dtype, torch.float32)
    tv = types.reshape(-1).long()
    b_all = (ef.to(f32) @ we.to(f32)).reshape(e, num_types, d)
    b_sel = torch.gather(b_all, 1, tv[:, None, None].expand(e, 1, d))[:, 0]
    logits = (ef.to(f32) @ w_attn[:, :1].to(f32))[:, 0]
    return fused_attn_aggregate_plain(b_sel, a, types, valid, logits, num_nodes, num_types)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_typed_message_aggregate: {msg}")


def _checked(ef, a, types, valid, we, w_attn, num_nodes, num_types):
    """Strict checks of what the kernels take; returns (E, C)."""
    floats = dict(ef=ef, a=a, we=we, w_attn=w_attn)
    ints = dict(types=types, valid=valid)
    for name, t in {**floats, **ints}.items():
        _check(t.device == ef.device, f"{name} is on {t.device}, ef on {ef.device}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    _check(ef.dtype in _DTYPES and all(t.dtype == ef.dtype for t in floats.values()),
           "ef, a, we and w_attn are " + ", ".join(str(t.dtype) for t in floats.values())
           + " (all float32, or all bfloat16 forward only)")
    e, w = ef.shape
    c = e // max(num_nodes, 1)
    _check(w == _WIDTH, f"row width {w} (the kernels are built for {_WIDTH})")
    _check(num_nodes > 0 and e == num_nodes * c, "E must be N * C")
    _check(0 < c <= _MAX_SLOTS, f"C = {c} slots per node (1 to {_MAX_SLOTS})")
    _check(0 < num_types <= 32, "1 to 32 types")
    for name, t in ints.items():
        _check(t.dtype == torch.int32 and t.numel() == e, f"{name} must be E int32")
    shapes = dict(a=(num_nodes, num_types, w), we=(w, num_types * w), w_attn=(w, 1))
    for name, shape in shapes.items():
        _check(tuple(floats[name].shape) == shape,
               f"{name} has shape {tuple(floats[name].shape)}, expected {shape}")
    return e, c


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _fn(symbol, argtypes):
    from pemp_tpu_torch.ops import _build

    return _build.function("typed_message", symbol, argtypes)


def _launch_forward(ef, a, types, valid, we, w_attn, num_nodes, num_types):
    global LAUNCHES_FWD
    _, c = _checked(ef, a, types, valid, we, w_attn, num_nodes, num_types)
    fn = _fn("pemp_typed_message_fwd", _FWD_ARGTYPES)
    out = torch.empty((num_nodes, num_types, _WIDTH), dtype=torch.float32, device=ef.device)
    # launch on the tensors' card, whichever is current
    with torch.cuda.device(ef.device):
        stream = torch.cuda.current_stream(ef.device).cuda_stream
        err = fn(_ptr(ef), _ptr(a), _ptr(types), _ptr(valid), _ptr(we), _ptr(w_attn), _ptr(out),
                 num_nodes, c, num_types, _DTYPES[ef.dtype], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"K2 (typed message forward) failed to launch: error {err}")
    LAUNCHES_FWD += 1
    return out


def _launch_backward(ef, a, types, valid, we, w_attn, g, num_nodes, num_types):
    global LAUNCHES_BWD
    e, c = _checked(ef, a, types, valid, we, w_attn, num_nodes, num_types)
    _check(ef.dtype == torch.float32,
           f"the backward kernel runs in float32 only (the inputs are {ef.dtype})")
    _check(g.device == ef.device and g.dtype == torch.float32 and g.is_contiguous()
           and tuple(g.shape) == tuple(a.shape), "g must match a (contiguous f32)")
    fn = _fn("pemp_typed_message_bwd", _BWD_ARGTYPES)
    chunks = -(-num_nodes // _CHUNK)
    dev = ef.device
    d_ef = torch.empty((e, _WIDTH), dtype=torch.float32, device=dev)  # K2b zeroes invalid slots
    da = torch.empty_like(a)
    dwe = torch.empty_like(we)
    dwa = torch.empty_like(w_attn)
    # per-(chunk, type) partial sums of dwe and dwa, summed in a fixed order
    # by the second launch: no atomics, the same bits on every run
    ws_we = torch.empty((chunks, num_types, _WIDTH, _WIDTH), dtype=torch.float32, device=dev)
    ws_wa = torch.empty((chunks, num_types, _WIDTH), dtype=torch.float32, device=dev)
    # launch on the tensors' card, whichever is current
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptr(ef), _ptr(a), _ptr(types), _ptr(valid), _ptr(we), _ptr(w_attn), _ptr(g),
                 _ptr(d_ef), _ptr(da), _ptr(dwe), _ptr(dwa), _ptr(ws_we), _ptr(ws_wa),
                 num_nodes, c, num_types, _CHUNK, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"K2b (typed message backward) failed to launch: error {err}")
    LAUNCHES_BWD += 1
    return d_ef, da, dwe, dwa


class _TypedMessage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ef, a, types, valid, we, w_attn, num_nodes, num_types):
        ctx.save_for_backward(ef, a, types, valid, we, w_attn)
        ctx.dims = (num_nodes, num_types)
        return _launch_forward(ef, a, types, valid, we, w_attn, num_nodes, num_types)

    @staticmethod
    def backward(ctx, g):
        ef, a, types, valid, we, w_attn = ctx.saved_tensors
        d_ef, da, dwe, dwa = _launch_backward(ef, a, types, valid, we, w_attn,
                                              g.contiguous(), *ctx.dims)
        return d_ef, da, None, None, dwe, dwa, None, None


def fused_typed_message_aggregate(ef, a, types, valid, we, w_attn, num_nodes: int,
                                  num_types: int):
    """Typed message + attention aggregation, differentiable in ef, a, we
    and w_attn. Returns (N, T, D) float32.

    ef (E, De) post-MLP edge features; a (N, T, D) node part including the
    per-type bias; types, valid (E,) int32; we (De, T*D) with
    we[k, t*D + o] the weight of type t; w_attn (De, 1). ef, a, we and
    w_attn are all float32, or all bfloat16 where no gradient is needed
    (eval). On CUDA tensors K2 runs forward and K2b backward; on CPU
    tensors the plain version.
    """
    if ef.device.type == "cpu":
        return fused_typed_message_plain(ef, a, types, valid, we, w_attn, num_nodes, num_types)
    if ef.device.type != "cuda":
        raise ValueError(f"fused_typed_message_aggregate: unsupported device {ef.device}")
    _check(ef.dtype == torch.float32 or not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (ef, a, we, w_attn))),
        "the bfloat16 form is forward only (K2b runs in float32 only)")
    return _TypedMessage.apply(ef, a, types, valid, we, w_attn, num_nodes, num_types)
