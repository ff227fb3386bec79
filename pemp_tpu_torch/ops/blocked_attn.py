"""K4: the blocked per-type attention aggregate of the einsum message path
(counterpart of
pemp_tpu.ops.pallas.blocked_attn.blocked_per_type_attention_aggregate_pallas).

``blocked_attn_aggregate`` replaces the TPU kernel ``_kernel`` (via
``blocked_per_type_attention_aggregate_pallas``'s ``pl.pallas_call``). On
CUDA tensors it launches the hand-written Hopper kernel K4
(``csrc/blocked_attn.cu``) or raises; on CPU tensors it runs the plain
version, ops.segment.blocked_per_type_attention_aggregate. There is no
fallback from one to the other. Forward only, as the TPU kernel: the JAX
package trains the einsum path through its jnp aggregate, and the port's
training path does not run this route (config.ROUTES), so a call that
needs a gradient on the card raises.

The kernel is node-major, on K3's design: a warp owns one node for all
its types, takes the softmax weights from the logits alone, then reads the
node's valid message rows once, sorted by type, and writes each (n, t) row
once (zeros for an empty group), so the wrapper allocates the output with
``torch.empty``. T is at most 32, since lane t of a warp keeps type t's
scalars: the einsum path's types are the joint types
(``models.mpn.layers.num_summary_types``: 17 on COCO, 14 on CrowdPose, or
the 9 or 6 summary types), so no configuration of the repo needs more. C
is at most 256.

Bound on an H100 (see the kernel source): it reads the valid slots' message
rows, the logit and index columns and writes (N, T, D); bound by bytes.

``LAUNCHES`` counts kernel launches (the plain version does not count).
"""

from __future__ import annotations

import ctypes

import torch

from pemp_tpu_torch.ops.segment import blocked_per_type_attention_aggregate

LAUNCHES = 0

_WIDTH = 64                 # the kernel's one row width (kWidth in the source)
_MAX_SLOTS = 256            # C (kMaxSlots in the source)
_MAX_TYPES = 32             # T: lane t of a warp keeps type t's scalars
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_WARPS_ARGTYPES = [ctypes.c_int] * 2


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"blocked_attn_aggregate: {msg}")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def blocked_attn_aggregate(m, attn, types, num_nodes: int, num_types: int, valid):
    """Per-(node, source type) softmax of ``attn`` over the valid slots and
    the weighted sum of the messages ``m`` (E, D), computed in float32;
    returns (N, T, D) in ``m.dtype``. attn (E,) is read as float32; types
    and valid (E,) int32. On CUDA tensors K4, on CPU tensors the plain
    version."""
    global LAUNCHES
    if m.device.type == "cpu":
        return blocked_per_type_attention_aggregate(m, attn, types, num_nodes, num_types, valid)
    _check(m.device.type == "cuda", f"unsupported device {m.device}")
    _check(not (torch.is_grad_enabled() and (m.requires_grad or attn.requires_grad)),
           "K4 has no backward kernel: call it without gradients")
    attn = attn.reshape(-1).float().contiguous()
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
    for name, t in dict(types=types, valid=valid, attn=attn).items():
        _check(t.numel() == e, f"{name} must have E elements")
    for name, t in dict(types=types, valid=valid).items():
        _check(t.dtype == torch.int32, f"{name} must be int32")
    _check(m.data_ptr() % (2 * m.element_size()) == 0,
           "m must be aligned to two of its values (a lane's paired loads)")

    from pemp_tpu_torch.ops import _build

    fn = _build.function("blocked_attn", "pemp_blocked_attn_fwd", _ARGTYPES)
    out = torch.empty((num_nodes, num_types, _WIDTH), dtype=m.dtype, device=m.device)
    stream = torch.cuda.current_stream(m.device).cuda_stream
    err = fn(_ptr(m), _ptr(attn), _ptr(types), _ptr(valid), _ptr(out), num_nodes, c, num_types,
             _DTYPES[m.dtype], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"K4 (blocked attention aggregate) failed to launch: error {err}")
    LAUNCHES += 1
    return out


def resident_warps(c: int, dtype) -> int:
    """How many warps of K4 (one node each) one SM of the current card
    holds at once at C slots per node, for m of ``dtype``; -1 if the card
    does not say."""
    from pemp_tpu_torch.ops import _build

    fn = _build.function("blocked_attn", "pemp_blocked_attn_resident_warps", _WARPS_ARGTYPES)
    return fn(c, _DTYPES[dtype])
