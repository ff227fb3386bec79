"""G1: the edge MLP's source-row gather with an exact per-image backward
(counterpart of pemp_tpu.ops.gather_mm).

The forward is ``x[j]``. Its backward is the per-image sum of the JAX
package's ``gather_rows_mm`` (pemp_tpu/ops/gather_mm.py:79-99):

    dx[b * n_img + n] = sum over image b's slots e with j[e] % n_img == n of g[e]

accumulated in float32 and returned in x's dtype, with the same bits on two
calls. The image of slot e is e // (E / B), as in JAX, so a slot whose index
left its image would land where JAX puts it. The TPU form is a one-hot
contraction on the matrix unit; here the contract is ported, not that form.
A plan built once per forward from ``j`` (:func:`gather_plan`: the key
b * n_img + j % n_img, a stable order of the slots by it, and that order
cut into pieces of at most ``PIECE`` slots of one row) serves every step's
gather, since the source indices are the same in all of them, so the sort
is paid once a forward.

The pieces keep the work even: the kNN layout points every invalid slot of
an image at the image's node 0, so that row is named by thousands of slots
where the others have ~C. Each piece is summed in slot order, then each
row's pieces in order, in f32: a fixed order, so two calls give the same
bits.

On CUDA tensors the backward launches G1 (``csrc/gather_rows.cu``): a warp
per piece reads its g rows in plan order, 8 in flight, and writes the f32
sum to a workspace; a second launch, a warp per destination row, sums the
row's pieces and writes the row once in x's dtype (zeros where no slot
names it), so the output is allocated with ``torch.empty``. On CPU tensors
it runs :func:`gather_rows_bwd_plain`, the same two sums by f32
``index_add_``. There is no fallback from one to the other. G1 has no
Pallas source: the JAX backward is a ``dot_general`` outside Pallas.

Bound on an H100 (see the kernel source): at the model_58_4 training shapes
(B = 8: N = 5440, E = 435,200, width 64, f32) it reads g (111 MB) and the
plan (~1.8 MB) and writes dx (1.4 MB): ~0.034 ms at 3.35 TB/s, bound by
bytes.

``LAUNCHES`` counts kernel launches (the plain version does not count).
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0
PIECE = 64                  # most slots of a piece (the kernel takes any)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _starts(counts):
    """(len + 1,) int64: 0, then the running sum of ``counts``."""
    out = torch.zeros(counts.numel() + 1, dtype=torch.int64, device=counts.device)
    torch.cumsum(counts, 0, out=out[1:])
    return out


def gather_plan(j, n_img: int, num_rows: int) -> dict:
    """The backward's plan for gathering rows ``j`` (E,) of an (N, D) x,
    N = ``num_rows`` = B * n_img:

    - ``key`` (E,) int64: b * n_img + j % n_img for slot e of image
      b = e // (E / B), the row slot e's gradient goes to;
    - ``order`` (E,) int32: the slots sorted by key, stably (slot order
      within a row);
    - ``piece`` (E,) int64: each slot's piece, the pieces numbered in
      order, each a run of at most ``PIECE`` consecutive positions of
      ``order`` within one row;
    - ``bounds`` (K + 1,) int32: each piece's first position, then E;
    - ``row_pieces`` (N + 1,) int32: each row's first piece, then K (a row
      no slot names has none);
    - ``piece_row`` (K,) int64: each piece's row."""
    e = j.numel()
    dev = j.device
    e_img = e // (num_rows // n_img)
    slot = torch.arange(e, device=dev)
    key = torch.div(slot, e_img, rounding_mode="floor") * n_img + j.reshape(-1).long() % n_img
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=num_rows)
    first = _starts(counts)
    row_pieces = _starts(torch.div(counts + PIECE - 1, PIECE, rounding_mode="floor"))
    sorted_key = key[order]
    piece_sorted = row_pieces[sorted_key] + torch.div(
        slot - first[sorted_key], PIECE, rounding_mode="floor")
    piece = torch.empty_like(piece_sorted).scatter_(0, order, piece_sorted)
    bounds = _starts(torch.bincount(piece_sorted))
    return {"key": key, "order": order.to(torch.int32), "piece": piece,
            "bounds": bounds.to(torch.int32), "row_pieces": row_pieces.to(torch.int32),
            "piece_row": sorted_key[bounds[:-1]]}


def gather_rows_bwd_plain(g, plan, num_rows: int, dtype):
    """Plain PyTorch version of G1: the rows of ``g`` (E, D) summed in
    float32 by the plan's pieces, then the pieces by their rows
    (``index_add_``, each in slot or piece order on the CPU), cast to
    ``dtype``; float64 rows are summed in float64. Returns (N, D)."""
    d = g.shape[1]
    acc = torch.promote_types(g.dtype, torch.float32)
    parts = torch.zeros((plan["piece_row"].numel(), d), dtype=acc, device=g.device)
    parts.index_add_(0, plan["piece"], g.to(acc))
    dx = torch.zeros((num_rows, d), dtype=acc, device=g.device)
    return dx.index_add_(0, plan["piece_row"], parts).to(dtype)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"gather_rows_mm backward: {msg}")


def gather_rows_bwd(g, plan, num_rows: int, dtype):
    """dx (N, D) in ``dtype`` from the cotangent ``g`` (E, D) of the
    gather: on CUDA tensors G1, on CPU tensors the plain version."""
    global LAUNCHES
    if g.device.type == "cpu":
        return gather_rows_bwd_plain(g, plan, num_rows, dtype)
    _check(g.device.type == "cuda", f"unsupported device {g.device}")
    order, bounds, row_pieces = plan["order"], plan["bounds"], plan["row_pieces"]
    e, d = g.shape
    pieces = bounds.numel() - 1
    _check(g.dtype in _DTYPES and g.dtype == dtype,
           f"g is {g.dtype} and x {dtype} (both float32 or both bfloat16)")
    for name, t in dict(g=g, order=order, bounds=bounds, row_pieces=row_pieces).items():
        _check(t.device == g.device, f"{name} is on {t.device}, g on {g.device}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
        _check(name == "g" or t.dtype == torch.int32, f"{name} must be int32")
    _check(order.numel() == e and row_pieces.numel() == num_rows + 1,
           "the plan must be of E slots and N rows")
    _check(d % 2 == 0 and g.data_ptr() % (2 * g.element_size()) == 0,
           "g's rows must be an even width, aligned to two of its values")

    from pemp_tpu_torch.ops import _build

    fn = _build.function("gather_rows", "pemp_gather_rows_bwd", _ARGTYPES)
    parts = torch.empty((pieces, d), dtype=torch.float32, device=g.device)   # each written once
    dx = torch.empty((num_rows, d), dtype=dtype, device=g.device)           # written whole
    # launch on the tensors' card, whichever is current
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        ptrs = (ctypes.c_void_p(t.data_ptr()) for t in (g, order, bounds, row_pieces, parts, dx))
        err = fn(*ptrs, num_rows, pieces, d, _DTYPES[dtype], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"G1 (gather backward) failed to launch: error {err}")
    LAUNCHES += 1
    return dx


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, j, plan):
        ctx.plan = plan
        ctx.rows = (x.shape[0], x.dtype)
        return x[j]

    @staticmethod
    def backward(ctx, g):
        return gather_rows_bwd(g.contiguous(), ctx.plan, *ctx.rows), None, None


def gather_rows_mm(x, j, n_img: int, plan=None):
    """``x[j]`` with the exact per-image backward. x (N, D), N a multiple of
    ``n_img``; j (E,) int64 row indices, E a multiple of the batch N //
    n_img, each inside its slot's image. ``plan`` is :func:`gather_plan` of
    (j, n_img, N), built once per forward by the caller; it is needed only
    where a gradient can flow."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x[j]
    if plan is None:
        raise ValueError("gather_rows_mm: a gradient can flow, so it needs the forward's "
                         "gather_plan(j, n_img, N)")
    return _GatherRows.apply(x, j, plan)


def gather_rows_mm_or_plain(x, j, n_img: int, plan=None):
    """``x[j]``, through :func:`gather_rows_mm` where the layout allows (the
    JAX package's eligibility rule). When ``n_img`` is 0 or does not divide
    N, a CPU tensor takes the plain gather and any other a ValueError (the
    card runs G1 or nothing); when E is not a multiple of the batch, a
    ValueError."""
    if not n_img or x.shape[0] % n_img != 0:
        if x.device.type != "cpu":
            raise ValueError(f"gather_rows_mm needs image-major rows on {x.device}: "
                             f"N={x.shape[0]} is not a multiple of n_img={n_img}")
        return x[j]
    b = x.shape[0] // n_img
    if j.shape[0] % b != 0:
        raise ValueError(
            f"gather_rows_mm needs image-major blocked edges: E={j.shape[0]} "
            f"not divisible by batch={b} (N={x.shape[0]}, n_img={n_img})")
    return gather_rows_mm(x, j, n_img, plan)
