"""K1 and K1b: the fully fused flagship MPN step and its edge MLP's
backward (counterpart of pemp_tpu.ops.pallas.fused_step).

``fused_mpn_step`` replaces the TPU kernel ``_step_kernel``
(pemp_tpu/ops/pallas/fused_step.py, via ``_step_forward``'s
``pl.pallas_call``). On a CUDA tensor it launches the hand-written Hopper
kernel in ``csrc/fused_step.cu`` or raises; on a CPU tensor it runs
``fused_mpn_step_plain``, a plain PyTorch translation of the JAX
package's ``step_reference``, which autograd differentiates. There is no
fallback from one to the other.

Where a gradient can flow on the card, the step is a
``torch.autograd.Function`` (float32 only; a bf16 input that needs a
gradient is refused). Its forward is K1's float32 form; it saves the
inputs and the new edge carry ``ne`` (nothing E-sized more: ``q`` is
shared by the steps and ``cur`` is the previous step's ``ne``). Its
backward is the JAX package's ``_step_bwd_rule`` (jax.vjp of the jnp
reference) as three hand-written kernels:

1. K2b (ops.typed_message) on (ne, a, types, valid, we, w_attn, g_out):
   K1's tail is K2's function on the same ``we`` and ``w_attn`` layouts,
   so it gives ``da``, ``dwe``, ``dw_attn`` and the aggregation's
   ``d_ef``. Skipped where ``out`` receives no gradient (a pass whose
   nodes reach no head).
2. K1b (``csrc/fused_step_bwd.cu``), the edge MLP's backward, on the
   new edge carry's cotangent plus K2b's ``d_ef``: ``dq``, ``dcur``,
   ``dh_node``, ``dw_cur``, ``dw_e1`` and ``db_e1``, recomputing the
   hidden layer in K1's float32 order so that its ReLU mask is the
   forward's. ``fused_step_bwd_plain`` is its factored math.
3. G1 (ops.gather_mm) scatters ``dq`` onto ``dp`` by source row, through
   the forward's gather plan.

Bound on an H100 (reckoned from the shapes, see the kernel sources): at
the flagship eval shapes one K1 launch moves ~209 MB, ~62 us at 3.35 TB/s,
and does ~10.7 GFLOP, ~11 us at the bf16 tensor-core peak: memory-bound.
K1's f32 form at the model_58_4 training shapes (E = 435,200, widths 64)
does ~9.7 GFLOP, ~0.144 ms at the f32 rate, and K1b ~17.8 GFLOP, ~0.27 ms,
against ~780 MB, ~0.23 ms: both bound by operations. K1 keeps every
E-sized intermediate on chip, gathers source rows by index and projects
each slot only onto its own type. ``FORMS`` says which form of the kernel
serves which dtype: bf16 on the tensor cores, f32 on the CUDA cores. The
f32 form and K1b compute their products as register tiles (a thread owns
rows x 4 columns, float4 loads from shared memory), keeping every
element's sum in k order, so ``ne`` and K1b's ``dq`` and ``dcur`` do not
depend on the tiling.

``LAUNCHES`` counts K1's launches and ``LAUNCHES_BWD`` K1b's (the plain
versions do not count).
"""

from __future__ import annotations

import ctypes

import torch

from pemp_tpu_torch.ops import gather_mm, typed_message

LAUNCHES = 0
LAUNCHES_BWD = 0

FORMS = {
    torch.float32: "f32 CUDA-core form (f32::fused_step_f32_kernel: register-tiled rows, "
                   "cp.async, node tiles sorted by type, a warp per (type, half) projection)",
    torch.bfloat16: "bf16 tensor-core form (tc::fused_step_bf16_kernel: mma.sync m16n8k16, "
                    "ldmatrix, cp.async, node tiles sorted by type)",
}

_WIDTH = 64                 # the kernel's one row width (kWidth in the source)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int]
    + [ctypes.c_void_p] * 15
    + [ctypes.c_int] * 4
    + [ctypes.c_void_p]
)
_BWD_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def fused_mpn_step_plain(p, h_node, q, cur, a, src_local, types, valid,
                         w_cur, w_e1, b_e1, we, w_attn,
                         num_nodes: int, num_types: int, nodes_per_image: int):
    """Plain PyTorch version of K1 (translation of ``step_reference``).

    Returns (updates (N, T, D) float32, new_edge (E, De) in cur's dtype).
    """
    e = cur.shape[0]
    c = e // num_nodes
    d = a.shape[-1]
    dev = cur.device
    f32 = torch.float32
    p_sel = p[_source_rows(src_local, c, nodes_per_image)]
    hn_sel = torch.repeat_interleave(h_node, c, dim=0)
    hh = torch.relu(
        p_sel.to(f32) + hn_sel.to(f32) + cur.to(f32) @ w_cur.to(f32) + q.to(f32)
    ).to(cur.dtype)
    ef = torch.relu(hh.to(f32) @ w_e1.to(f32) + b_e1.reshape(-1).to(f32)).to(cur.dtype)

    tv = types.reshape(-1).long()
    vv = valid.reshape(-1).to(f32)
    # typed projection onto every type, then selection (the reference's form)
    wet = we.reshape(ef.shape[-1], num_types, d)
    b_all = torch.einsum("ei,itd->etd", ef.to(f32), wet.to(f32))
    b_sel = torch.gather(b_all, 1, tv[:, None, None].expand(e, 1, d))[:, 0]
    node_of_edge = torch.arange(e, device=dev) // c
    a_flat = a.reshape(num_nodes * num_types, d).to(f32)
    m = torch.relu(a_flat[node_of_edge * num_types + tv] + b_sel)
    logits = (ef.to(f32) @ w_attn.to(f32))[:, 0]
    # per-(node, type) softmax over each node's C slots
    lg = logits.reshape(num_nodes, c)
    tg = tv.reshape(num_nodes, c)
    vg = vv.reshape(num_nodes, c)
    hot = (tg[:, :, None] == torch.arange(num_types, device=dev)[None, None, :]) & (
        vg[:, :, None] > 0
    )                                                   # (N, C, T)
    neg = torch.tensor(-1e30, dtype=f32, device=dev)
    sc = torch.where(hot, lg[:, :, None], neg)
    mx = torch.amax(sc, dim=1, keepdim=True)
    mx = torch.where(mx <= neg / 2, torch.zeros_like(mx), mx)
    ex = torch.where(hot, torch.exp(sc - mx), torch.zeros_like(sc))
    den = torch.clamp(ex.sum(dim=1), min=1e-16)         # (N, T)
    num = torch.einsum("nct,ncd->ntd", ex, m.reshape(num_nodes, c, d))
    return num / den[:, :, None], ef


def _source_rows(src_local, c: int, nodes_per_image: int):
    """(E,) int64: each slot's source row, img_base + src_local, the image
    of slot s being s // (nodes_per_image * C)."""
    src = src_local.reshape(-1).long()
    slot = torch.arange(src.numel(), device=src.device)
    return (slot // (nodes_per_image * c)) * nodes_per_image + src


def fused_step_bwd_plain(p, h_node, q, cur, src_local, w_cur, w_e1, ne, g_ne, g_agg,
                         num_nodes: int, nodes_per_image: int):
    """Plain PyTorch version of K1b: the edge MLP's backward in factored
    form, in the inputs' dtype. ``ne`` is the forward's new edge carry,
    ``g_ne`` its cotangent and ``g_agg`` the aggregation's d_ef (K2b's);
    either may be None. The hidden layer's input is recomputed as
    ``fused_mpn_step_plain`` forms it. Returns (dq (E, H), dcur (E, Dc),
    dh_node (N, H), dw_cur (Dc, H), dw_e1 (H, De), db_e1 (De,)); dq is
    also the cotangent of the source rows p[j], which G1 scatters."""
    e = cur.shape[0]
    c = e // num_nodes
    pre_h = (p[_source_rows(src_local, c, nodes_per_image)]
             + torch.repeat_interleave(h_node, c, dim=0) + cur @ w_cur + q)
    g = g_agg if g_ne is None else (g_ne if g_agg is None else g_ne + g_agg)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    d_ef = torch.where(ne > 0, g, zero)                  # relu'(0) = 0, as torch and JAX
    d_pre = torch.where(pre_h > 0, d_ef @ w_e1.t(), zero)
    return (d_pre, d_pre @ w_cur.t(), d_pre.reshape(num_nodes, c, -1).sum(1),
            cur.t() @ d_pre, torch.relu(pre_h).t() @ d_ef, d_ef.sum(0))


def fused_mpn_step(p, h_node, q, cur, a, src_local, types, valid,
                   w_cur, w_e1, b_e1, we, w_attn,
                   num_nodes: int, num_types: int, nodes_per_image: int, plan=None):
    """Fused MPN step: returns (updates (N, T, D) float32, new_edge (E, De)).

    Arguments as in pemp_tpu.ops.pallas.fused_step.fused_mpn_step:
    p, h_node (N, H); q (E, H); cur (E, Dc); a (N, T, D); src_local, types,
    valid (E,) or (E, 1) int32; w_cur (Dc, H); w_e1 (H, De); b_e1 (De,);
    we (De, T*D); w_attn (De, 1). Per slot s with target n = s // C and
    source j = src_local[s] within n's image:

        h[s]  = relu(p[j] + h_node[n] + q[s] + cur[s] @ w_cur)
        ef[s] = relu(h[s] @ w_e1 + b_e1)              # the new edge carry
        m[s]  = relu(a[n, t_s] + ef[s] @ we[:, t_s])
        out[n, t] = softmax(ef @ w_attn)-weighted sum of m over n's valid
                    type-t slots

    Differentiable in every float input. On the card, where a gradient can
    flow, the step runs through K1 forward and K2b, K1b and G1 backward
    (float32 only), and ``plan`` must be the forward's
    ops.gather_mm.gather_plan(src_local, nodes_per_image, N) if p needs a
    gradient; elsewhere it is not read.
    """
    if cur.device.type == "cpu":
        return fused_mpn_step_plain(p, h_node, q, cur, a, src_local, types, valid,
                                    w_cur, w_e1, b_e1, we, w_attn,
                                    num_nodes, num_types, nodes_per_image)
    if cur.device.type != "cuda":
        raise ValueError(f"fused_mpn_step: unsupported device {cur.device}")
    floats = (p, h_node, q, cur, a, w_cur, w_e1, b_e1, we, w_attn)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in floats)):
        return _launch(p, h_node, q, cur, a, src_local, types, valid,
                       w_cur, w_e1, b_e1, we, w_attn, num_nodes, num_types, nodes_per_image)
    _check(all(t.dtype == torch.float32 for t in floats),
           "the bfloat16 form is forward only (K1b, the backward, runs in float32 only)")
    _check(plan is not None or not p.requires_grad,
           "a gradient can flow to p, so it needs the forward's "
           "gather_plan(src_local, nodes_per_image, N) (ops.gather_mm)")
    return _FusedStep.apply(p, h_node, q, cur, a, src_local, types, valid,
                            w_cur, w_e1, b_e1, we, w_attn,
                            num_nodes, num_types, nodes_per_image, plan)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_mpn_step: {msg}")


def _launch(p, h_node, q, cur, a, src_local, types, valid,
            w_cur, w_e1, b_e1, we, w_attn, num_nodes, num_types, nodes_per_image):
    global LAUNCHES
    from pemp_tpu_torch.ops import _build

    floats = dict(p=p, h_node=h_node, q=q, cur=cur, a=a, w_cur=w_cur, w_e1=w_e1,
                  b_e1=b_e1, we=we, w_attn=w_attn)
    ints = dict(src_local=src_local, types=types, valid=valid)
    dtype = cur.dtype
    _check(dtype in _DTYPES, f"dtype {dtype} (float32 or bfloat16 only)")
    for name, t in {**floats, **ints}.items():
        _check(t.device == cur.device, f"{name} is on {t.device}, cur on {cur.device}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    for name, t in floats.items():
        _check(t.dtype == dtype, f"{name} is {t.dtype}, cur is {dtype}")
    e, w = cur.shape
    c = e // max(num_nodes, 1)
    _check(w == _WIDTH, f"row width {w} (the kernel is built for {_WIDTH})")
    _check(num_nodes > 0 and e == num_nodes * c, "E must be N * C")
    _check(nodes_per_image > 0 and num_nodes % nodes_per_image == 0,
           "N must be a multiple of nodes_per_image")
    _check(0 < num_types <= 32, "1 to 32 types")
    for name, t in ints.items():
        _check(t.dtype == torch.int32 and t.numel() == e, f"{name} must be E int32")
    n, t_, h, de = num_nodes, num_types, w, w
    shapes = dict(p=(n, h), h_node=(n, h), q=(e, h), a=(n, t_, w), w_cur=(w, h),
                  w_e1=(h, de), we=(de, t_ * w), w_attn=(de, 1))
    for name, shape in shapes.items():
        _check(tuple(floats[name].shape) == shape,
               f"{name} has shape {tuple(floats[name].shape)}, expected {shape}")
    _check(b_e1.numel() == de, "b_e1 must have De elements")

    lib = _build.load("fused_step")
    fn = lib.pemp_fused_step
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    ne = torch.empty((e, de), dtype=dtype, device=cur.device)
    out = torch.empty((n, t_, w), dtype=torch.float32, device=cur.device)
    # launch on the tensors' card, whichever is current
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream(cur.device).cuda_stream
        ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
        err = fn(
            _DTYPES[dtype], ptr(p), ptr(h_node), ptr(q), ptr(cur), ptr(a),
            ptr(src_local), ptr(types), ptr(valid), ptr(w_cur), ptr(w_e1), ptr(b_e1),
            ptr(we), ptr(w_attn), ptr(ne), ptr(out), n, c, t_, nodes_per_image,
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_mpn_step kernel failed to launch: error {err}")
    LAUNCHES += 1
    return out, ne


def _launch_backward(p, h_node, q, cur, src_local, w_cur, w_e1, ne, g_ne, g_agg,
                     num_nodes, nodes_per_image):
    """K1b on the card: (dq, dcur, dh_node, dw_cur, dw_e1, db_e1) as
    ``fused_step_bwd_plain`` gives them; ``g_ne`` or ``g_agg`` may be
    None, not both."""
    global LAUNCHES_BWD
    from pemp_tpu_torch.ops import _build

    grads = {k: v for k, v in dict(g_ne=g_ne, g_agg=g_agg).items() if v is not None}
    _check(bool(grads), "the backward needs the cotangent of ne, of out, or both")
    floats = dict(p=p, h_node=h_node, q=q, cur=cur, w_cur=w_cur, w_e1=w_e1, ne=ne, **grads)
    for name, t in {**floats, "src_local": src_local}.items():
        _check(t.device == cur.device, f"{name} is on {t.device}, cur on {cur.device}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    for name, t in floats.items():
        _check(t.dtype == torch.float32, f"the backward kernel runs in float32 only ({name} "
                                         f"is {t.dtype})")
    e, w = cur.shape
    n = num_nodes
    c = e // max(n, 1)
    _check(w == _WIDTH, f"row width {w} (the kernel is built for {_WIDTH})")
    _check(n > 0 and e == n * c, "E must be N * C")
    _check(nodes_per_image > 0 and n % nodes_per_image == 0,
           "N must be a multiple of nodes_per_image")
    _check(src_local.dtype == torch.int32 and src_local.numel() == e,
           "src_local must be E int32")
    shapes = dict(p=(n, w), h_node=(n, w), q=(e, w), w_cur=(w, w), w_e1=(w, w), ne=(e, w),
                  **{k: (e, w) for k in grads})
    for name, shape in shapes.items():
        _check(tuple(floats[name].shape) == shape,
               f"{name} has shape {tuple(floats[name].shape)}, expected {shape}")

    dev = cur.device
    grid_fn = _build.function("fused_step_bwd", "pemp_fused_step_bwd_grid",
                              [ctypes.c_int, ctypes.c_int])
    partial_fn = _build.function("fused_step_bwd", "pemp_fused_step_bwd_partial_floats", [])
    fn = _build.function("fused_step_bwd", "pemp_fused_step_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        blocks = grid_fn(n, c)
    if blocks <= 0:
        raise RuntimeError(f"K1b (the fused step's backward) cannot be sized: error {-blocks}")
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    dq, dcur, dh_node = empty(e, w), empty(e, w), empty(n, w)
    dw_cur, dw_e1, db_e1 = empty(w, w), empty(w, w), empty(w)
    # per-block partial sums of the weight gradients, summed in block order
    # by the second launch: no atomics, the same bits on every run
    partial = empty(blocks, partial_fn())
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())  # noqa: E731
    # launch on the tensors' card, whichever is current
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(p), ptr(h_node), ptr(q), ptr(cur), ptr(src_local), ptr(w_cur), ptr(w_e1),
                 ptr(ne), ptr(g_ne), ptr(g_agg), ptr(dq), ptr(dcur), ptr(dh_node), ptr(dw_cur),
                 ptr(dw_e1), ptr(db_e1), ptr(partial), n, c, nodes_per_image, blocks,
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"K1b (the fused step's backward) failed to launch: error {err}")
    LAUNCHES_BWD += 1
    return dq, dcur, dh_node, dw_cur, dw_e1, db_e1


class _FusedStep(torch.autograd.Function):
    """K1 forward (float32 form); backward K2b on the tail, K1b on the edge
    MLP, G1 on the source gather (module docstring)."""

    @staticmethod
    def forward(ctx, p, h_node, q, cur, a, src_local, types, valid, w_cur, w_e1, b_e1, we,
                w_attn, num_nodes, num_types, nodes_per_image, plan):
        out, ne = _launch(p, h_node, q, cur, a, src_local, types, valid, w_cur, w_e1, b_e1,
                          we, w_attn, num_nodes, num_types, nodes_per_image)
        ctx.save_for_backward(p, h_node, q, cur, a, src_local, types, valid, w_cur, w_e1, we,
                              w_attn, ne)
        ctx.dims = (num_nodes, num_types, nodes_per_image)
        ctx.plan = plan
        ctx.bias_shape = b_e1.shape
        # an output that reaches no loss passes None: its kernel is skipped
        ctx.set_materialize_grads(False)
        return out, ne

    @staticmethod
    def backward(ctx, g_out, g_ne):
        p, h_node, q, cur, a, src_local, types, valid, w_cur, w_e1, we, w_attn, ne = (
            ctx.saved_tensors)
        n, t, n_img = ctx.dims
        g_agg = da = dwe = dwa = None
        if g_out is not None:
            g_agg, da, dwe, dwa = typed_message._launch_backward(
                ne, a, types, valid, we, w_attn, g_out.contiguous(), n, t)
        if g_ne is not None:
            g_ne = g_ne.contiguous()
        dq, dcur, dh_node, dw_cur, dw_e1, db_e1 = _launch_backward(
            p, h_node, q, cur, src_local, w_cur, w_e1, ne, g_ne, g_agg, n, n_img)
        dp = None
        if ctx.needs_input_grad[0]:
            dp = gather_mm.gather_rows_bwd(dq, ctx.plan, n, p.dtype)
        return (dp, dh_node, dq, dcur, da, None, None, None, dw_cur, dw_e1,
                db_e1.reshape(ctx.bias_shape), dwe, dwa, None, None, None, None)
