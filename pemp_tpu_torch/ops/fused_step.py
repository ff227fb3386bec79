"""K1: the fully fused flagship MPN step (counterpart of
pemp_tpu.ops.pallas.fused_step).

``fused_mpn_step`` replaces the TPU kernel ``_step_kernel``
(pemp_tpu/ops/pallas/fused_step.py, via ``_step_forward``'s
``pl.pallas_call``). On a CUDA tensor it launches the hand-written Hopper
kernel in ``csrc/fused_step.cu`` or raises; on a CPU tensor it runs
``fused_mpn_step_plain``, a plain PyTorch translation of the JAX
package's ``step_reference``. There is no fallback from one to the other.

Bound on an H100 (reckoned from the shapes, see the kernel source): at the
flagship eval shapes one launch moves ~209 MB, ~62 us at 3.35 TB/s, and
does ~10.7 GFLOP, ~11 us at the bf16 tensor-core peak: memory-bound. The
kernel keeps every E-sized intermediate on chip, gathers source rows by
index and projects each slot only onto its own type. ``FORMS`` says which
form of the kernel serves which dtype.

``LAUNCHES`` counts kernel launches (the plain version does not count).
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0

FORMS = {
    torch.float32: "f32 CUDA-core form (fused_step_kernel<float>, a block per node)",
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
    src = src_local.reshape(-1).long()
    img_base = (torch.arange(e, device=dev) // (nodes_per_image * c)) * nodes_per_image
    p_sel = p[img_base + src]
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


def fused_mpn_step(p, h_node, q, cur, a, src_local, types, valid,
                   w_cur, w_e1, b_e1, we, w_attn,
                   num_nodes: int, num_types: int, nodes_per_image: int):
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
    """
    if cur.device.type == "cpu":
        return fused_mpn_step_plain(p, h_node, q, cur, a, src_local, types, valid,
                                    w_cur, w_e1, b_e1, we, w_attn,
                                    num_nodes, num_types, nodes_per_image)
    if cur.device.type != "cuda":
        raise ValueError(f"fused_mpn_step: unsupported device {cur.device}")
    return _launch(p, h_node, q, cur, a, src_local, types, valid,
                   w_cur, w_e1, b_e1, we, w_attn, num_nodes, num_types, nodes_per_image)


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
