"""K1, the fused MPN step: the port's plain version against the JAX Pallas
kernel (interpret mode) and its jnp reference. The CUDA kernel is held
against the plain version in tests/test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import torch

from pemp_tpu.ops.pallas.fused_step import fused_mpn_step as jax_fused_mpn_step
from pemp_tpu.ops.pallas.fused_step import step_reference
from pemp_tpu_torch.ops import fused_step


def _make(seed=0, imgs=2, n_img=16, c=8, t=4, d=16, h=16, dc=16, de=16):
    """The shapes of tests/test_fused_step.py:_make, as numpy arrays, plus
    forced empty (node, type) groups and fully invalid nodes."""
    rng = np.random.RandomState(seed)
    n = imgs * n_img
    e = n * c
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    types = rng.randint(0, t, e).astype(np.int32)
    types[: 3 * c] = 0            # nodes 0-2 see one type only: three empty groups
    valid = (rng.rand(e) > 0.2).astype(np.int32)
    valid[5 * c: 6 * c] = 0       # node 5 has no valid slot at all
    args = (
        f(n, h), f(n, h), f(e, h), f(e, dc), f(n, t, d),
        rng.randint(0, n_img, e).astype(np.int32), types, valid,
        f(dc, h) * 0.3, f(h, de) * 0.3, f(de) * 0.1, f(de, t * d) * 0.3, f(de, 1) * 0.3,
    )
    return args, n, t, n_img


def test_plain_matches_jax_kernel_and_reference():
    # f32 on both sides; 1e-5 covers summation-order differences between
    # XLA's and PyTorch's CPU matmuls and reductions
    args, n, t, n_img = _make()
    out_k, ne_k = jax_fused_mpn_step(*map(jnp.asarray, args), n, t, n_img, interpret=True)
    out_r, ne_r = step_reference(*map(jnp.asarray, args), n, t, n_img)
    out_p, ne_p = fused_step.fused_mpn_step_plain(*map(torch.from_numpy, args), n, t, n_img)
    for want in (out_k, out_r):
        np.testing.assert_allclose(out_p.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    for want in (ne_k, ne_r):
        np.testing.assert_allclose(ne_p.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # the empty groups really are empty, and give 0
    assert np.all(out_p.numpy()[5] == 0.0)
    assert np.all(out_p.numpy()[0, 1:] == 0.0)


def test_wrapper_routes_cpu_tensors_to_plain():
    args, n, t, n_img = _make(seed=1)
    before = fused_step.LAUNCHES
    got = fused_step.fused_mpn_step(*map(torch.from_numpy, args), n, t, n_img)
    want = fused_step.fused_mpn_step_plain(*map(torch.from_numpy, args), n, t, n_img)
    assert fused_step.LAUNCHES == before  # the plain version launches nothing
    for g, w in zip(got, want):
        assert torch.equal(g, w)

