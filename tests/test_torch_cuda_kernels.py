"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from pemp_tpu_torch.ops import fused_step


def _k1_inputs(seed=2, imgs=2, n_img=16, c=8, t=4, w=64):
    rng = np.random.RandomState(seed)
    n = imgs * n_img
    e = n * c
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    types = rng.randint(0, t, e).astype(np.int32)
    types[: 3 * c] = 0
    valid = (rng.rand(e) > 0.2).astype(np.int32)
    valid[5 * c: 6 * c] = 0
    args = (
        f(n, w), f(n, w), f(e, w), f(e, w), f(n, t, w),
        rng.randint(0, n_img, e).astype(np.int32), types, valid,
        f(w, w) * 0.3, f(w, w) * 0.3, f(w) * 0.1, f(w, t * w) * 0.3, f(w, 1) * 0.3,
    )
    return args, n, t, n_img


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_on_card(dtype, tol):
    # the kernel sums in another order than cuBLAS (f32: 1e-4); in bf16 the
    # edge carry rounds at the same points but may land one ulp apart (2e-2,
    # as tests/test_fused_step.py)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, n, t, n_img = _k1_inputs()
    tens = [torch.from_numpy(a).cuda() for a in args]
    tens = [x.to(dtype) if x.is_floating_point() else x for x in tens]
    out_k, ne_k = fused_step.fused_mpn_step(*tens, n, t, n_img)
    out_p, ne_p = fused_step.fused_mpn_step_plain(*tens, n, t, n_img)
    torch.cuda.synchronize()
    torch.testing.assert_close(out_k, out_p, atol=tol, rtol=tol)
    torch.testing.assert_close(ne_k.float(), ne_p.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    args, n, t, n_img = _k1_inputs(w=16)
    tens = [torch.from_numpy(a).cuda() for a in args]
    with pytest.raises(ValueError, match="row width"):
        fused_step.fused_mpn_step(*tens, n, t, n_img)
