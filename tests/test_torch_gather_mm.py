"""The source-row gather with its exact per-image backward
(ops.gather_mm), port against the JAX package's gather_rows_mm: the
forward exactly, the gradient within 1e-6 of its largest value, at small
sizes, at the small_train graph layout and with a bf16 cotangent; the plan
and its invariant; the plain fallback and the refusal of a layout that is
not image-major."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pemp_tpu.ops.gather_mm import gather_rows_mm as jax_gather_rows_mm
from pemp_tpu.ops.knn import knn_edges_target_major as jax_knn
from pemp_tpu_torch.config import small_train
from pemp_tpu_torch.ops import gather_mm


def _random_layout(rng, imgs, n_img, e_img):
    """Indices of ``imgs`` images, each slot's source inside its image."""
    j = np.concatenate([rng.randint(0, n_img, e_img) + i * n_img for i in range(imgs)])
    return j.astype(np.int64), imgs * n_img


def _small_train_layout(rng):
    """The asymmetric target-major kNN layout at small_train's sizes (two
    images of J * K nodes, k own neighbours plus the transpose slots)."""
    cfg = small_train()
    j_types, kpt = cfg.DATASET.NUM_JOINTS, cfg.TPU.NODES_PER_TYPE
    k = cfg.TPU.KNN_K
    cap = cfg.TPU.KNN_CAP_IN if cfg.TPU.KNN_CAP_IN > 0 else k
    n_img = j_types * kpt
    srcs = []
    for i in range(cfg.TRAIN.BATCH_SIZE):
        pos = jnp.asarray(rng.rand(n_img, 2) * 40.0, jnp.float32)
        valid = jnp.asarray(rng.rand(n_img) > 0.2)
        ei, _ = jax_knn(pos, valid, k, cap_in=cap)
        srcs.append(np.asarray(ei[0]).astype(np.int64) + i * n_img)
    return np.concatenate(srcs), cfg.TRAIN.BATCH_SIZE * n_img, n_img


LAYOUTS = {
    # (images, nodes an image, slots an image, width)
    "small": (2, 6, 15, 5),
    "one_image": (1, 9, 40, 3),
    "wide": (3, 10, 24, 64),
}


def _check_against_jax(x, j, n_img, g, tol):
    """Forward exactly, gradient within ``tol`` of its largest value, both
    against JAX; the plan's key is j itself (the invariant holds)."""
    xt = torch.from_numpy(x).requires_grad_()
    jt = torch.from_numpy(j)
    plan = gather_mm.gather_plan(jt, n_img, x.shape[0])
    assert torch.equal(plan["key"], jt)
    out = gather_mm.gather_rows_mm_or_plain(xt, jt, n_img, plan)
    gt = torch.from_numpy(g)
    (dx,) = torch.autograd.grad(out, xt, gt)
    jx, jj = jnp.asarray(x), jnp.asarray(j.astype(np.int32))
    want_out, vjp = jax.vjp(lambda t: jax_gather_rows_mm(t, jj, n_img), jx)
    (want_dx,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want_out))
    want = np.asarray(want_dx, np.float32)
    np.testing.assert_allclose(dx.numpy(), want, rtol=0, atol=tol * np.abs(want).max())
    return dx


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_gather_rows_mm_matches_jax(layout):
    imgs, n_img, e_img, d = LAYOUTS[layout]
    rng = np.random.RandomState(sorted(LAYOUTS).index(layout))
    j, n = _random_layout(rng, imgs, n_img, e_img)
    x = rng.randn(n, d).astype(np.float32)
    g = rng.randn(j.size, d).astype(np.float32)
    dx = _check_against_jax(x, j, n_img, g, 1e-6)
    # a row no slot names gets zeros; two calls give the same bits
    named = np.zeros(n, bool)
    named[j] = True
    assert (dx.numpy()[~named] == 0).all()
    plan = gather_mm.gather_plan(torch.from_numpy(j), n_img, n)
    again = gather_mm.gather_rows_bwd(torch.from_numpy(g), plan, n, torch.float32)
    assert torch.equal(dx, again)


def test_gather_rows_mm_at_the_small_train_layout():
    # every invalid slot names its image's node 0: that row's thousands of
    # slots are cut into pieces of PIECE
    rng = np.random.RandomState(7)
    j, n, n_img = _small_train_layout(rng)
    plan = gather_mm.gather_plan(torch.from_numpy(j), n_img, n)
    sizes = plan["bounds"][1:] - plan["bounds"][:-1]
    assert int(sizes.max()) == gather_mm.PIECE
    assert int((plan["row_pieces"][1:] - plan["row_pieces"][:-1]).max()) > 10
    x = rng.randn(n, 64).astype(np.float32)
    g = rng.randn(j.size, 64).astype(np.float32)
    _check_against_jax(x, j, n_img, g, 1e-6)


def test_gather_rows_mm_bf16_cotangent_sums_in_f32():
    # as tests/test_gather_mm.py's bf16 case: bf16 rows and cotangent; both
    # sides sum in f32 and round once, so the two agree within one bf16 step
    rng = np.random.RandomState(1)
    n_img, c, d = 8, 64, 4
    j = rng.randint(0, n_img, n_img * c).astype(np.int64)
    x = jnp.asarray(rng.randn(n_img, d), jnp.bfloat16)
    g = jnp.asarray(rng.randn(n_img * c, d), jnp.bfloat16)
    _, vjp = jax.vjp(lambda t: jax_gather_rows_mm(t, jnp.asarray(j, jnp.int32), n_img), x)
    (want,) = vjp(g)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).requires_grad_()
    gt = torch.from_numpy(np.asarray(g, np.float32)).to(torch.bfloat16)
    plan = gather_mm.gather_plan(torch.from_numpy(j), n_img, n_img)
    out = gather_mm.gather_rows_mm_or_plain(xt, torch.from_numpy(j), n_img, plan)
    (dx,) = torch.autograd.grad(out, xt, gt)
    assert dx.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(dx.float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())


def test_gather_plan_keys_by_the_slots_image():
    # JAX's backward keys a slot by its own image and j % n_img
    # (pemp_tpu/ops/gather_mm.py:87-89): a slot whose index left its image
    # lands in its slot's image, and so does the port's
    j = torch.tensor([0, 5, 1, 2, 3, 0], dtype=torch.int64)     # slot 1 names image 1's row
    plan = gather_mm.gather_plan(j, 3, 6)
    assert plan["key"].tolist() == [0, 2, 1, 5, 3, 3]
    assert plan["order"].tolist() == [0, 2, 1, 4, 5, 3]
    assert plan["bounds"].tolist() == [0, 1, 2, 3, 5, 6]        # one piece a named row
    assert plan["row_pieces"].tolist() == [0, 1, 2, 3, 4, 4, 5]  # row 4: no slot, no piece
    assert plan["piece_row"].tolist() == [0, 1, 2, 3, 5]
    g = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    x = jnp.zeros((6, 2))
    _, vjp = jax.vjp(lambda t: jax_gather_rows_mm(t, jnp.asarray(j.numpy(), jnp.int32), 3), x)
    np.testing.assert_array_equal(
        gather_mm.gather_rows_bwd(g, plan, 6, torch.float32).numpy(),
        np.asarray(vjp(jnp.asarray(g.numpy()))[0]))


def test_gather_falls_back_or_refuses():
    x = torch.randn(12, 3, requires_grad=True)
    j = torch.tensor([0, 3, 11, 7, 5, 2], dtype=torch.int64)
    for n_img in (0, 5):                    # no image size, or one that does not divide N
        out = gather_mm.gather_rows_mm_or_plain(x, j, n_img)
        assert out.grad_fn is not None and "Index" in type(out.grad_fn).__name__
        assert torch.equal(out, x[j])
        # only a CPU tensor falls back: off the CPU the layout is refused
        with pytest.raises(ValueError, match="image-major rows on meta"):
            gather_mm.gather_rows_mm_or_plain(x.detach().to("meta"), j.to("meta"), n_img)
    plan = gather_mm.gather_plan(j, 6, 12)
    assert gather_mm.gather_rows_mm_or_plain(x, j, 6, plan).grad_fn is not None
    with pytest.raises(ValueError, match="needs the forward's gather_plan"):
        gather_mm.gather_rows_mm_or_plain(x, j, 6)
    with pytest.raises(ValueError, match="not divisible by batch"):
        gather_mm.gather_rows_mm_or_plain(x, j[:5], 6)
    with torch.no_grad():                   # no gradient: the forward alone, no plan
        assert gather_mm.gather_rows_mm_or_plain(x, j, 6).grad_fn is None
