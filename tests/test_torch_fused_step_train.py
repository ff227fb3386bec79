"""Training on the fused step (``TPU.MSG_PASS: fused_step``), port against
the JAX package on the CPU.

(a) The op: the JAX package differentiates its fused step through
``jax.custom_vjp`` (pemp_tpu/ops/pallas/fused_step.py:189-230; the forward
is the Pallas kernel in interpret mode, the backward jax.vjp of the jnp
reference). The port's wrapper on CPU tensors runs its plain version under
autograd. All ten gradients within 1e-5 of their largest.
(b) K1b's plain factored backward (``fused_step_bwd_plain``), fed the
aggregation's d_ef from K2b's plain version and followed by G1's plain
scatter, against autograd through ``fused_mpn_step_plain``: the math the
card's K2b + K1b + G1 compute, at 1e-5, for cotangents on both outputs and
on either alone (a pass whose nodes reach no head gives ``out`` none).
(c, d) One training step on ``fused_step``: ``small_train()`` (model_58_4),
model_81_1_2's small cut (T = 14) and the ``simple`` zoo cut (whose last
pass reaches no head), against the JAX package's step with the fused-step
kernel in interpret mode. Labels exactly, loss parts within 1e-4, every
gradient within 5e-3 of its tensor's largest (5e-2 on the backbone's
stem), as tests/test_torch_train_step.py holds the ``pallas`` step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_fused_step import _make
from test_torch_slice import _seeded_variables
from test_torch_train_step import STEM, _jax_loss_fn

from pemp_tpu.config import get_config
from pemp_tpu.losses import dispatch_loss_func as jax_dispatch_loss_func
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.ops.pallas.fused_step import fused_mpn_step as jax_fused_mpn_step
from pemp_tpu_torch.config import small_81_1_2, small_train, zoo
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.ops import fused_step, gather_mm, launch_counts, typed_message
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
from pemp_tpu_torch.weights import from_jax_variables

# the differentiable float inputs of the step, by position, and their names
FLOATS = (0, 1, 2, 3, 4, 8, 9, 10, 11, 12)
NAMES = ("dp", "dh_node", "dq", "dcur", "da", "dw_cur", "dw_e1", "db_e1", "dwe", "dw_attn")


def _cotangents(args, n, t, seed):
    rng = np.random.RandomState(seed)
    e, de = args[3].shape[0], args[9].shape[1]
    d = args[4].shape[-1]
    return (rng.randn(n, t, d).astype(np.float32), rng.randn(e, de).astype(np.float32))


def _port_grads(args, dims, cotangents):
    """Autograd through the port's wrapper on CPU tensors; cotangents None
    where an output reaches no loss."""
    tens = [torch.from_numpy(a) for a in args]
    leaves = [tens[i].requires_grad_() for i in FLOATS]
    outs = fused_step.fused_mpn_step(*tens, *dims)
    pairs = [(o, torch.from_numpy(g)) for o, g in zip(outs, cotangents) if g is not None]
    return torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs],
                               allow_unused=True)


def _assert_grads(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w, np.float64)
        g = np.zeros_like(w) if g is None else np.asarray(g, np.float64).reshape(w.shape)
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("seed,shape", [
    pytest.param(7, {}, id="7"),
    pytest.param(11, {}, id="11"),
    # C = 77 (no multiple of 16) at model_81_1_2's T = 14, the ragged shape
    # the card tests hold K1's f32 form and K1b to
    pytest.param(13, dict(n_img=8, c=77, t=14), id="c77_t14"),
])
def test_op_gradients_match_jax_custom_vjp(seed, shape):
    """(a) jax.vjp of the JAX package's fused step (Pallas forward in
    interpret mode, jax.vjp of step_reference backward) against the port's
    wrapper under autograd, on tests/test_fused_step.py's shapes (with
    empty (node, type) groups and a node with no valid slot) and at
    C = 77, T = 14."""
    args, n, t, n_img = _make(seed=seed, **shape)
    g = _cotangents(args, n, t, seed + 100)
    jargs = [jnp.asarray(a) for a in args]

    def f(*floats):
        full = list(jargs)
        for i, x in zip(FLOATS, floats):
            full[i] = x
        return jax_fused_mpn_step(*full, n, t, n_img, interpret=True)

    _, vjp = jax.vjp(f, *(jargs[i] for i in FLOATS))
    want = vjp(tuple(jnp.asarray(x) for x in g))
    got = _port_grads(args, (n, t, n_img), g)
    _assert_grads(got, want, 1e-5)


@pytest.mark.parametrize("which", ["both", "ne only", "out only"])
def test_factored_backward_matches_autograd(which):
    """(b) K2b's plain version (autograd through fused_typed_message_plain
    on ne) for the tail, K1b's plain factored backward for the edge MLP,
    G1's plain scatter for the source gather, against autograd through
    fused_mpn_step_plain; nothing launches."""
    args, n, t, n_img = _make(seed=5)
    g_out, g_ne = _cotangents(args, n, t, 55)
    g_out = None if which == "ne only" else g_out
    g_ne = None if which == "out only" else g_ne
    want = _port_grads(args, (n, t, n_img), (g_out, g_ne))

    before = launch_counts()
    tens = [torch.from_numpy(a) for a in args]
    p, h_node, q, cur, a, src, types, valid, w_cur, w_e1, b_e1, we, w_attn = tens
    _, ne = fused_step.fused_mpn_step_plain(*tens, n, t, n_img)
    g_agg = da = dwe = dwa = None
    if g_out is not None:
        leaves = [x.detach().requires_grad_() for x in (ne, a, we, w_attn)]
        out = typed_message.fused_typed_message_plain(leaves[0], leaves[1], types, valid,
                                                      leaves[2], leaves[3], n, t)
        g_agg, da, dwe, dwa = torch.autograd.grad(out, leaves, torch.from_numpy(g_out))
    dq, dcur, dh_node, dw_cur, dw_e1, db_e1 = fused_step.fused_step_bwd_plain(
        p, h_node, q, cur, src, w_cur, w_e1, ne, None if g_ne is None else torch.from_numpy(g_ne),
        g_agg, n, n_img)
    plan = gather_mm.gather_plan(src, n_img, n)
    dp = gather_mm.gather_rows_bwd(dq, plan, n, p.dtype)
    assert launch_counts() == before
    got = (dp, dh_node, dq, dcur, da, dw_cur, dw_e1, db_e1, dwe, dwa)
    for name, x, y in zip(NAMES, got, want):
        if y is None:
            # no cotangent on out: nothing reaches a, we or w_attn
            assert x is None and g_out is None, name
            continue
        scale = y.abs().max().item()
        assert scale > 0, name
        assert (x - y).abs().max().item() <= 1e-5 * scale, name


def test_wrapper_on_cpu_keeps_the_plain_forward():
    """On CPU tensors the wrapper is the plain version, with or without a
    gradient, and launches nothing."""
    args, n, t, n_img = _make(seed=1)
    tens = [torch.from_numpy(a) for a in args]
    before = launch_counts()
    want = fused_step.fused_mpn_step_plain(*tens, n, t, n_img)
    tens[3].requires_grad_()
    got = fused_step.fused_mpn_step(*tens, n, t, n_img)
    assert launch_counts() == before
    assert got[1].requires_grad
    for x, y in zip(got, want):
        assert torch.equal(x.detach(), y)


# ------------------------------------------------------------ training steps

CASES = {
    "model_58_4": (small_train, 0, 17),
    "model_81_1_2": (small_81_1_2, 1, 14),
    "simple": (lambda: zoo("simple", small_train()), 0, 17),
}


def _jax_config(port_cfg):
    cfg = get_config()
    cfg.defrost()
    cfg.merge_from_other(port_cfg.to_dict())
    cfg.TPU.MSG_PASS = "fused_step"
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module", params=list(CASES))
def step_run(request):
    make_cfg, seed, joints = CASES[request.param]
    port_cfg = make_cfg()
    port_cfg.TPU.MSG_PASS = "fused_step"
    jcfg = _jax_config(port_cfg)
    jmodel = jax_build_pose_model(jcfg, dtype=jnp.float32)
    # the fused step on the asymmetric layout, its kernel in interpret mode
    assert jmodel.mpn_cfg["_FUSED_STEP"]
    jmodel.mpn_cfg["_USE_PALLAS"] = True
    jmodel.mpn_cfg["_PALLAS_INTERPRET"] = True
    rng = np.random.RandomState(seed)
    batch = make_batch(rng, 2, 64, (16, 32), joints, 30, scale_range=(0.4, 0.9))
    variables = _seeded_variables(jmodel, jnp.asarray(batch["imgs"]), rng)
    loss_fn = _jax_loss_fn(jmodel, jax_dispatch_loss_func(jcfg), jcfg)
    (loss, (_, logging, labels, masks)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"],
            jax.tree_util.tree_map(jnp.asarray, batch))

    trainer = build_trainer(port_cfg, device="cpu")
    assert trainer.train_route == "fused_step"
    trainer.model.load_state_dict(from_jax_variables(
        variables["params"], variables["batch_stats"], port_cfg))
    trainer.model.train()
    before = launch_counts()
    p_loss, p_logging, p_out = trainer.loss(batch_to_torch(batch, "cpu"))
    p_loss.backward()
    assert launch_counts() == before
    return dict(port_cfg=port_cfg, variables=variables,
                jax=(loss, logging, labels, masks, grads), port=(p_loss, p_logging, p_out),
                trainer=trainer)


def test_fused_step_train_labels_and_loss(step_run):
    """Labels and masks exactly, the loss parts within 1e-4."""
    loss, logging, labels, masks, _ = step_run["jax"]
    p_loss, p_logging, p_out = step_run["port"]
    for key in ("node", "class", "person"):
        np.testing.assert_array_equal(p_out["labels"][key].numpy(), np.asarray(labels[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(p_out["labels"]["edge"][0].numpy(),
                                  np.asarray(labels["edge"][0]))
    np.testing.assert_array_equal(p_out["masks"]["edge"][0].numpy(), np.asarray(masks["edge"][0]))
    assert np.asarray(labels["node"]).sum() > 5 and np.asarray(labels["edge"][0]).sum() > 10
    for key in logging:
        got = p_logging[key]
        np.testing.assert_allclose(float(got.detach() if torch.is_tensor(got) else got),
                                   float(logging[key]), rtol=1e-4, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(p_loss.detach()), float(loss), rtol=1e-4)


def test_fused_step_train_gradients_match_per_tensor(step_run):
    """Every parameter's gradient within 5e-3 of that tensor's largest
    |grad|, 5e-2 on the backbone's stem (test_torch_train_step.py's
    tolerances). The JAX gradients are mapped onto the port's names by
    weights.from_jax_variables, the map of the weights (a gradient has its
    parameter's layout), which also covers the zoo's models. One exception,
    as tests/test_torch_train_routes.py has it: the attention bias adds the
    same value to every logit of a softmax group, so its gradient is zero
    up to cancellation (exactly 0 where the fused step and the jnp
    reference drop it; ~5e-12 on the JAX ``simple`` step); it is held to
    5e-3 of its layer's weight gradient instead."""
    grads = step_run["jax"][4]
    model = step_run["trainer"].model
    want = from_jax_variables(grads, step_run["variables"]["batch_stats"], step_run["port_cfg"])
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for key, p in named.items():
        w = want[key].numpy()
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        tol = 5e-2 if tuple(key.split(".")[:2]) in STEM else 5e-3
        scale = float(np.abs(w).max())
        if key.endswith("attn_net.0.bias"):
            scale = float(np.abs(want[key[:-len("bias")] + "weight"].numpy()).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale, err_msg=key)
