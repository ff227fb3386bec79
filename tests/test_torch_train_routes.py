"""One small_train step on the ``einsum`` and ``dots`` routes, port against
the JAX package, as tests/test_torch_hybrid.py's step on ``hybrid``: the
graph's labels exactly, the loss parts at 1e-4, every parameter's gradient
within 5e-3 of that tensor's largest (5e-2 on the backbone's stem). Both
sides differentiate the blocked aggregate (the port through K4b's plain
version on the CPU, JAX its jnp aggregate) and gather the edge MLP's
sources through the exact per-image backward (ops.gather_mm)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_slice import _seeded_variables
from test_torch_train_step import STEM, _jax_loss_fn

from pemp_tpu.config import get_config
from pemp_tpu.losses import dispatch_loss_func as jax_dispatch_loss_func
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.train.convert import convert_composite_state_dict
from pemp_tpu_torch.config import small_train
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.ops import blocked_attn, gather_mm
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
from pemp_tpu_torch.weights import from_jax_variables

ROUTES = ("einsum", "dots")


@pytest.fixture(scope="module", params=ROUTES)
def route_step(request):
    route = request.param
    port_cfg = small_train()
    port_cfg.TPU.MSG_PASS = route
    jcfg = get_config()
    jcfg.defrost()
    jcfg.merge_from_other(port_cfg.to_dict())
    jcfg.freeze()
    jmodel = jax_build_pose_model(jcfg, dtype=jnp.float32)
    # einsum: the reverse-permutation projection; dots: the all-types one;
    # both the jnp aggregate
    assert bool(jmodel.mpn_cfg.get("_TYPED_EINSUM")) == (route == "einsum")
    assert not jmodel.mpn_cfg.get("_USE_PALLAS")
    rng = np.random.RandomState(0)
    batch = make_batch(rng, 2, 64, (16, 32), 17, 30, scale_range=(0.4, 0.9))
    variables = _seeded_variables(jmodel, jnp.asarray(batch["imgs"]), rng)
    loss_fn = _jax_loss_fn(jmodel, jax_dispatch_loss_func(jcfg), jcfg)
    (loss, (_, logging, labels, _)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"],
            jax.tree_util.tree_map(jnp.asarray, batch))

    trainer = build_trainer(port_cfg, device="cpu")
    trainer.model.load_state_dict(from_jax_variables(
        variables["params"], variables["batch_stats"], port_cfg))
    before = (blocked_attn.LAUNCHES, blocked_attn.LAUNCHES_BWD, gather_mm.LAUNCHES)
    p_loss, p_logging, p_out = trainer.loss(batch_to_torch(batch, "cpu"))
    p_loss.backward()
    assert (blocked_attn.LAUNCHES, blocked_attn.LAUNCHES_BWD, gather_mm.LAUNCHES) == before
    return dict(route=route, jcfg=jcfg, jax=(loss, logging, labels, grads),
                port=(p_loss, p_logging, p_out), trainer=trainer)


def test_route_step_labels_and_loss(route_step):
    """The graph's labels exactly (symmetric layout on einsum, asymmetric
    on dots, as the JAX package builds them), the loss parts at 1e-4."""
    loss, logging, labels, _ = route_step["jax"]
    p_loss, p_logging, p_out = route_step["port"]
    assert route_step["trainer"].model.gc.knn_symmetric == (route_step["route"] == "einsum")
    for key in ("node", "class", "person"):
        np.testing.assert_array_equal(p_out["labels"][key].numpy(), np.asarray(labels[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(p_out["labels"]["edge"][0].numpy(),
                                  np.asarray(labels["edge"][0]))
    for key in ("heatmap", "node", "edge", "class_loss", "loss"):
        np.testing.assert_allclose(float(p_logging[key].detach()), float(logging[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(p_loss.detach()), float(loss), rtol=1e-4)


def test_route_step_gradients_match_per_tensor(route_step):
    """Every parameter's gradient within 5e-3 of that tensor's largest
    |grad| (5e-2 on the backbone's stem): tests/test_torch_train_step.py's
    tolerances. One exception: the attention bias adds the same value to
    every logit of a softmax group, so its gradient is zero up to
    cancellation on both sides (~1e-10 here; the pallas and hybrid routes
    drop the bias and give exactly 0); it is held to 5e-3 of its layer's
    kernel gradient instead."""
    grads = route_step["jax"][3]
    model = route_step["trainer"].model
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
          for k, p in model.named_parameters()}
    sd.update({k: b.numpy() for k, b in model.named_buffers()})
    got, _ = convert_composite_state_dict(sd, route_step["jcfg"])
    want, got = flatten_dict(grads), flatten_dict(got)
    assert set(want) == set(got)
    for key in want:
        w, g = np.asarray(want[key]), np.asarray(got[key])
        tol = 5e-2 if key[:2] in STEM else 5e-3
        scale = float(np.abs(w).max())
        if key[-2:] == ("attn_net", "bias"):
            scale = float(np.abs(np.asarray(want[key[:-1] + ("kernel",)])).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale, err_msg=str(key))
