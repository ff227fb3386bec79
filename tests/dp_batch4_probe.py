"""Why tests/test_torch_dp_train.py holds its batch-4 cases against the
JAX sharded step in float64: prints, at the small model_58_4 cut and the
JAX model's seeded weights,

1. how far the JAX package's sharded step (2 and 4 devices) lies from its
   own unsharded step, in float32 and float64, at global batches 2, 4 and
   8: the worst gradient gap over its tensor's largest and the tensors
   past the tests' limit (5e-3, 5e-2 on the stem);
2. the port's ReLU inputs within rounding of 0: the feature map scaled by
   ``1 + 1e-7 * randn`` (a change of the order of float32 rounding) flips
   which side of 0 some inputs lie on; each call with a flip, its input's
   width and where it is.

Run from the repo root: ``PYTHONPATH=. python tests/dp_batch4_probe.py``
(CPU, about 8 minutes).
"""

import sys
import traceback

import conftest  # noqa: F401  (the 8 virtual CPU devices)
import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict
from test_torch_dp_train import _batches, _cfg
from test_torch_slice import _seeded_variables
from test_torch_train_step import STEM, _jax_config, _jax_loss_fn

import pemp_tpu_torch.models.pose_estimation as port_model
from pemp_tpu.losses import dispatch_loss_func
from pemp_tpu.models import build_pose_model
from pemp_tpu.parallel import make_mesh, replicate, shard_batch, shard_train_step
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer


def sharding_gaps(size: int, f64: bool) -> None:
    cfg = _cfg()
    cfg.TRAIN.BATCH_SIZE = size
    jcfg = _jax_config(cfg)
    batch = _batches(0, 1, size=size)[0]
    variables = _seeded_variables(build_pose_model(jcfg, dtype=jnp.float32),
                                  jnp.asarray(batch["imgs"][:2]), np.random.RandomState(0))
    dtype = jnp.float64 if f64 else jnp.float32

    def wide(x):
        x = np.asarray(x)
        return jnp.asarray(x.astype(dtype) if np.issubdtype(x.dtype, np.floating) else x)

    with jax.enable_x64(f64):
        loss_fn = _jax_loss_fn(build_pose_model(jcfg, dtype=dtype), dispatch_loss_func(jcfg),
                               jcfg)
        variables, batch = jax.tree_util.tree_map(wide, (variables, batch))

        def grad_step(state, b):
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state["params"], state["batch_stats"], b)
            return grads, loss, aux

        whole = flatten_dict(grad_step(variables, batch)[0])
        for world in (2, 4):
            if size % world:
                continue
            mesh = make_mesh(world)
            sharded = flatten_dict(shard_train_step(grad_step, mesh)(
                replicate(variables, mesh), shard_batch(batch, mesh))[0])
            gaps = []
            for key, w in whole.items():
                w, g = np.asarray(w), np.asarray(sharded[key])
                if not np.abs(w).max() or key[-2:] == ("attn_net", "bias"):
                    continue    # constant within each softmax group: no gradient
                gap = float(np.abs(g - w).max() / np.abs(w).max())
                gaps.append((gap, gap > (5e-2 if key[:2] in STEM else 5e-3), "/".join(key)))
            worst = max(gaps)
            print(f"batch {size}, {world} devices, {'float64' if f64 else 'float32'}: worst "
                  f"gap {worst[0]:.3g} ({worst[2]}), {sum(g[1] for g in gaps)} of {len(gaps)} "
                  f"tensors past the limit", flush=True)


def relu_flips(size: int = 4) -> None:
    cfg = _cfg()
    cfg.TRAIN.BATCH_SIZE = size
    batch = batch_to_torch(_batches(0, 1, size=size)[0], "cpu")
    trainer = build_trainer(cfg, device="cpu", seed=0)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    construct, relu, noisy, calls = port_model.construct_graph_batch, torch.relu, [False], []

    def scaled(gc, scoremaps, features, tags, **kwargs):
        if noisy[0]:
            gen = torch.Generator().manual_seed(1)
            features = features * (1 + 1e-7 * torch.randn(features.shape, generator=gen))
        return construct(gc, scoremaps, features, tags, **kwargs)

    def recorded(x, *args, **kwargs):
        if x.requires_grad:
            frame = traceback.extract_stack(limit=3)[0]
            calls.append((x.detach() > 0, x.detach().abs(), f"{frame.filename}:{frame.lineno}"))
        return relu(x)

    port_model.construct_graph_batch = scaled
    torch.relu = recorded
    torch.nn.functional.relu = lambda x, inplace=False: recorded(x)
    runs = []
    for noisy[0] in (False, True):
        trainer.model.load_state_dict(state)
        calls.clear()
        trainer.loss(batch)
        runs.append(list(calls))
    for i, ((m0, ax, where), (m1, _, _)) in enumerate(zip(*runs)):
        flips = m0 != m1
        if flips.any():
            print(f"ReLU call {i} ({where}): {int(flips.sum())} of {m0.numel()} inputs flip, "
                  f"|x| {ax[flips].tolist()} against a largest of {float(ax.max()):.3g}")


if __name__ == "__main__":
    sys.stdout.reconfigure(line_buffering=True)
    for size in (2, 4, 8):
        sharding_gaps(size, False)
    sharding_gaps(4, True)
    relu_flips()
