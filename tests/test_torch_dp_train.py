"""Data-parallel training: two gloo ranks on the CPU (fresh processes, the
rank functions in torch_dp_ranks), each on its rows of a global batch, at
the small model_58_4 cut (narrow HigherHRNet at 64x64, K = 8, 3 MPN steps,
``pallas`` with the plain versions of the kernels).

Held against the JAX package's sharded step (``pemp_tpu.parallel.
shard_train_step`` on a 2-device CPU mesh, its batch on ``P("data")``, with
the gradient taken there): labels exactly, the loss parts within 5e-3,
every gradient within 5e-3 of its tensor's largest (5e-2 on the stem, as
tests/test_torch_train_step.py allows the JAX program there), the running
statistics within 1e-4 of max(1, their largest). At a global batch of 2,
one row a rank, both sides in float32. At this file's global batch of 4,
two rows a rank, the JAX package's float32 sharded step is no witness: it
strays from its own unsharded step by up to 5.8 % of a tensor's largest
gradient (32 of 285 tensors past the limit), while in float64 the two
agree to 1.4e-4. A few ReLU inputs of the MPN (the edge MLP's first
layer, the message ``relu(a + b)``) lie within float32 rounding of 0
(1e-8 to 9e-7 against a largest of about 10), and the order of the sums
decides which side each takes and so whether its gradient passes
(tests/dp_batch4_probe.py prints both). So the 4-image cases are
held against the sharded step in float64 (``jax.enable_x64``): the ranks
in float32 with the backbone's BatchNorm frozen, and in float64 with it
in training mode (``FREEZE_BN: false``), whose float32 backbone gradients
are as sensitive. The port's own single process on the global batch in
float64 holds the ranks within 1e-9, frozen and in training mode. Also:
the ranks' parameters bit-identical after two steps, a non-finite batch
on one rank skipped by both, and ``train()`` on two ranks against one
process.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_slice import _seeded_variables
from test_torch_train_step import STEM, _jax_config, _jax_loss_fn

from pemp_tpu.losses import dispatch_loss_func as jax_dispatch_loss_func
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.parallel import make_mesh, replicate, shard_batch, shard_train_step
from pemp_tpu.train.convert import convert_composite_state_dict
from pemp_tpu_torch.config import small_train
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.parallel.distributed import run_ranks
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
from pemp_tpu_torch.weights import from_jax_variables

WORLD = 2
BATCH = 4
DEADLINE_S = 60.0


def _cfg(freeze_bn=True):
    cfg = small_train()
    cfg.TRAIN.BATCH_SIZE = BATCH
    cfg.TRAIN.FREEZE_BN = freeze_bn
    cfg.MODEL.PRETRAINED = ""          # train() checkpoints into its log directory
    return cfg


def _batches(seed, n, size=BATCH):
    rng = np.random.RandomState(seed)
    return [make_batch(rng, size, 64, (16, 32), 17, 30, scale_range=(0.4, 0.9))
            for _ in range(n)]


def _jax_sharded_step(cfg, variables, batch, f64=False):
    """The JAX package's step on ``batch`` sharded over a 2-device mesh
    (float64 under ``jax.enable_x64`` with the variables and the batch
    widened): (gradients, loss, running statistics, loss parts, labels)
    as numpy, and its config."""
    jcfg = _jax_config(cfg)
    dtype = jnp.float64 if f64 else jnp.float32

    def wide(x):
        x = np.asarray(x)
        return jnp.asarray(x.astype(dtype) if np.issubdtype(x.dtype, np.floating) else x)

    with jax.enable_x64(f64):
        jmodel = jax_build_pose_model(jcfg, dtype=dtype)
        loss_fn = _jax_loss_fn(jmodel, jax_dispatch_loss_func(jcfg), jcfg)

        def grad_step(state, batch):
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state["params"], state["batch_stats"], batch)
            return grads, loss, aux

        mesh = make_mesh(WORLD)
        state = replicate(jax.tree_util.tree_map(wide, {
            "params": variables["params"], "batch_stats": variables["batch_stats"]}), mesh)
        jbatch = shard_batch(jax.tree_util.tree_map(wide, batch), mesh)
        assert len(jbatch["imgs"].sharding.device_set) == WORLD
        grads, loss, (stats, logging, labels, _) = shard_train_step(grad_step, mesh)(state,
                                                                                   jbatch)
        assert loss.dtype == dtype
        out = jax.tree_util.tree_map(np.asarray, (grads, loss, stats, logging, labels))
    return out, jcfg


def _single(cfg, state, batch, f64):
    """One step of one process on the global batch: (loss parts, grads,
    running statistics)."""
    trainer = build_trainer(cfg, device="cpu", seed=0)
    trainer.model.load_state_dict(state)
    tbatch = batch_to_torch(batch, "cpu")
    if f64:
        from torch_dp_ranks import to_f64

        tbatch = to_f64(trainer, tbatch)
    loss, logging = trainer.step(tbatch)
    return ({k: float(v) for k, v in logging.items()},
            {k: p.grad.clone() for k, p in trainer.model.named_parameters()
             if p.grad is not None},
            {k: b.clone() for k, b in trainer.model.named_buffers() if "running" in k})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX sharded steps (in a thread) and the spawns of two ranks
    that run every job of this file."""
    cfg = _cfg()
    jax_cfg = _cfg()
    jax_cfg.TRAIN.BATCH_SIZE = WORLD
    jax_batches = _batches(0, 2, size=WORLD)
    batches = _batches(0, 2)
    variables = _seeded_variables(jax_build_pose_model(_jax_config(cfg), dtype=jnp.float32),
                                  jnp.asarray(jax_batches[0]["imgs"]), np.random.RandomState(0))
    # the JAX steps run in a thread while the ranks run (each rank is one
    # process on one thread)
    jax_runs = concurrent.futures.ThreadPoolExecutor(1)
    jax_steps = {case: jax_runs.submit(_jax_sharded_step, c, variables, b, f64)
                 for case, (c, b, f64) in {
                     "b2_f32": (jax_cfg, jax_batches[0], False),
                     "b4_f32": (cfg, batches[0], True),
                     "b4_f64_bn_train": (_cfg(freeze_bn=False), batches[0], True)}.items()}

    torch_state = from_jax_variables(variables["params"], variables["batch_stats"], cfg)
    # the float64 cases against one process start from the port's own
    # seeded weights: at the JAX package's with the backbone's BatchNorm in
    # training mode, that process's float64 step takes ~80 s on one thread
    own_state = build_trainer(cfg, device="cpu", seed=0).model.state_dict()
    nan_image = [dict(b) for b in _batches(1, 2)]
    nan_image[0]["imgs"] = nan_image[0]["imgs"].copy()
    nan_image[0]["imgs"][BATCH - 1] = np.nan            # an image of rank 1's rows
    nan_target = [dict(b) for b in _batches(1, 2)]
    nan_target[0]["heatmaps"] = [h.copy() for h in nan_target[0]["heatmaps"]]
    nan_target[0]["heatmaps"][0][BATCH - 1, 0, 0, 0] = np.nan
    f64_batch = _batches(2, 1)
    jobs = [("train_steps", (jax_cfg, torch_state, jax_batches)),
            ("train_steps", (cfg, own_state, f64_batch, True)),
            ("train_steps", (_cfg(freeze_bn=False), own_state, f64_batch, True)),
            ("train_steps", (cfg, torch_state, nan_image)),
            ("train_steps", (cfg, torch_state, nan_target)),
            ("train_entry", (cfg, batches, _batches(3, 1), str(tmp_path_factory.mktemp("dp")))),
            ("train_steps", (cfg, torch_state, batches[:1])),
            ("train_steps", (_cfg(freeze_bn=False), torch_state, batches[:1], True))]
    from torch_dp_ranks import run_jobs

    # four spawns, each within its deadline on a loaded host; each rank's
    # results in the order of ``jobs``
    ranks = [[], []]
    for group in ((0, 3, 4), (1, 2), (5,), (6, 7)):
        out = run_ranks(run_jobs, WORLD, tmp_path_factory.mktemp("ranks"),
                        [jobs[i] for i in group], deadline_s=DEADLINE_S)
        for r in range(WORLD):
            ranks[r] += list(zip(group, out[r]))
    ranks = [[res for _, res in sorted(r, key=lambda x: x[0])] for r in ranks]

    jax_steps = {case: step.result() for case, step in jax_steps.items()}
    jax_runs.shutdown()
    return dict(cfg=cfg, jax_steps=jax_steps, state=torch_state, own_state=own_state,
                batches=batches, f64_batch=f64_batch, ranks=ranks)


def _labels_match(ref, ranks):
    labels = ref[0][4]
    records = [r["records"][0] for r in ranks]
    for key in ("node", "class", "person", "edge"):
        want = np.asarray(labels[key][0] if key == "edge" else labels[key])
        got = torch.cat([rec["labels"][key] for rec in records]).numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert want.sum() > 10


def _losses_match(ref, ranks):
    _, loss, _, logging, _ = ref[0]
    for r in ranks:
        rec = r["records"][0]
        for key in ("heatmap", "node", "edge", "class_loss", "loss"):
            np.testing.assert_allclose(rec["logging"][key], float(logging[key]), rtol=5e-3,
                                       atol=1e-6, err_msg=key)
        np.testing.assert_allclose(rec["loss"], float(loss), rtol=5e-3)


def _gradients_and_statistics_match(ref, rank0, state):
    (grads, _, stats, _, _), jcfg = ref
    rec = rank0["records"][0]
    sd = {k: g.double().numpy() for k, g in rec["grads"].items()}
    sd.update({k: b.double().numpy() for k, b in rec["stats"].items()})
    for k, v in state.items():
        sd.setdefault(k, v.numpy())
    got, got_stats = convert_composite_state_dict(sd, jcfg)
    want, got = flatten_dict(grads), flatten_dict(got)
    assert set(want) == set(got)
    for key in want:
        w, g = np.asarray(want[key]), np.asarray(got[key])
        if key[-2:] == ("attn_net", "bias"):
            # constant within each softmax group: no gradient in the port,
            # rounding in the JAX package (tests/test_torch_gt_train.py)
            assert not g.any() and np.abs(w).max() < 1e-6
            continue
        tol = 5e-2 if key[:2] in STEM else 5e-3
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * float(np.abs(w).max()),
                                   err_msg=str(key))
    # every running statistic: the MPN's, and the backbone's, which move
    # only with FREEZE_BN false
    want, got = flatten_dict(stats), flatten_dict(got_stats)
    assert set(want) == set(got)
    for key in want:
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=str(key))


def test_labels_match_the_sharded_jax_step(run):
    _labels_match(run["jax_steps"]["b2_f32"], [r[0] for r in run["ranks"]])


def test_losses_match_the_sharded_jax_step(run):
    _losses_match(run["jax_steps"]["b2_f32"], [r[0] for r in run["ranks"]])


def test_gradients_and_statistics_match_the_sharded_jax_step(run):
    _gradients_and_statistics_match(run["jax_steps"]["b2_f32"], run["ranks"][0][0], run["state"])


@pytest.mark.parametrize("case,job", [("b4_f32", 6), ("b4_f64_bn_train", 7)])
def test_batch_of_4_matches_the_float64_sharded_jax_step(run, case, job):
    """Two rows a rank (global batch 4), the ranks in float32 with the
    backbone's BatchNorm frozen and in float64 with it in training mode,
    against the JAX package's sharded step in float64 (module docstring):
    labels, losses, gradients and every running statistic."""
    ref, ranks = run["jax_steps"][case], [r[job] for r in run["ranks"]]
    assert all(r["fail_count"] == 0 for r in ranks)
    _labels_match(ref, ranks)
    _losses_match(ref, ranks)
    _gradients_and_statistics_match(ref, ranks[0], run["state"])
    moved = [k for k, v in ranks[0]["records"][0]["stats"].items()
             if k.startswith("backbone.") and not torch.equal(v, run["state"][k].to(v.dtype))]
    assert bool(moved) == (case == "b4_f64_bn_train")


def test_ranks_stay_bit_identical(run):
    a, b = (r[0] for r in run["ranks"])
    assert len(a["records"]) == 2 and a["fail_count"] == b["fail_count"] == 0
    assert all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
    assert not all(torch.equal(a["state"][k], run["state"][k]) for k in a["state"])
    assert [r["loss"] for r in a["records"]] == [r["loss"] for r in b["records"]]


@pytest.mark.parametrize("job,freeze_bn", [(1, True), (2, False)])
def test_float64_ranks_equal_one_process(run, job, freeze_bn):
    """In float64 the two ranks' step is the single process's on the global
    batch to 1e-9: the BatchNorm moments (the backbone's too with
    FREEZE_BN false), the normalisers and the gradient sum are the same
    sums in another order."""
    parts, grads, stats = _single(_cfg(freeze_bn), run["own_state"], run["f64_batch"][0], True)
    for r in run["ranks"]:
        rec = r[job]["records"][0]
        for key, want in parts.items():
            assert abs(rec["logging"][key] - want) <= 1e-9 * max(1.0, abs(want)), key
        assert set(rec["grads"]) == set(grads)
        for key, want in grads.items():
            err = (rec["grads"][key] - want).abs().max().item()
            assert err <= 1e-9 * want.abs().max().item(), (key, err)
        for key, want in stats.items():
            err = (rec["stats"][key] - want).abs().max().item()
            assert err <= 1e-9 * max(1.0, want.abs().max().item()), (key, err)
    moved = [k for k in stats if k.startswith("backbone.")
             and not torch.equal(stats[k], run["own_state"][k].double())]
    assert bool(moved) == (not freeze_bn)


@pytest.mark.parametrize("job", [3, 4], ids=["nan_image", "nan_target"])
def test_a_non_finite_rank_makes_every_rank_skip(run, job):
    """A NaN in one image (or one heatmap target) of rank 1's rows: both
    ranks skip the step (fail_count 1), then both take the next."""
    for r in run["ranks"]:
        res = r[job]
        assert res["fail_count"] == 1
        assert [rec["logging"]["skipped"] for rec in res["records"]] == [1.0, 0.0]
        assert np.isfinite(res["records"][1]["loss"])
    a, b = (r[job]["state"] for r in run["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_train_entry_on_two_ranks_equals_one_process(run, tmp_path, monkeypatch):
    """``train()`` over the ranks' rows: the per-step and validation losses
    are one process's on the global batches; rank 0 writes the
    checkpoint."""
    import sys

    from pemp_tpu_torch.train.__main__ import train

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    want = train(run["cfg"], run["batches"], _batches(3, 1), str(tmp_path), epochs=1,
                 device="cpu")
    for r in run["ranks"]:
        got = r[5]
        assert got["fail_count"] == 0
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(got["val_losses"][0], want["val_losses"][0], rtol=1e-4)
    assert torch.load(run["ranks"][0][5]["ckpt_path"], weights_only=True)["epoch"] == 0
