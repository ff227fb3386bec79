"""model_81_1_2, the CrowdPose flagship, port against JAX package at 14
joint types (the MPN at T = 14, EDGE_INPUT_DIM 16): the small cut
(config.small_81_1_2: narrow HigherHRNet at 64x64, batch 2, K = 8, 3 MPN
steps) on the fused-step eval route (K1's plain version against the JAX
kernel in interpret mode), and one training step on the ``pallas`` route
(K2 and K2b's plain versions against the JAX kernels in interpret mode),
at the tolerances the 17-type tests use (test_torch_slice.py,
test_torch_train_step.py). Also the ``mmpose_hrnet`` checkpoint names: a
state dict in mmpose's names loads into the port as
pemp_tpu.train.convert.convert_mmpose_state_dict reads it."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_slice import _jax_config as _jax_eval_config
from test_torch_slice import _seeded_variables
from test_torch_train_step import STEM, _jax_loss_fn
from test_torch_train_step import _jax_config as _jax_train_config

from pemp_tpu.decode.assembly import decode_poses as jax_decode
from pemp_tpu.losses import dispatch_loss_func as jax_dispatch_loss_func
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.train.convert import convert_composite_state_dict
from pemp_tpu_torch.config import small_81_1_2
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.pipeline import Pipeline
from pemp_tpu_torch.train.checkpoint import load_params_only
from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
from pemp_tpu_torch.weights import from_jax_variables

B, J = 2, 14
# the batch's seed (seed 0's scene gives the seeded network only 4 label-positive
# nodes, too few for the label check)
SEED = 1


def _interpret(jmodel):
    # build_pose_model turns Pallas off away from a TPU; interpret mode runs
    # the kernels on the CPU
    jmodel.mpn_cfg["_USE_PALLAS"] = True
    jmodel.mpn_cfg["_PALLAS_INTERPRET"] = True
    return jmodel


@pytest.fixture(scope="module")
def eval_run():
    port_cfg = small_81_1_2()
    # the fused-step route, threshold decode at the 17-type slice test's
    # node threshold (the file's 1.0 passes no sigmoid score)
    port_cfg.merge_from_other({"TPU": {"MSG_PASS": "fused_step"},
                               "MODEL": {"GC": {"CC_METHOD": "threshold"},
                                         "MPN": {"NODE_THRESHOLD": 0.1}}})
    jcfg = _jax_eval_config(port_cfg)
    jmodel = _interpret(jax_build_pose_model(jcfg, dtype=jnp.float32))
    assert jmodel.mpn_cfg.get("_FUSED_STEP") and jmodel.mpn_cfg["NUM_JOINTS"] == J
    rng = np.random.RandomState(0)
    imgs = rng.rand(B, 64, 64, 3).astype(np.float32)
    variables = _seeded_variables(jmodel, jnp.asarray(imgs), rng)
    scoremaps, out = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(imgs))
    model = build_pose_model(port_cfg, dtype=torch.float32, device="cpu", path="valid")
    model.load_state_dict(from_jax_variables(
        variables["params"], variables["batch_stats"], port_cfg))
    pipe = Pipeline(model, port_cfg.MODEL.MPN.NODE_THRESHOLD, J)
    persons, valid, p_scoremaps, p_out = pipe.forward(torch.from_numpy(imgs))
    return dict(jcfg=jcfg, port_cfg=port_cfg, variables=variables, jax=(scoremaps, out),
                port=(p_scoremaps, p_out, persons, valid))


def test_eval_maps_and_graph_match(eval_run):
    scoremaps, out = eval_run["jax"]
    p_scoremaps, p_out = eval_run["port"][:2]
    assert p_scoremaps.shape[-1] == J
    np.testing.assert_allclose(p_scoremaps.numpy(), np.asarray(scoremaps), atol=1e-4, rtol=1e-4)
    for key in ("nodes", "edge_index", "edge_valid", "node_valid"):
        np.testing.assert_array_equal(p_out["graph"][key].numpy(),
                                      np.asarray(out["graph"][key]), err_msg=key)
    assert p_out["graph"]["nodes"].shape[0] == B * J * 8
    assert np.asarray(out["graph"]["edge_valid"]).sum() > 1000


def test_eval_mpn_outputs_match(eval_run):
    """The fused step at T = 14: the JAX package's fused-vs-plain MPN
    tolerance (2e-3), as at T = 17."""
    _, out = eval_run["jax"]
    p_out = eval_run["port"][1]
    ev = np.asarray(out["graph"]["edge_valid"])
    np.testing.assert_allclose(p_out["preds"]["edge"][-1].numpy()[ev],
                               np.asarray(out["preds"]["edge"][-1])[ev], atol=2e-3, rtol=2e-3)
    for key in ("node", "class"):
        np.testing.assert_allclose(p_out["preds"][key][-1].numpy(),
                                   np.asarray(out["preds"][key][-1]),
                                   atol=2e-3, rtol=2e-3, err_msg=key)
    assert p_out["preds"]["class"][-1].shape[-1] == J


def test_eval_persons_match(eval_run):
    """Decode exactly, where no sigmoid lies within 1e-4 of the 0.8 edge or
    the node threshold (checked first)."""
    scoremaps, out = eval_run["jax"]
    persons, valid = eval_run["port"][2:]
    threshold = eval_run["port_cfg"].MODEL.MPN.NODE_THRESHOLD
    g = out["graph"]
    edge_pred = jax.nn.sigmoid(out["preds"]["edge"][-1])
    node_pred = jax.nn.sigmoid(out["preds"]["node"][-1])
    class_prob = jax.nn.softmax(out["preds"]["class"][-1], axis=-1)
    ev = np.asarray(g["edge_valid"])
    assert np.all(np.abs(np.asarray(edge_pred)[ev] - 0.8) > 1e-4)
    assert np.all(np.abs(np.asarray(node_pred) - threshold) > 1e-4)
    n = J * eval_run["port_cfg"].TPU.NODES_PER_TYPE
    e = g["edge_index"].shape[1] // B
    per_img = lambda x: x.reshape(B, -1, *x.shape[1:])  # noqa: E731
    decode = jax.jit(jax.vmap(functools.partial(
        jax_decode, node_threshold=threshold, num_joints=J, blocked_c=e // n,
        channels_last=True)))
    local_ei = (g["edge_index"].reshape(2, B, e).transpose(1, 0, 2)
                - (jnp.arange(B) * n)[:, None, None])
    wp, wv = decode(
        scoremaps, g["tags"], per_img(g["nodes"]), per_img(node_pred), local_ei,
        per_img(g["edge_valid"]), per_img(edge_pred), per_img(g["node_valid"]),
        class_probs=per_img(class_prob))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(persons[..., :2].numpy(), np.asarray(wp)[..., :2])
    np.testing.assert_allclose(persons[..., 2].numpy(), np.asarray(wp)[..., 2], atol=1e-6, rtol=0)
    assert persons.shape[2] == J


def test_mmpose_names_load_as_convert_reads_them(eval_run, tmp_path):
    """The composite's state dict renamed to mmpose's (the HigherHRNet under
    ``backbone.backbone.*``, its heads under ``backbone.keypoint_head.*``):
    pemp_tpu's convert_composite_state_dict (which strips them through
    convert_mmpose_state_dict for MODEL.KP mmpose_hrnet) gives the JAX
    variables back, and the port's load_params_only loads the same weights."""
    params, stats = eval_run["variables"]["params"], eval_run["variables"]["batch_stats"]
    sd = from_jax_variables(params, stats, eval_run["port_cfg"])
    head = ("backbone.final_layers.", "backbone.deconv_layers.")
    mmpose = {(k.replace("backbone.", "backbone.keypoint_head.", 1) if k.startswith(head)
               else k.replace("backbone.", "backbone.backbone.", 1) if k.startswith("backbone.")
               else k): v for k, v in sd.items()}
    assert any(".keypoint_head.final_layers." in k for k in mmpose)
    assert eval_run["jcfg"].MODEL.KP == "mmpose_hrnet"
    back_params, back_stats = convert_composite_state_dict(
        {k: v.numpy() for k, v in mmpose.items()}, eval_run["jcfg"])
    for want, got in ((params, back_params), (stats, back_stats)):
        fw, fg = flatten_dict(want), flatten_dict(got)
        assert set(fw) == set(fg)
        for key in fw:
            np.testing.assert_array_equal(np.asarray(fg[key]), np.asarray(fw[key]),
                                          err_msg=str(key))
    torch.save({"state_dict": mmpose}, tmp_path / "mmpose.pth")
    model = build_pose_model(eval_run["port_cfg"], device="cpu", path="valid")
    load_params_only(str(tmp_path / "mmpose.pth"), model)
    got = model.state_dict()
    assert set(got) == set(sd)
    for key in sd:
        assert torch.equal(got[key], sd[key]), key


@pytest.fixture(scope="module")
def step_run():
    port_cfg = small_81_1_2()
    jcfg = _jax_train_config(port_cfg)
    jmodel = _interpret(jax_build_pose_model(jcfg, dtype=jnp.float32))
    rng = np.random.RandomState(SEED)
    batch = make_batch(rng, B, 64, (16, 32), J, 30, scale_range=(0.4, 0.9))
    variables = _seeded_variables(jmodel, jnp.asarray(batch["imgs"]), rng)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    loss_fn = _jax_loss_fn(jmodel, jax_dispatch_loss_func(jcfg), jcfg)
    (loss, (stats, logging, labels, masks)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], jbatch)

    trainer = build_trainer(port_cfg, device="cpu")
    trainer.model.load_state_dict(from_jax_variables(
        variables["params"], variables["batch_stats"], port_cfg))
    trainer.model.train()
    p_loss, p_logging, p_out = trainer.loss(batch_to_torch(batch, "cpu"))
    p_loss.backward()
    return dict(jcfg=jcfg, jax=(loss, stats, logging, labels, masks, grads),
                port=(p_loss, p_logging, p_out), trainer=trainer)


def test_train_labels_and_loss_parts_match(step_run):
    loss, _, logging, labels, masks, _ = step_run["jax"]
    p_loss, p_logging, p_out = step_run["port"]
    for key in ("node", "class", "person"):
        np.testing.assert_array_equal(p_out["labels"][key].numpy(), np.asarray(labels[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(p_out["labels"]["edge"][0].numpy(),
                                  np.asarray(labels["edge"][0]))
    np.testing.assert_array_equal(p_out["masks"]["edge"][0].numpy(), np.asarray(masks["edge"][0]))
    assert np.asarray(labels["node"]).sum() > 5 and np.asarray(labels["edge"][0]).sum() > 10
    assert int(np.asarray(labels["class"]).max()) < J
    for key in ("heatmap", "node", "edge", "class_loss", "loss"):
        np.testing.assert_allclose(float(p_logging[key].detach()), float(logging[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(p_loss.detach()), float(loss), rtol=1e-4)


def test_train_gradients_match_per_tensor(step_run):
    """Every parameter's gradient within 5e-3 of that tensor's largest
    |grad| (5e-2 on the backbone's stem), as test_torch_train_step holds
    the 17-type step; the per-type node MLP has 14 types."""
    grads = step_run["jax"][5]
    model = step_run["trainer"].model
    assert len(model.mpn.mpn_node_cls.mlp_node.mlp) == J
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
          for k, p in model.named_parameters()}
    sd.update({k: b.numpy() for k, b in model.named_buffers()})
    got, _ = convert_composite_state_dict(sd, step_run["jcfg"])
    want, got = flatten_dict(grads), flatten_dict(got)
    assert set(want) == set(got)
    for key in want:
        w, g = np.asarray(want[key]), np.asarray(got[key])
        tol = 5e-2 if key[:2] in STEM else 5e-3
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * float(np.abs(w).max()),
                                   err_msg=str(key))
