"""Multi-scale + flip test-time augmentation, port against JAX package: the
projection onto the canvas against ``jax.image.scale_and_translate``, and
the whole TTAPipeline on the narrow test configuration (fused-step route,
K1's plain version against the JAX kernel in interpret mode) at scales
[1.0, 0.5] with flip and PROJECT2IMAGE, weights carried by
weights.from_jax_variables, over images of two sizes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import _seeded_variables

from pemp_tpu.config import get_config as jax_get_config
from pemp_tpu.config import update_config as jax_update_config
from pemp_tpu.config import update_config_command as jax_update_config_command
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu.tta import TTAPipeline as JaxTTAPipeline
from pemp_tpu.tta.multi_scale import project_region as jax_project_region
from pemp_tpu_torch.config import load_config, update_config_command
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.tta.multi_scale import TTAPipeline, project_region
from pemp_tpu_torch.weights import from_jax_variables

# (padded map h, w), valid (src_h, src_w), buffer (out_h, out_w), target region
PROJECTIONS = [
    ((64, 128), (40.0, 100.0), (128, 256), (80.0, 200.0)),    # up 2x
    ((128, 128), (128.0, 100.0), (128, 128), (64.0, 50.0)),   # down 2x
    ((33, 47), (31.0, 45.0), (65, 37), (57.0, 29.0)),         # odd dims, ragged
    ((32, 32), (32.0, 32.0), (32, 32), (32.0, 32.0)),         # identity
]


@pytest.mark.parametrize("shapes", PROJECTIONS, ids=lambda s: f"{s[0]}->{s[2]}")
def test_project_region_matches_scale_and_translate(shapes):
    (h, w), (sh, sw), (oh, ow), (th, tw) = shapes
    x = np.random.RandomState(0).randn(2, h, w, 5).astype(np.float32)
    want = np.stack([np.asarray(jax_project_region(
        jnp.asarray(x[i]), jnp.float32(sh), jnp.float32(sw), oh, ow,
        tgt_h=jnp.float32(th), tgt_w=jnp.float32(tw))) for i in range(2)])
    f = lambda v: torch.full((2,), v)  # noqa: E731
    got = project_region(torch.from_numpy(x), f(sh), f(sw), oh, ow, f(th), f(tw)).numpy()
    assert got.shape == (2, oh, ow, 5)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# the narrow configuration (config.SMALL) at 64 pixels, as KEY VALUE pairs
OVERRIDES = [
    "DATASET.INPUT_SIZE", "64", "DATASET.OUTPUT_SIZE", "[16,32]",
    "TPU.NODES_PER_TYPE", "8", "MODEL.MPN.STEPS", "3",
    "MODEL.HRNET.EXTRA.STAGE2.NUM_BLOCKS", "[1,1]",
    "MODEL.HRNET.EXTRA.STAGE2.NUM_CHANNELS", "[8,16]",
    "MODEL.HRNET.EXTRA.STAGE3.NUM_MODULES", "1",
    "MODEL.HRNET.EXTRA.STAGE3.NUM_BLOCKS", "[1,1,1]",
    "MODEL.HRNET.EXTRA.STAGE3.NUM_CHANNELS", "[8,16,24]",
    "MODEL.HRNET.EXTRA.STAGE4.NUM_MODULES", "2",
    "MODEL.HRNET.EXTRA.STAGE4.NUM_BLOCKS", "[1,1,1,1]",
    "MODEL.HRNET.EXTRA.STAGE4.NUM_CHANNELS", "[8,16,24,32]",
    "MODEL.HRNET.EXTRA.DECONV.NUM_CHANNELS", "[8]",
    "MODEL.HRNET.EXTRA.DECONV.NUM_BASIC_BLOCKS", "1",
]
TTA = ["TEST.SCALE_FACTOR", "[1.0,0.5]", "TEST.FLIP_TEST", "True", "TEST.PROJECT2IMAGE", "True",
       "TPU.MSG_PASS", "fused_step"]
SIZES = [(80, 100), (100, 72), (80, 100)]


def _images():
    return [(np.random.RandomState(i).rand(*hw, 3) * 255).astype(np.uint8)
            for i, hw in enumerate(SIZES)]


def jax_setup(opts, msg_pass_kernel=True, edge_bias=1.5):
    """The JAX model on the w48/640 file with ``opts``, and seeded variables
    whose edge logits sit around the 0.8 grouping threshold, so that
    persons form."""
    jcfg = jax_update_config_command(
        jax_update_config(jax_get_config(), "configs/hrnet/w48_640.yaml"), opts)
    jcfg.defrost()
    jcfg.TPU.COLLECT_AUX = False
    jcfg.freeze()
    jmodel = jax_build_pose_model(jcfg)
    if msg_pass_kernel:
        # the fused-step kernel in interpret mode (build_pose_model turns
        # Pallas off away from a TPU)
        jmodel.mpn_cfg["_USE_PALLAS"] = True
        jmodel.mpn_cfg["_PALLAS_INTERPRET"] = True
    size = jcfg.DATASET.INPUT_SIZE
    variables = _seeded_variables(jmodel, jnp.zeros((1, size, size, 3)),
                                  np.random.RandomState(0))
    variables["params"]["mpn"]["edge_classification"]["lin2"]["bias"] = np.array(
        [edge_bias], np.float32)
    return jcfg, jmodel, variables


class _NodeFeatures:
    """The JAX model, its MPN's outputs also carrying the graph's node
    features (as the ``tag`` head, which TTAPipeline passes on per image)."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    @staticmethod
    def mpn_forward(module, gb, **kwargs):
        return {**module.mpn_forward(gb, **kwargs), "tag": [gb.x]}


@pytest.fixture(scope="module")
def tta_run():
    jcfg, jmodel, variables = jax_setup(OVERRIDES + TTA)
    images = _images()
    jax_outs = JaxTTAPipeline(_NodeFeatures(jmodel), variables, jcfg).run_batched(
        images, batch_size=2)
    for o in jax_outs:
        o["node_features"] = o.pop("tag_pred")

    port_cfg = update_config_command(load_config("hrnet/w48_640"), OVERRIDES + TTA)
    model = build_pose_model(port_cfg, device="cpu", path="valid")
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"],
                                             port_cfg))
    pipe = TTAPipeline(model, port_cfg)
    return dict(jax=jax_outs, port=pipe.run_batched(images, batch_size=2), pipe=pipe)


@pytest.mark.parametrize("key", ["scoremaps", "tags", "node_features"])
def test_aggregated_maps_match(tta_run, key):
    for a, b in zip(tta_run["jax"], tta_run["port"]):
        got, want = b[key].numpy(), np.asarray(a[key])
        assert got.shape == want.shape
        # f32 convolutions summed in another order, then projected
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert tta_run["port"][0]["tags"].shape[-1] == 2          # original + flipped


def test_graphs_and_sizes_match(tta_run):
    for a, b in zip(tta_run["jax"], tta_run["port"]):
        for key in ("nodes", "edge_index", "edge_valid", "node_valid"):
            np.testing.assert_array_equal(b[key].numpy(), np.asarray(a[key]), err_msg=key)
        assert b["base_size"] == a["base_size"] and b["canvas_size"] == a["canvas_size"]
        assert b["scaling_type"] == a["scaling_type"] == "short_with_resize"
        assert int(a["node_valid"].sum()) > 50


def test_probabilities_and_persons_match(tta_run):
    """Persons are compared where no probability lies nearer the 0.8 edge
    or 0.1 node threshold than port and JAX differ (checked first)."""
    found = 0
    for a, b in zip(tta_run["jax"], tta_run["port"]):
        ev = np.asarray(a["edge_valid"])
        errs = {}
        for key in ("edge_pred", "node_scores", "class_prob"):
            got, want = b[key].numpy(), np.asarray(a[key])
            if key == "edge_pred":
                got, want = got[ev], want[ev]
            # the JAX package's fused-vs-plain MPN tolerance
            np.testing.assert_allclose(got, want, atol=2e-3, rtol=0, err_msg=key)
            errs[key] = np.abs(got - want).max()
        assert np.all(np.abs(np.asarray(a["edge_pred"])[ev] - 0.8) > errs["edge_pred"])
        assert np.all(np.abs(np.asarray(a["node_scores"]) - 0.1) > errs["node_scores"])
        np.testing.assert_array_equal(b["person_valid"].numpy(), np.asarray(a["person_valid"]))
        np.testing.assert_allclose(b["persons"].numpy(), np.asarray(a["persons"]),
                                   atol=2e-3, rtol=0)
        found += int(a["person_valid"].sum())
    assert found >= 2


def test_run_batched_equals_per_image(tta_run):
    """Batches of two over mixed sizes give what each image gives alone."""
    pipe = tta_run["pipe"]
    for image, b in zip(_images(), tta_run["port"]):
        one = pipe(image)
        for key in ("nodes", "edge_index", "edge_valid", "node_valid", "person_valid"):
            assert torch.equal(one[key], b[key]), key
        for key in ("scoremaps", "tags", "node_features", "edge_pred", "persons"):
            torch.testing.assert_close(one[key], b[key], atol=1e-5, rtol=0)
        assert one["base_size"] == b["base_size"]


def test_normalisation_keyed_on_dtype(tta_run):
    """A uint8 image is scaled by 255 whatever its values; the same image as
    float in [0, 1] gives the same prepared inputs."""
    pipe = tta_run["pipe"]
    image = _images()[0]
    dark = (image // 64).astype(np.uint8)
    got, base = pipe._prepare(dark)
    want, base_f = pipe._prepare(dark.astype(np.float32) / 255.0)
    assert base == base_f
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["padded"], w["padded"], atol=1e-5)
