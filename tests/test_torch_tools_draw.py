"""``python -m pemp_tpu_torch.draw_images --detail`` against
``tools/draw_images.py`` on a 2-image fake set, the narrow w48/640
configuration at scales [1.0, 0.5] with flip on ``fused_step`` (the JAX
side's K1 in interpret mode), the same seeded weights (the JAX model's
``init``, the port's ``MODEL.PRETRAINED``): the same file names, and the
arrays each drawing function is handed alike (keypoints and detections
within 2e-3, scores within 1e-4, validity, clusters and edges exact)."""

import pathlib
import sys

import numpy as np
import pytest
from test_torch_tta import OVERRIDES, jax_setup
from test_torch_valid import _Seeded

from pemp_tpu_torch import draw_images, make_fake_coco
from pemp_tpu_torch.config import load_config, update_config_command
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.train.checkpoint import save_checkpoint
from pemp_tpu_torch.utils import vis
from pemp_tpu_torch.weights import from_jax_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
TTA = ["TEST.SCALE_FACTOR", "[1.0,0.5]", "TEST.FLIP_TEST", "True", "TPU.MSG_PASS", "fused_step"]
DRAWINGS = ("save_valid_image", "draw_detections", "draw_detection_with_cluster",
            "draw_detection_classification_result", "draw_edges_conf",
            "draw_inter_person_edge_conf")


def _recorder(module, monkeypatch):
    calls = []
    for name in DRAWINGS:
        real = getattr(module, name)

        def record(*args, _name=name, _real=real, **kwargs):
            calls.append((_name, args))
            return _real(*args, **kwargs)
        monkeypatch.setattr(module, name, record)
    return calls


@pytest.fixture(scope="module")
def drawn(tmp_path_factory):
    base = tmp_path_factory.mktemp("draw")
    root = base / "coco"
    make_fake_coco.make_fake_coco(str(root), images=2, size=96)
    opts = OVERRIDES + TTA + ["DATASET.ROOT", str(root)]
    jcfg, jmodel, variables = jax_setup(opts)

    import pemp_tpu.models
    import pemp_tpu.utils.vis as jvis

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(pemp_tpu.models, "build_pose_model", lambda cfg: _Seeded(jmodel, variables))
        jax_calls = _recorder(jvis, mp)
        mp.syspath_prepend(str(ROOT / "tools"))
        mp.chdir(ROOT)
        mp.setattr(sys, "argv", ["draw_images.py", "--config", "hrnet/w48_640", "--out",
                                 str(base / "jax"), "--detail", *opts, "MODEL.PRETRAINED", ""])
        import draw_images as jax_tool

        jax_tool.main()

        port_cfg = update_config_command(load_config("hrnet/w48_640"), opts)
        model = build_pose_model(port_cfg, device="cpu", path="valid")
        model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"],
                                                 port_cfg))
        save_checkpoint(str(base / "weights.pt"), model)
        port_calls = _recorder(vis, mp)
        written = draw_images.main(["--config", "hrnet/w48_640", "--out", str(base / "port"),
                                    "--detail", "--device", "cpu", *opts,
                                    "MODEL.PRETRAINED", str(base / "weights.pt")])
    finally:
        mp.undo()
    return dict(base=base, jax=jax_calls, port=port_calls, written=written)


def test_draw_images_writes_the_same_files(drawn):
    base = drawn["base"]
    names = sorted(p.name for p in (base / "jax").iterdir())
    assert sorted(p.name for p in (base / "port").iterdir()) == names
    assert len(names) == 2 * 8 and sorted(pathlib.Path(p).name for p in drawn["written"]) == names
    assert {n.split("_", 1)[1] for n in names} == {
        "poses.png", "det.png", "det_cluster.png", "det_fp.png", "edge_conf.png",
        "inter_per_edge_conf_0.png", "inter_per_edge_conf_3.png", "inter_per_edge_conf_4.png"}


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=what)


def test_draw_images_hands_vis_the_same_arrays(drawn):
    """Per call: the image or canvas, persons (2e-3), detections (2e-3),
    valid nodes, clusters, node scores and labels, edges and their scores."""
    assert [c[0] for c in drawn["port"]] == [c[0] for c in drawn["jax"]]
    persons = 0
    for (name, got), (_, want) in zip(drawn["port"], drawn["jax"]):
        if name == "draw_detection_with_cluster":
            want = want[:-1]        # the JAX function's unused num_joints
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            if isinstance(w, (str, int)):
                assert pathlib.Path(str(g)).name == pathlib.Path(str(w)).name, name
                continue
            g, w = np.asarray(g), np.asarray(w)
            if name == "save_valid_image" and i == 1 or w.ndim == 2 and w.shape[-1] == 3:
                # persons (P, J, 3) and detections (N, 3): coordinates 2e-3
                assert g.shape == w.shape, name
                np.testing.assert_allclose(g, w, rtol=0, atol=2e-3, err_msg=name)
                persons += len(w) if name == "save_valid_image" else 0
            else:
                _close(g, w, f"{name} argument {i}")
    assert persons > 0
