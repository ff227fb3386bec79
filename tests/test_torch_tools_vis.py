"""The drawings without matplotlib, port against the JAX package: every
drawing function of ``pemp_tpu_torch.utils.vis`` selects the segments,
points and colours (with widths and marker areas) that the matching
function of ``pemp_tpu.utils.vis`` hands matplotlib, in the same order,
recorded through a stand-in for ``plt.subplots``; the PNG it writes
decodes (PIL) to the image's size, to the rendered array, with the last
dot's colour at its point."""

import matplotlib
import numpy as np
import pytest
from matplotlib import colors as mcolors
from PIL import Image

from pemp_tpu.utils import vis as jvis
from pemp_tpu_torch.utils import vis

matplotlib.use("Agg")
H, W = 90, 110


class _Ax:
    def __init__(self, calls):
        self.calls = calls

    def imshow(self, img):
        self.calls["image"] = np.asarray(img)

    def axis(self, *args):
        pass

    def plot(self, xs, ys, color=None, linewidth=None, alpha=None):
        rgb = tuple(mcolors.to_rgba(color)[:3])
        self.calls["lines"].append((np.asarray(xs, np.float64), np.asarray(ys, np.float64),
                                    rgb, float(linewidth)))

    def scatter(self, xs, ys, s=None, c=None, zorder=None):
        xs = np.asarray(xs, np.float64).reshape(-1)
        rgb = mcolors.to_rgba_array(c)[:, :3] if len(np.atleast_1d(c)) else np.zeros((0, 3))
        if len(rgb) == 1:
            rgb = np.repeat(rgb, len(xs), axis=0)
        self.calls["dots"].append((xs, np.asarray(ys, np.float64).reshape(-1), rgb, float(s)))


class _Fig:
    def __init__(self, calls):
        self.calls = calls

    def savefig(self, fname, **kwargs):
        self.calls["fname"] = str(fname)


@pytest.fixture
def recorded(monkeypatch):
    import matplotlib.pyplot as plt

    calls = {"lines": [], "dots": []}
    monkeypatch.setattr(plt, "subplots", lambda *a, **k: (_Fig(calls), _Ax(calls)))
    monkeypatch.setattr(plt, "close", lambda fig: None)
    return calls


def _scene():
    rng = np.random.RandomState(3)
    n, e = 70, 500
    det = np.stack([rng.uniform(0, W - 1, n), rng.uniform(0, H - 1, n),
                    rng.randint(0, 17, n)], 1).astype(np.float32)
    det[:20, 2] = np.repeat([0, 3, 4, 5], 5)        # several nodes of the detail types
    valid = rng.rand(n) < 0.85
    labels = rng.randint(0, 5, n)
    scores = rng.rand(n).astype(np.float32)
    ei = rng.randint(0, n, (2, e)).astype(np.int32)
    ei[1, :150] = rng.randint(0, 20, 150)           # many edges into the detail types
    ep = rng.rand(e).astype(np.float32)
    persons = np.concatenate([rng.uniform(0, 100, (3, 17, 2)),
                              (rng.rand(3, 17, 1) < 0.8) * rng.rand(3, 17, 1)], 2)
    image = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    return dict(det=det, valid=valid, labels=labels, scores=scores, ei=ei, ep=ep,
                persons=persons.astype(np.float32), image=image)


def _cases(s):
    """(name, the JAX call, the port's marks, the port's drawing, its file)."""
    img, det, v, lab, ns, ei, ep = (s["image"], s["det"], s["valid"], s["labels"], s["scores"],
                                    s["ei"], s["ep"])
    gray = np.full((H, W, 3), 0.3, np.float32)
    gt = s["persons"][:2] + 3.0
    return {
        "poses": (lambda f: jvis.save_valid_image(img, s["persons"], f, "COCO", gt),
                  vis.pose_marks(s["persons"], "COCO", gt),
                  lambda f: vis.save_valid_image(img, s["persons"], f, "COCO", gt), ""),
        "poses_crowdpose": (lambda f: jvis.save_valid_image(img, s["persons"][:, :14], f,
                                                            "CROWDPOSE"),
                            vis.pose_marks(s["persons"][:, :14], "CROWDPOSE"),
                            lambda f: vis.save_valid_image(img, s["persons"][:, :14], f,
                                                           "CROWDPOSE"), ""),
        "detections": (lambda f: jvis.draw_detections(gray, det, v, f),
                       vis.detection_marks(det, v),
                       lambda f: vis.draw_detections(gray, det, v, f), ""),
        "cluster": (lambda f: jvis.draw_detection_with_cluster(gray, det, lab, v, f),
                    vis.cluster_marks(det, lab, v),
                    lambda f: vis.draw_detection_with_cluster(gray, det, lab, v, f),
                    "_det_cluster.png"),
        "classification": (lambda f: jvis.draw_detection_classification_result(
                               gray, det, ns > 0.5, v, f),
                           vis.classification_marks(det, ns > 0.5, v),
                           lambda f: vis.draw_detection_classification_result(
                               gray, det, ns > 0.5, v, f), "_det_fp.png"),
        "edges_conf": (lambda f: jvis.draw_edges_conf(gray, det, lab, ns, ei, ep, v, f),
                       vis.edges_conf_marks(det, lab, ns, ei, ep, v),
                       lambda f: vis.draw_edges_conf(gray, det, lab, ns, ei, ep, v, f),
                       "_edge_conf.png"),
        **{f"inter_person_{t}": (
            lambda f, t=t: jvis.draw_inter_person_edge_conf(gray, det, lab, ns, ei, ep, v, t,
                                                            f, 17),
            vis.inter_person_marks(det, lab, ns, ei, ep, v, t, 17),
            lambda f, t=t: vis.draw_inter_person_edge_conf(gray, det, lab, ns, ei, ep, v, t,
                                                           f, 17),
            f"_inter_per_edge_conf_{t}.png") for t in (0, 3, 4)},
    }


CASES = ["poses", "poses_crowdpose", "detections", "cluster", "classification", "edges_conf",
         "inter_person_0", "inter_person_3", "inter_person_4"]


def _assert_marks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_allclose(np.asarray(g[2], np.float64), np.asarray(w[2], np.float64),
                                   rtol=0, atol=1e-12)
        assert g[3] == w[3]


@pytest.mark.parametrize("name", CASES)
def test_marks_match_matplotlib_calls(name, recorded, tmp_path):
    jax_draw, marks, draw, suffix = _cases(_scene())[name]
    stem = str(tmp_path / "jax")
    jax_draw(stem if suffix else stem + ".png")
    assert recorded["fname"] == (stem + suffix if suffix else stem + ".png")
    _assert_marks(marks.lines, recorded["lines"])
    _assert_marks(marks.dots, recorded["dots"])
    assert marks.dots and (marks.lines or name in ("detections", "cluster", "classification"))

    # the port's PNG: the image's size, the rendered array, the last dot on top
    port_stem = str(tmp_path / "port")
    path = draw(port_stem if suffix else port_stem + ".png")
    assert path == (port_stem + suffix if suffix else port_stem + ".png")
    base = _scene()["image"] if name.startswith("poses") else np.full((H, W, 3), 0.3)
    decoded = np.asarray(Image.open(path).convert("RGB"))
    assert decoded.shape == (H, W, 3)
    np.testing.assert_array_equal(decoded, vis.render(base, marks))
    xs, ys, rgbs, _ = next(d for d in reversed(marks.dots) if len(d[0]))
    y, x = int(np.rint(ys[-1])), int(np.rint(xs[-1]))
    if 0 <= y < H and 0 <= x < W:
        np.testing.assert_array_equal(decoded[y, x], np.floor(rgbs[-1] * 255 + 0.5))


def test_png_of_a_line():
    """One red line over black: the pixels along it are red, the rest
    black; a float image in [0, 1] is taken as it is."""
    marks = vis.Marks()
    marks.line((2.0, 3.0), (12.0, 3.0), (1.0, 0.0, 0.0), 1.0)
    out = vis.render(np.zeros((8, 16, 3), np.float32), marks)
    assert (out[3, 2:13] == [255, 0, 0]).all()
    assert out.sum() == 255 * 11
