"""The AE-grouping host decode, port against JAX package, exactly on the
same maps: Munkres (random, tie-heavy and rectangular costs), the
HigherHRNet parser (HeatmapParser: NMS, top-k, tag matching, quarter
adjust, refine), correlation clustering on the tags (cluster_cc), the
Hourglass parsers HeatmapParserHG and HeatmapParserHG2, and
mpn_match_by_tag. The scenes are crowded and their scores quantised, so
ties in the top-k and in the assignment occur."""

import numpy as np
import pytest

from pemp_tpu.decode import ae_grouping as jax_ae
from pemp_tpu.decode import group_hg as jax_hg
from pemp_tpu.decode.munkres import Munkres as JaxMunkres
from pemp_tpu_torch.config import hg_512, w32_512
from pemp_tpu_torch.decode import ae_grouping, group_hg
from pemp_tpu_torch.decode.munkres import Munkres, min_cost_pairs


def scene(seed, j=17, h=48, w=56, people=6, s=2):
    """Heat maps (J, H, W) of ``people`` persons as Gaussian blobs over
    low noise, quantised to 1/64 (so equal scores occur), and tag maps
    (J, H, W, S) holding a per-person value plus noise under each blob."""
    rng = np.random.RandomState(seed)
    det = rng.rand(j, h, w) * 0.05
    tag = rng.randn(j, h, w, s) * 0.3
    yy, xx = np.mgrid[:h, :w]
    for _ in range(people):
        cx, cy = rng.uniform(4, w - 4), rng.uniform(4, h - 4)
        value = rng.uniform(-3, 3, s)
        for t in range(j):
            if rng.rand() < 0.15:
                continue
            x, y = cx + rng.randn() * 5, cy + rng.randn() * 5
            blob = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 3.0) * rng.uniform(0.3, 1.0)
            det[t] = np.maximum(det[t], blob)
            under = blob > 0.05
            tag[t][under] = value + rng.randn(int(under.sum()), s) * 0.15
    det = np.round(det * 64) / 64
    return det.astype(np.float32), tag.astype(np.float32)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["random", "ties", "wide", "tall", "integer"])
def test_munkres_matches(seed, kind):
    rng = np.random.RandomState(seed)
    if kind == "random":
        cost = rng.rand(9, 9)
    elif kind == "ties":
        cost = np.round(rng.rand(12, 12) * 3) * 100 - rng.randint(0, 3, (12, 1))
    elif kind == "wide":
        cost = rng.randint(0, 4, (5, 11)).astype(np.float64)
    elif kind == "tall":
        cost = rng.randint(0, 4, (11, 5)).astype(np.float64)
    else:
        cost = rng.randint(-50, 50, (8, 8))
    got, want = Munkres().compute(cost), JaxMunkres().compute(cost)
    assert got == want and len(got) == min(cost.shape)
    _same(min_cost_pairs(np.asarray(cost, np.float64)),
          jax_ae.min_cost_match(np.asarray(cost, np.float64)))


@pytest.mark.parametrize("seed,s", [(0, 1), (1, 2), (2, 2), (3, 1)])
@pytest.mark.parametrize("adjust,refine", [(True, True), (False, False)])
def test_heatmap_parser_matches(seed, s, adjust, refine):
    det, tag = scene(seed, s=s)
    cfg = w32_512()
    got = ae_grouping.HeatmapParser(cfg).parse(det, tag, adjust=adjust, refine=refine)
    want = jax_ae.HeatmapParser(cfg).parse(det, tag, adjust=adjust, refine=refine)
    assert len(want[0]) >= 3
    _same(got[0], want[0])
    _same(got[1], want[1])


def test_heatmap_parser_parts_and_fill_score():
    """top_k's three outputs with their dtypes, and refine with the 0.001
    fill score of Utils.py's refine."""
    det, tag = scene(5)
    port, ref = ae_grouping.HeatmapParser(w32_512()), jax_ae.HeatmapParser(w32_512())
    for got, want in zip(port.top_k(det, tag), ref.top_k(det, tag)):
        _same(got, want)
    kp = np.zeros((17, 3), np.float32)
    kp[0] = (10, 12, 0.8)
    kp[5] = (30, 20, 0.6)
    _same(port.refine(det, tag, kp, fill_score=0.001), ref.refine(det, tag, kp, fill_score=0.001))


@pytest.mark.parametrize("seed,s,j", [(0, 2, 17), (1, 1, 17), (2, 2, 14)])
def test_cluster_cc_matches(seed, s, j):
    det, tag = scene(seed, j=j, s=s)
    got = ae_grouping.cluster_cc(det, tag, j)
    want = jax_ae.cluster_cc(det, tag, j)
    assert len(want) >= 3
    _same(got, want)


def test_cluster_cc_without_detections():
    det = np.zeros((17, 16, 16), np.float32)
    _same(ae_grouping.cluster_cc(det, det, 17), jax_ae.cluster_cc(det, det, 17))


@pytest.mark.parametrize("seed,s", [(0, 1), (1, 2), (2, 1), (3, 2)])
@pytest.mark.parametrize("adjust", [True, False])
def test_heatmap_parser_hg_matches(seed, s, adjust):
    det, tag = scene(seed, s=s)
    got = group_hg.HeatmapParserHG(hg_512()).parse(det.copy(), tag, adjust=adjust)
    want = jax_hg.HeatmapParserHG(hg_512()).parse(det.copy(), tag, adjust=adjust)
    assert len(want[0]) >= 3
    _same(got[0], want[0])
    _same(got[1], want[1])


@pytest.mark.parametrize("seed,s", [(0, 1), (1, 2), (2, 1), (3, 2)])
def test_heatmap_parser_hg2_matches(seed, s):
    det, tag = scene(seed, s=s)
    got = group_hg.HeatmapParserHG2().parse(det.copy(), tag)
    want = jax_hg.HeatmapParserHG2().parse(det.copy(), tag)
    assert len(want[0]) >= 3
    _same(got[0], want[0])
    _same(got[1], want[1])


@pytest.mark.parametrize("seed", range(3))
def test_mpn_match_by_tag_matches(seed):
    """Node lists in natural order within each type, with a padded tail."""
    rng = np.random.RandomState(seed)
    j, k = 17, 12
    det, tag = scene(seed, s=2)
    ys, xs = rng.randint(0, 48, (j, k)), rng.randint(0, 56, (j, k))
    joint_det = np.stack([xs.ravel(), ys.ravel(), np.repeat(np.arange(j), k)], 1)
    tags = tag[joint_det[:, 2], joint_det[:, 1], joint_det[:, 0]]
    scores = det[joint_det[:, 2], joint_det[:, 1], joint_det[:, 0]] + 0.1
    params = (ae_grouping.Params(num_joints=j), jax_ae.Params(num_joints=j))
    _same(ae_grouping.mpn_match_by_tag(joint_det, tags, scores, params[0]),
          jax_ae.mpn_match_by_tag(joint_det, tags, scores, params[1]))
