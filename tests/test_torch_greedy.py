"""The greedy person construction (``MODEL.GC.CC_METHOD: greedy``), the
port's copy against the JAX package's, exactly: tests/test_greedy_decode.py's
three cases and random graphs (kNN-like edge lists with duplicate and
invalid slots, class probabilities with a background class, node scores
around the 0.5 seed threshold)."""

import numpy as np
import pytest

from pemp_tpu.decode import greedy_person_construction as jax_greedy
from pemp_tpu_torch.decode.greedy import greedy_person_construction

CASES = {
    "two_people": (np.array([[10, 10, 0], [12, 20, 1], [40, 12, 0], [42, 22, 1]]),
                   np.array([0.9, 0.8, 0.95, 0.7]), np.array([[0, 2, 0], [1, 3, 3]]),
                   np.array([0.9, 0.85, 0.1]), 2),
    "reassigns_on_higher_score": (np.array([[0, 0, 0], [5, 0, 0], [2, 2, 1]]),
                                  np.array([0.9, 0.9, 0.9]), np.array([[0, 1], [2, 2]]),
                                  np.array([0.6, 0.9]), 2),
    "low_score_nodes_cannot_seed": (np.array([[0, 0, 0], [2, 2, 1]]), np.array([0.3, 0.9]),
                                    np.array([[0], [1]]), np.array([0.9]), 2),
}


def _same(det, scores, edges, edge_scores, classes, j):
    want = jax_greedy(det, scores, edge_scores, classes, edges, num_joints=j)
    got = greedy_person_construction(det, scores, edge_scores, classes, edges, num_joints=j)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_reference_cases(case):
    det, scores, edges, edge_scores, j = CASES[case]
    _same(det.astype(np.int64), scores, edges, edge_scores, None, j)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("with_classes", [False, True])
def test_random_graphs(seed, with_classes):
    rng = np.random.RandomState(seed)
    j, per_type, c = 17, 4, 10
    n = j * per_type
    det = np.stack([rng.randint(0, 96, n), rng.randint(0, 96, n),
                    np.repeat(np.arange(j), per_type)], 1).astype(np.int32)
    valid = rng.rand(n) > 0.3
    scores = rng.rand(n).astype(np.float32) * valid
    src = rng.randint(0, n, n * c)
    edges = np.stack([src, np.repeat(np.arange(n), c)])
    edge_valid = rng.rand(n * c) > 0.4
    edge_scores = rng.rand(n * c).astype(np.float32) * edge_valid
    classes = None
    if with_classes:   # J + 1 classes: some nodes' argmax is the background
        classes = rng.rand(n, j + 1).astype(np.float32)
    persons, taken = _same(det, scores, edges, edge_scores, classes, j)
    assert (taken >= 0).any() and len(persons)
