"""The port's correlation clustering (the g++ multicut library built at
first use) against pemp_tpu.cluster.cluster_labels on seeded random
graphs: the same partition for GAEC, KL and MUT. A failed build raises."""

import numpy as np
import pytest

from pemp_tpu.cluster import cluster_labels as jax_cluster_labels
from pemp_tpu_torch.cluster import api


def _graph(seed, n):
    rng = np.random.RandomState(seed)
    e = 6 * n
    edges = rng.randint(0, n, (2, e))
    return edges, rng.randn(e) - 0.2


@pytest.mark.parametrize("method", ["GAEC", "KL", "MUT"])
@pytest.mark.parametrize("seed,n", [(0, 40), (1, 200), (2, 680)])
def test_cluster_labels_match(method, seed, n):
    edges, weights = _graph(seed, n)
    got = api.cluster_labels(edges, weights, n, method)
    want = jax_cluster_labels(edges, weights, n, method)
    assert got.dtype == np.int64 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    # each cluster is named by one of its nodes, as relabel_compact needs
    assert np.all(got[got] == got)
    assert 1 < len(np.unique(got)) < n


def test_no_edges_and_bad_input():
    np.testing.assert_array_equal(api.cluster_labels(np.zeros((2, 0)), [], 5), np.arange(5))
    with pytest.raises(ValueError, match="GAEC"):
        api.cluster_labels(np.zeros((2, 0)), [], 5, "greedy")
    with pytest.raises(ValueError, match="outside"):
        api.cluster_labels(np.array([[0], [5]]), [1.0], 5)
    with pytest.raises(ValueError, match="weights"):
        api.cluster_labels(np.array([[0], [4]]), [1.0, 2.0], 5)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback to threshold grouping: a compiler that fails, or none at
    all, raises."""
    monkeypatch.setenv("PEMP_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(api, "_LIB", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        api.cluster_labels(np.zeros((2, 1), np.int64), [1.0], 2)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        api.cluster_labels(np.zeros((2, 1), np.int64), [1.0], 2)
    assert not list(tmp_path.iterdir())
