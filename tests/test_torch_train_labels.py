"""Training labels: the auction matcher and the labels and masks of edge
label methods 3-6 (with and without the neighbour pass, on the auction and
on the greedy matcher), port against the JAX package, exactly.

Ties are the hazard: ``lax.top_k`` takes the lower index among equal
values, and the scaled phases of the auction only start on contended
near-ties. The matcher is also held to ``hungarian_numpy``'s objective.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pemp_tpu.graph.constructor import GCConfig as JaxGCConfig
from pemp_tpu.graph.constructor import construct_graph_batch as jax_construct
from pemp_tpu.ops.matching import auction_assignment as jax_auction
from pemp_tpu.ops.matching import hungarian_numpy
from pemp_tpu_torch.data.synthetic import make_batch
from pemp_tpu_torch.graph.constructor import GCConfig, construct_graph_batch
from pemp_tpu_torch.ops.matching import auction_assignment


def _problems(kind, rng, count=6, r=30, c=40):
    sims = []
    for _ in range(count):
        s = rng.rand(r, c).astype(np.float32)
        if kind == "ties":
            s = np.round(s * 4) / 4          # four levels: ties everywhere
        s[rng.rand(r, c) < 0.5] = 0.0
        if kind == "contended":
            # many rows bid on few columns with sims within 1e-3: the quick
            # phase's budget runs out and the scaled phases take over
            s = np.zeros((r, c), np.float32)
            s[:, :5] = 0.9 + rng.rand(r, 5).astype(np.float32) * 1e-3
        sims.append(s)
    return np.stack(sims)


@pytest.fixture(scope="module")
def jax_auction_batched():
    return jax.jit(jax.vmap(jax_auction))


@pytest.mark.parametrize("kind", ["random", "ties", "contended"])
def test_auction_matches_jax_exactly(kind, jax_auction_batched):
    sims = _problems(kind, np.random.RandomState(0))
    want = np.asarray(jax_auction_batched(jnp.asarray(sims)))
    got = auction_assignment(torch.from_numpy(sims)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["random", "ties", "contended"])
def test_auction_reaches_the_hungarian_objective(kind):
    sims = _problems(kind, np.random.RandomState(1))
    got = auction_assignment(torch.from_numpy(sims)).numpy()
    for s, col in zip(sims, got):
        obj = lambda cols: sum(float(s[i, j]) for i, j in enumerate(cols) if j >= 0)  # noqa: E731
        assert all(s[i, j] > 0 for i, j in enumerate(col) if j >= 0)
        assert len({j for j in col if j >= 0}) == int((col >= 0).sum())   # one row per column
        # eps-optimal: within n_matched * eps (1e-5) of the exact optimum
        assert obj(col) >= obj(hungarian_numpy(s)) - 1e-5 * len(col)


LABEL_FIELDS = ("edge_labels", "node_labels", "node_classes", "node_persons", "label_mask",
                "label_mask_node", "class_mask", "edge_index", "edge_valid", "node_valid")


def _label_configs(**labels):
    kw = dict(num_joints=17, nodes_per_type=8, knn_k=50, knn_cap_in=30,
              norm_node_distance=True, matching_radius=0.5, **labels)
    jcfg = JaxGCConfig(**kw, knn_symmetric=False)

    def build(sm, feats, tags, masks, joints, factors):
        return jax_construct(jcfg, sm, feats, tags, joints_gt=joints, factors=factors,
                             masks=masks, testing=False)

    return GCConfig(**kw), jax.jit(build)


@pytest.fixture(scope="module")
def jax_labels():
    return _label_configs(edge_label_method=6)


def _labels_exact(cfg, jax_build, seed):
    """Synthetic scenes with scoremaps peaked at the GT (plus noise, so
    detections and near misses mix) and crowd masks; every label and mask
    of the batch graph equal. Returns the JAX graph."""
    rng = np.random.RandomState(seed)
    batch = make_batch(rng, 2, 64, (16, 32), 17, 30, scale_range=(0.4, 0.9))
    b, h, w, j = 2, 32, 32, 17
    sm = batch["heatmaps"][-1] + rng.rand(b, h, w, j).astype(np.float32) * 0.05
    feats = rng.randn(b, h, w, 8).astype(np.float32)
    tags = rng.randn(b, h, w, j).astype(np.float32)
    masks = (rng.rand(b, h, w) > 0.05).astype(np.float32)
    arrays = (sm, feats, tags, masks, batch["keypoints"], batch["factors"])
    want = jax_build(*map(jnp.asarray, arrays))
    t = [torch.from_numpy(x) for x in arrays]
    got = construct_graph_batch(cfg, *t[:4], joints_gt=t[4], factors=t[5])
    for name in LABEL_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert np.asarray(want.node_labels).sum() > 10 and np.asarray(want.edge_labels).sum() > 50
    return want


@pytest.mark.parametrize("seed", [0, 1])
def test_method6_labels_and_masks_exact(seed, jax_labels):
    _labels_exact(*jax_labels, seed)


LABEL_CASES = [(m, nb, mt) for m in (3, 4, 5) for nb in (False, True)
               for mt in ("auction", "greedy")] + [
    (6, True, "auction"), (6, False, "greedy"), (6, True, "greedy")]


@pytest.mark.parametrize("method,neighbours,matcher", LABEL_CASES)
def test_label_methods_exact(method, neighbours, matcher):
    """Methods 3, 4 and 5 with and without the neighbour pass, and method 6
    with it or on the greedy matcher (method 6 without it on the auction
    is test_method6_labels_and_masks_exact). The neighbour pass must add
    detections to persons."""
    cfg, jax_build = _label_configs(edge_label_method=method, use_neighbours=neighbours,
                                    matcher=matcher, inclusion_radius=0.6,
                                    node_inclusion_radius=0.6)
    want = _labels_exact(cfg, jax_build, 2)
    if neighbours:
        plain = _labels_exact(*_label_configs(edge_label_method=method, matcher=matcher), 2)
        assert np.asarray(want.node_labels).sum() > np.asarray(plain.node_labels).sum()
        if method == 6:     # detections several GT joints claim leave the node loss
            assert (np.asarray(want.label_mask_node) == 0).sum() > 0
