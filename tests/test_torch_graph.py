"""Detection, target-major kNN and eval graph construction: the port
against the JAX package, exactly, on tie-heavy inputs.

Ties are the hazard: scoremaps computed in bf16 repeat peak values, and
detections sit on integer pixels, so equal kNN distances are common. Both
sides must break them the same way (lower index first, IEEE total order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pemp_tpu.graph.constructor import GCConfig as JaxGCConfig
from pemp_tpu.graph.constructor import construct_graph_batch as jax_construct
from pemp_tpu.ops.detection import joint_det_from_scoremaps as jax_detect
from pemp_tpu.ops.knn import knn_edges_target_major as jax_knn
from pemp_tpu_torch.graph.constructor import GCConfig, construct_graph_batch
from pemp_tpu_torch.ops.detection import joint_det_from_scoremaps
from pemp_tpu_torch.ops.knn import knn_edges_target_major


def _tie_scoremaps(rng, shape):
    """Few distinct values, signed zeros and plateaus: many equal peaks."""
    levels = np.array([-0.5, -0.0, 0.0, 0.05, 0.1, 0.5, 1.0], np.float32)
    sm = levels[rng.randint(0, len(levels), shape)]
    sm[..., :3, :3] = 0.5       # a plateau: every pixel of it is an NMS peak
    return sm


@pytest.mark.parametrize("hw,k,threshold", [
    ((12, 16), 6, 0.1),
    ((12, 16), 120, 0.1),       # K beyond the number of peaks: zero-score ties
    ((64, 64), 8, None),        # H*W = 4096: the JAX side's blocked top-k path
])
def test_detection_exact(hw, k, threshold):
    rng = np.random.RandomState(0)
    sm = _tie_scoremaps(rng, (2, 3, *hw))
    mask = (rng.rand(2, *hw) > 0.1).astype(np.float32)
    want = jax_detect(jnp.asarray(sm), k, threshold, 3, mask=jnp.asarray(mask))
    got = joint_det_from_scoremaps(torch.from_numpy(sm), k, threshold, 3,
                                   mask=torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,k,cap", [(40, 8, 5), (40, 8, 8), (12, 50, 30)])
def test_knn_target_major_exact(n, k, cap):
    rng = np.random.RandomState(1)
    for trial in range(3):
        pos = rng.randint(0, 6, (n, 2)).astype(np.float32)   # 6x6 grid: many ties
        valid = rng.rand(n) > 0.25
        ei_w, ev_w = jax_knn(jnp.asarray(pos), jnp.asarray(valid), k, cap, symmetric=False)
        ei_g, ev_g = knn_edges_target_major(torch.from_numpy(pos), torch.from_numpy(valid), k, cap)
        np.testing.assert_array_equal(ei_g.numpy(), np.asarray(ei_w), err_msg=str(trial))
        np.testing.assert_array_equal(ev_g.numpy(), np.asarray(ev_w), err_msg=str(trial))


def test_construct_graph_batch_eval():
    rng = np.random.RandomState(2)
    b, h, w, j, f, kpt = 2, 16, 20, 17, 12, 4
    sm = _tie_scoremaps(rng, (b, h, w, j))
    feats = rng.randn(b, h, w, f).astype(np.float32)
    tags = rng.randn(b, h, w, j).astype(np.float32)
    kw = dict(num_joints=j, nodes_per_type=kpt, knn_k=10, knn_cap_in=6,
              norm_node_distance=True)
    want = jax_construct(JaxGCConfig(**kw, knn_symmetric=False), jnp.asarray(sm),
                         jnp.asarray(feats), jnp.asarray(tags), testing=True)
    got = construct_graph_batch(GCConfig(**kw), torch.from_numpy(sm),
                                torch.from_numpy(feats), torch.from_numpy(tags))
    for name in ("edge_index", "edge_valid", "joint_det", "edge_src_local",
                 "node_valid", "joint_scores", "batch_index"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    # gathers and one subtraction/division per element: 1e-5 is generous
    for name in ("x", "edge_attr", "joint_tags"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert bool(np.asarray(want.edge_valid).any())
