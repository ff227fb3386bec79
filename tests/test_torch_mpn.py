"""The flagship MPN on its fused-step path: the port against the JAX
package (Pallas kernel in interpret mode), same weights, 3 steps."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pemp_tpu.config import get_config
from pemp_tpu.models.mpn.models import NodeClassificationMPN as JaxMPN
from pemp_tpu.models.mpn.models import mpn_cfg_from_config
from pemp_tpu.ops.knn import knn_edges_target_major
from pemp_tpu_torch.config.defaults import W48_640
from pemp_tpu_torch.models.mpn.models import NodeClassificationMPN
from pemp_tpu_torch.weights import mpn_from_jax_variables


def test_mpn_fused_path_matches_jax():
    cfg = get_config()
    cfg.merge_from_other({"MODEL": {"MPN": W48_640["MODEL"]["MPN"]}})
    rng = np.random.RandomState(0)
    imgs, j, kpt, k = 2, 17, 8, 8
    n_img = j * kpt
    n = imgs * n_img
    c = 2 * k
    ei_list, ev_list = [], []
    for b in range(imgs):
        pos = jnp.asarray(rng.randint(0, 40, (n_img, 2)), jnp.float32)
        valid = jnp.asarray(rng.rand(n_img) > 0.3)
        ei, ev = knn_edges_target_major(pos, valid, k, k)
        ei_list.append(ei + b * n_img)
        ev_list.append(ev)
    ei = jnp.concatenate(ei_list, axis=1)
    ev = jnp.concatenate(ev_list)
    src_local = ei[0] % n_img
    x = jnp.asarray(rng.randn(n, 128), jnp.float32)
    ea = jnp.asarray(rng.randn(n * c, 19), jnp.float32)
    types = jnp.asarray((np.arange(n) // kpt) % j, jnp.int32)

    mpn_cfg = mpn_cfg_from_config(cfg.MODEL.MPN)
    mpn_cfg.update(STEPS=3, _BLOCKED_C=c, _NODES_PER_TYPE=kpt)
    jax_mpn = JaxMPN({**mpn_cfg, "_USE_PALLAS": True, "_PALLAS_INTERPRET": True,
                      "_FUSED_STEP": True, "_COLLECT_AUX": False})
    args = (x, ea, ei, types, jnp.ones(n, bool), ev)
    variables = jax_mpn.init(jax.random.PRNGKey(0), *args, edge_src_local=src_local)
    want = jax_mpn.apply(variables, *args, edge_src_local=src_local)

    port = NodeClassificationMPN(mpn_cfg)
    port.load_state_dict(mpn_from_jax_variables(
        variables["params"], variables["batch_stats"], mpn_cfg))
    port.eval()
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    with torch.no_grad():
        got = port(t(x), t(ea), t(ei), t(ev), t(src_local), torch.float32)
    # tolerance of the JAX package's own fused-vs-plain MPN test
    # (tests/test_fused_step.py): 3 steps of f32 matmuls in another order
    valid = np.asarray(ev)
    np.testing.assert_allclose(got["edge"][-1].numpy()[valid],
                               np.asarray(want["edge"][-1])[valid], atol=2e-3, rtol=2e-3)
    for key in ("node", "class"):
        np.testing.assert_allclose(got[key][-1].numpy(), np.asarray(want[key][-1]),
                                   atol=2e-3, rtol=2e-3, err_msg=key)
