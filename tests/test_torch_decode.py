"""decode_poses: the port against the JAX package on hand-built graphs.

Random MPN weights give sigmoids near 0.5 and no persons, so the edge and
node predictions here are built by hand, far from the 0.8 (edge) and 0.1
(node) thresholds, so that persons really form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pemp_tpu.decode.assembly import decode_poses as jax_decode
from pemp_tpu_torch.cluster.api import cluster_labels
from pemp_tpu_torch.decode.assembly import decode_poses


def _scene(rng, j=17, k=6, c=10, h=24, w=28, persons=3):
    n = j * k
    det = np.zeros((n, 3), np.int32)
    det[:, 2] = np.arange(n) // k
    det[:, 0] = rng.randint(0, w, n)
    det[:, 1] = rng.randint(0, h, n)
    person = np.full(n, -1)
    for p in range(persons):
        for jt in range(j):
            if rng.rand() < 0.85:            # some joints missing: refine fills them
                person[jt * k + p] = p
    node_valid = rng.rand(n) > 0.1
    node_valid[person >= 0] = True
    node_scores = np.where(person >= 0, rng.uniform(0.6, 0.99, n), rng.uniform(0.0, 0.05, n))
    src = rng.randint(0, n, (n, c))
    for i in np.flatnonzero(person >= 0):      # chain each person's joints
        mates = np.flatnonzero(person == person[i])
        src[i, 0] = mates[(np.searchsorted(mates, i) + 1) % len(mates)]
    dst = np.repeat(np.arange(n), c).reshape(n, c)
    ev = rng.rand(n, c) > 0.2
    ev[:, 0] = True
    same = (person[src] == person[dst]) & (person[src] >= 0)
    edge_pred = np.where(same, rng.uniform(0.85, 0.99, (n, c)), rng.uniform(0.0, 0.6, (n, c)))
    logits = rng.randn(n, j) + 8.0 * np.eye(j)[det[:, 2]]
    class_probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    sm = rng.rand(h, w, j).astype(np.float32)
    tags = rng.randn(h, w, j).astype(np.float32)
    return dict(
        scoremaps=sm, tagmaps=tags, joint_det=det,
        node_scores=node_scores.astype(np.float32),
        edge_index=np.stack([src.reshape(-1), dst.reshape(-1)]).astype(np.int32),
        edge_valid=ev.reshape(-1), edge_pred=edge_pred.reshape(-1).astype(np.float32),
        node_valid=node_valid, class_probs=class_probs.astype(np.float32),
    ), c


def test_decode_poses_matches_jax():
    rng = np.random.RandomState(0)
    scenes = [_scene(rng) for _ in range(2)]
    c = scenes[0][1]
    keys = ("scoremaps", "tagmaps", "joint_det", "node_scores", "edge_index",
            "edge_valid", "edge_pred", "node_valid")
    want = [
        jax_decode(*(jnp.asarray(s[key]) for key in keys), node_threshold=0.1,
                   num_joints=17, class_probs=jnp.asarray(s["class_probs"]),
                   blocked_c=c, channels_last=True)
        for s, _ in scenes
    ]
    batch = {key: torch.from_numpy(np.stack([s[key] for s, _ in scenes]))
             for key in (*keys, "class_probs")}
    persons, valid = decode_poses(
        *(batch[key] for key in keys), node_threshold=0.1, num_joints=17,
        blocked_c=c, class_probs=batch["class_probs"],
    )
    for i, (wp, wv) in enumerate(want):
        wp, wv = np.asarray(wp), np.asarray(wv)
        assert wv.sum() >= 2, "the hand-built scene must form persons"
        np.testing.assert_array_equal(valid[i].numpy(), wv)
        np.testing.assert_array_equal(persons[i, ..., :2].numpy(), wp[..., :2])
        np.testing.assert_allclose(persons[i, ..., 2].numpy(), wp[..., 2], atol=1e-6, rtol=0)
    # refine added joints (score 1e-3) somewhere, so that branch is exercised
    assert np.any(np.isclose(persons[..., 2].numpy(), 1e-3))


@pytest.mark.parametrize("fill,refine,adjust", [(True, True, True), (False, True, False),
                                                (True, False, True), (False, False, False)])
def test_decode_options_two_tag_channels_and_host_clusters(fill, refine, adjust):
    """The eval entry point's decode: the fill, refine and adjust switches,
    tags with two channels (original and flipped) and clusters from the
    host's GAEC, against the JAX package as tools/valid.py calls it (maps
    channels-first, clusters given)."""
    rng = np.random.RandomState(1)
    s, c = _scene(rng)
    s["tagmaps"] = rng.randn(*s["tagmaps"].shape, 2).astype(np.float32)
    keep = s["node_valid"] & (s["node_scores"] > 0.1)
    ei, ev = s["edge_index"], s["edge_valid"]
    sel = ev & keep[ei[0]] & keep[ei[1]]
    labels = cluster_labels(ei[:, sel], s["edge_pred"][sel] - 0.5, len(keep), "GAEC")
    flags = dict(with_fill_mean=fill, with_refine=refine, with_adjust=adjust)
    keys = ("joint_det", "node_scores", "edge_index", "edge_valid", "edge_pred", "node_valid")
    wp, wv = jax_decode(
        jnp.transpose(jnp.asarray(s["scoremaps"]), (2, 0, 1)),
        jnp.transpose(jnp.asarray(s["tagmaps"]), (2, 0, 1, 3)),
        *(jnp.asarray(s[key]) for key in keys), node_threshold=0.1, num_joints=17,
        class_probs=jnp.asarray(s["class_probs"]), cluster_labels=jnp.asarray(labels), **flags)
    t = lambda key: torch.from_numpy(np.asarray(s[key]))[None]  # noqa: E731
    persons, valid = decode_poses(
        t("scoremaps"), t("tagmaps"), *(t(key) for key in keys), node_threshold=0.1,
        num_joints=17, blocked_c=0, class_probs=t("class_probs"),
        cluster_labels=torch.from_numpy(labels)[None], **flags)
    wp, wv = np.asarray(wp), np.asarray(wv)
    assert wv.sum() >= 2
    np.testing.assert_array_equal(valid[0].numpy(), wv)
    np.testing.assert_array_equal(persons[0, ..., :2].numpy(), wp[..., :2])
    np.testing.assert_allclose(persons[0, ..., 2].numpy(), wp[..., 2], atol=1e-6, rtol=0)
