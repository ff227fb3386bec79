"""The training data path, port against pemp_tpu.data, on a COCO-format set
written with PIL: the augmentation with the same RandomState, the COCO and
CrowdPose training samples (targets, crowd and keypoint-less masks), the
loader's batches, shuffle order and bounded prefetch, exactly; and the
greedy matcher against the JAX one, ties included."""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pemp_tpu.config import get_config as jax_get_config
from pemp_tpu.data import datasets as jdatasets
from pemp_tpu.data import targets as jtargets
from pemp_tpu.data import transforms as jtransforms
from pemp_tpu.ops.matching import greedy_assignment as jax_greedy
from pemp_tpu_torch.config import small_train, w32_512_train
from pemp_tpu_torch.data import datasets, targets, transforms
from pemp_tpu_torch.ops.matching import greedy_assignment


def _rle_counts(mask):
    """Uncompressed COCO RLE of a binary mask (column-major runs, zeros
    first)."""
    flat = mask.flatten(order="F").astype(np.uint8)
    counts, cur, run = [], 0, 0
    for v in flat:
        if v != cur:
            counts.append(run)
            cur, run = v, 0
        run += 1
    counts.append(run)
    return counts


def _person(rng, w, h, num_joints):
    cx, cy = rng.uniform(0.25 * w, 0.75 * w), rng.uniform(0.25 * h, 0.75 * h)
    kps, nk = [], 0
    for _ in range(num_joints):
        v = 2 if rng.rand() > 0.2 else 0
        kps += [float(cx + rng.uniform(-0.2, 0.2) * w), float(cy + rng.uniform(-0.3, 0.3) * h), v]
        nk += v > 0
    box = [cx - 0.2 * w, cy - 0.3 * h, 0.4 * w, 0.6 * h]
    return kps, int(nk), box


def write_coco_set(root, splits, sizes=((96, 128), (128, 96)), seed=0, num_joints=17,
                   layout="coco"):
    """A COCO-format keypoint set under ``root``: for each ``(mode,
    n_images)`` of ``splits``, PNG images alternating over ``sizes`` (h, w)
    with 2 persons each. The first image of each split also has a crowd
    annotation with an RLE mask, the second an annotation without
    keypoints but with a polygon. ``layout="crowdpose"`` writes
    json/crowdpose_<mode>.json and images/."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    img_dir = root / "images"
    aid, iid = 1, 1
    for mode, n in splits:
        if layout == "coco":
            img_dir = root / f"{mode}2017"
        img_dir.mkdir(parents=True, exist_ok=True)
        images, anns = [], []
        for k in range(n):
            h, w = sizes[k % len(sizes)]
            fname = f"{iid:012d}.png"
            Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(img_dir / fname)
            images.append({"id": iid, "width": w, "height": h, "file_name": fname})
            for _ in range(2):
                kps, nk, box = _person(rng, w, h, num_joints)
                x, y, bw, bh = box
                anns.append({"id": aid, "image_id": iid, "category_id": 1, "keypoints": kps,
                             "num_keypoints": nk, "area": float(bw * bh * 0.6), "bbox": box,
                             "iscrowd": 0,
                             "segmentation": [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]})
                aid += 1
            if k == 0:
                m = np.zeros((h, w), np.uint8)
                m[h // 4: h // 2, w // 3: w // 2] = 1
                anns.append({"id": aid, "image_id": iid, "category_id": 1,
                             "keypoints": [0.0] * (3 * num_joints), "num_keypoints": 0,
                             "area": float(m.sum()), "bbox": [w / 3, h / 4, w / 6, h / 4],
                             "iscrowd": 1, "segmentation": {"counts": _rle_counts(m),
                                                            "size": [h, w]}})
                aid += 1
            if k == 1:
                anns.append({"id": aid, "image_id": iid, "category_id": 1,
                             "keypoints": [0.0] * (3 * num_joints), "num_keypoints": 0,
                             "area": 300.0, "bbox": [5, 5, 20, 15], "iscrowd": 0,
                             "segmentation": [[5, 5, 25, 5, 25, 20, 5, 20]]})
                aid += 1
            iid += 1
        ds = {"images": images, "annotations": anns,
              "categories": [{"id": 1, "name": "person", "keypoints": ["x"] * num_joints}]}
        if layout == "coco":
            (root / "annotations").mkdir(exist_ok=True)
            path = root / "annotations" / f"person_keypoints_{mode}2017.json"
        else:
            (root / "json").mkdir(exist_ok=True)
            path = root / "json" / f"crowdpose_{mode}.json"
        path.write_text(json.dumps(ds))
    return str(root)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    base = tmp_path_factory.mktemp("train_sets")
    return {
        "coco": write_coco_set(base / "coco", [("train", 6)]),
        "crowdpose": write_coco_set(base / "crowdpose", [("trainval", 4)], num_joints=14,
                                    layout="crowdpose"),
    }


def _configs(dataset="coco"):
    """The port's small model_58_4 cut and the JAX tree with its values."""
    port = small_train()
    port.DATASET.DATASET = dataset
    if dataset == "crowd_pose":
        port.DATASET.NUM_JOINTS = 14
    jcfg = jax_get_config()
    jcfg.defrost()
    jcfg.merge_from_other(port.to_dict())
    jcfg.freeze()
    return port, jcfg


def _assert_same(got, want, where):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (where, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=where)


@pytest.mark.parametrize("preset", ["small", "model_58_4"])
def test_augmentation_matches_jax_bit_for_bit(preset):
    """transforms_hr_train with RandomState(seed) on both sides: the same
    draws in the same order (scale, rotation, dx, dy, flip), so images,
    masks, joints and factors are equal, over samples that flip and that
    do not."""
    port, jcfg = _configs()
    if preset == "model_58_4":
        full = w32_512_train()
        for key in ("INPUT_SIZE", "OUTPUT_SIZE", "MAX_SCALE"):
            port.DATASET[key] = full.DATASET[key]
        jcfg.defrost()
        jcfg.merge_from_other({"DATASET": {k: full.DATASET[k]
                                           for k in ("INPUT_SIZE", "OUTPUT_SIZE", "MAX_SCALE")}})
        jcfg.freeze()
    ours = transforms.transforms_hr_train(port, rng=np.random.RandomState(4))
    theirs = jtransforms.transforms_hr_train(jcfg, rng=np.random.RandomState(4))
    data = np.random.RandomState(0)
    n_scales = len(port.DATASET.OUTPUT_SIZE)
    for k in range(4):
        h, w = (120, 90) if k % 2 else (80, 140)
        img = (data.rand(h, w, 3) * 255).astype(np.uint8)
        mask = (data.rand(h, w) > 0.1).astype(np.float32)
        kp = np.concatenate([data.rand(3, 17, 2) * [w, h], data.randint(0, 3, (3, 17, 1))], -1)
        fac = data.rand(3, 17) * 50
        args = lambda: (img.copy(), [mask.copy() for _ in range(n_scales)],  # noqa: E731
                        [kp.copy() for _ in range(n_scales)], fac.copy())
        _assert_same(ours(*args()), theirs(*args()), f"sample {k}")


def _generators(port):
    """Both packages' target generators at the config's output sizes. The
    default sigma (size / 64) splats correctly from 64 up only (a
    fractional sigma's window overruns its kernel in both packages), so
    the small sizes take sigma 1."""
    nj, mp = port.DATASET.NUM_JOINTS, port.DATASET.MAX_NUM_PEOPLE
    outs = list(port.DATASET.OUTPUT_SIZE)
    return (([targets.HeatmapGenerator(s, nj, sigma=1) for s in outs],
             [targets.JointsGenerator(mp, nj, s, True) for s in outs]),
            ([jtargets.HeatmapGenerator(s, nj, sigma=1) for s in outs],
             [jtargets.JointsGenerator(mp, nj, s, True) for s in outs]))


@pytest.mark.parametrize("dataset", ["coco", "crowd_pose"])
def test_training_samples_match_jax(sets, tmp_path, dataset):
    """Every training sample of the set (image, heatmaps, masks with the
    crowd RLE and the keypoint-less polygon cut out on COCO, keypoints,
    factors, AE targets) equal to pemp_tpu's, dtypes included."""
    port, jcfg = _configs(dataset)
    (hm, jg), (jhm, jjg) = _generators(port)
    tf = transforms.transforms_hr_train(port, rng=np.random.RandomState(2))
    jtf = jtransforms.transforms_hr_train(jcfg, rng=np.random.RandomState(2))
    if dataset == "coco":
        ours = datasets.CocoKeypoints(sets["coco"], mode="train", transforms=tf,
                                      heatmap_generator=hm, joint_generator=jg)
        theirs = jdatasets.CocoKeypoints(sets["coco"], mode="train", transforms=jtf,
                                         heatmap_generator=jhm, joint_generator=jjg,
                                         cache_dir=str(tmp_path))
    else:
        ours = datasets.CrowdPoseKeypoints(sets["crowdpose"], mode="trainval", transforms=tf,
                                           heatmap_generator=hm, joint_generator=jg)
        theirs = jdatasets.CrowdPoseKeypoints(sets["crowdpose"], mode="trainval",
                                              transforms=jtf, heatmap_generator=jhm,
                                              joint_generator=jjg)
    assert list(ours.img_ids) == list(theirs.img_ids) and len(ours) >= 4
    masked = 0
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        _assert_same(got, want, f"{dataset} sample {i}")
        masked += int((got[2][-1] == 0).sum())
    if dataset == "coco":
        assert masked > 0          # the crowd and keypoint-less regions are cut out


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((2, 2, 3), i, np.float32),)


def _stack(samples):
    return np.stack([s[0] for s in samples])


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_and_shuffle_order(sets, tmp_path, workers):
    """DataLoader over the COCO set: the same collated batches as the JAX
    loader (shuffled with one seed, no workers, so the augmentation draws
    in sample order); and the shuffle order of a seed over epochs, with or
    without workers, batches in order and the last short one dropped."""
    port, jcfg = _configs()
    (hm, jg), (jhm, jjg) = _generators(port)
    if workers == 0:
        ours = datasets.DataLoader(datasets.CocoKeypoints(
            sets["coco"], mode="train", heatmap_generator=hm, joint_generator=jg,
            transforms=transforms.transforms_hr_train(port, rng=np.random.RandomState(1))),
            batch_size=2, shuffle=True, seed=5)
        theirs = jdatasets.DataLoader(jdatasets.CocoKeypoints(
            sets["coco"], mode="train", heatmap_generator=jhm, joint_generator=jjg,
            cache_dir=str(tmp_path),
            transforms=jtransforms.transforms_hr_train(jcfg, rng=np.random.RandomState(1))),
            batch_size=2, shuffle=True, seed=5)
        got, want = list(ours), list(theirs)
        assert len(got) == len(ours) == 3
        _assert_same(got, want, "batches")
        assert got[0]["heatmaps"][1].shape == (2, 32, 32, 17)
    ours = datasets.DataLoader(_Indexed(11), 3, shuffle=True, num_workers=workers, seed=7,
                               collate=_stack)
    theirs = jdatasets.DataLoader(_Indexed(11), 3, shuffle=True, num_workers=workers, seed=7,
                                  collate=_stack)
    for _ in range(2):      # the permutation is drawn anew each epoch
        got, want = list(ours), list(theirs)
        assert len(got) == 3
        _assert_same(got, want, "indexed batches")


def test_loader_prefetch_is_bounded():
    """With a stalled consumer, at most 2 * num_workers batches are loaded
    ahead (plus the one refill), and the epoch still comes whole and in
    order (after tests/test_data_pipeline.py)."""
    loads = []
    lock = threading.Lock()

    class Slow:
        def __len__(self):
            return 64

        def __getitem__(self, i):
            with lock:
                loads.append(i)
            time.sleep(0.002)
            return (np.full((2, 2, 3), i, np.float32),)

    loader = datasets.DataLoader(Slow(), batch_size=4, num_workers=2, collate=_stack)
    it = iter(loader)
    first = next(it)
    time.sleep(0.2)
    assert len(loads) <= 5 * 4, f"prefetch ran ahead: {len(loads)} items loaded"
    rest = list(it)
    assert len(rest) == 15 and sorted(loads) == list(range(64))
    np.testing.assert_array_equal(np.concatenate([first, *rest])[:, 0, 0, 0], np.arange(64))


@pytest.mark.parametrize("kind", ["random", "ties", "sparse"])
def test_greedy_matches_jax(kind):
    """greedy_assignment over a batch of problems against the JAX loop
    under vmap: ties (four similarity levels) go to the first pair in
    row-major order on both sides."""
    rng = np.random.RandomState(3)
    sims = rng.rand(5, 34, 40).astype(np.float32)
    if kind == "ties":
        sims = np.round(sims * 4) / 4
    sims[rng.rand(*sims.shape) < (0.9 if kind == "sparse" else 0.4)] = 0.0
    want = np.asarray(jax.jit(jax.vmap(jax_greedy))(jnp.asarray(sims)))
    got = greedy_assignment(torch.from_numpy(sims)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > 10
