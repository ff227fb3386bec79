"""The COCO, CrowdPose, OCHuman and COCO test-dev keypoint sets and the
training loader (counterpart of pemp_tpu.data.datasets).

The eval entry point reads ``img_ids``, ``coco``, ``sigmas`` and
``load_raw``; the trainer indexes a set for its sample tuple (image,
per-scale heatmaps, per-scale masks, keypoints, OKS factors, per-scale AE
joint targets) and batches it with :class:`DataLoader`. A subclass may
override ``load_raw`` to serve images from elsewhere than files.

reference: src/data/CocoKeypoints_hr.py, CrowdPoseKeypoints.py,
OCHumans.py, CocoKeypoints_test.py.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pemp_tpu_torch.data.coco_api import COCO
from pemp_tpu_torch.data.rle import segmentation_to_mask
from pemp_tpu_torch.data.targets import filter_visible, pack_for_batch

KPT_OKS_SIGMAS = (
    np.array(
        [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87, .89, .89]
    )
    / 10.0
)
CROWDPOSE_SIGMAS = (
    np.array([.79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87, .89, .89, .79, .79]) / 10.0
)
MAX_PEOPLE = 30     # the sample's padded person axis (reference: pack_for_batch)


def _load_image(path):
    from PIL import Image

    with open(path, "rb") as f:
        return np.array(Image.open(f).convert("RGB"))


def _has_keypoints(coco, img_id) -> bool:
    return any(np.count_nonzero(np.array(a["keypoints"])[2::3]) > 1
               for a in coco.loadAnns(coco.getAnnIds(imgIds=img_id)))


class CocoKeypoints:
    """reference: src/data/CocoKeypoints_hr.py:13-163. ``filter_empty``
    keeps the images with a person of two or more labelled joints; ``mini``
    draws 500 of val2017 (4000 otherwise) with ``seed``. Indexing gives a
    training sample and needs ``transforms`` (data.transforms), a
    ``heatmap_generator`` and a ``joint_generator`` per output scale
    (data.targets); ``mask_crowds`` masks crowd regions and annotations
    without keypoints."""

    data_dir = "images"
    mask_crowds = False
    transforms = None
    heatmap_generator = None
    joint_generator = None

    def __init__(self, path, mini=False, mode="val", seed=0, filter_empty=True,
                 img_ids=None, year=17, num_joints=17, transforms=None,
                 heatmap_generator=None, mask_crowds=True, joint_generator=None):
        rng = np.random.RandomState(seed)
        self.root_path = path
        self.coco = COCO(f"{path}/annotations/person_keypoints_{mode}20{year}.json")
        self.num_joints = num_joints
        self.transforms = transforms
        self.heatmap_generator = heatmap_generator
        self.joint_generator = joint_generator
        self.mask_crowds = mask_crowds
        self.data_dir = f"{mode}20{year}"
        self.img_ids = img_ids if img_ids is not None else list(self.coco.imgs.keys())
        if filter_empty and img_ids is None:
            self.img_ids = [i for i in self.img_ids if _has_keypoints(self.coco, i)]
        if mini and img_ids is None:
            n = 500 if (year == 17 and mode == "val") else 4000
            self.img_ids = rng.choice(self.img_ids, min(n, len(self.img_ids)), replace=False)

    def __len__(self):
        return len(self.img_ids)

    def sigmas(self):
        return KPT_OKS_SIGMAS[: self.num_joints]

    def load_raw(self, idx):
        """(image id, its annotations, its image record, the RGB image
        (H, W, 3) uint8)."""
        img_id = int(self.img_ids[idx])
        anns = self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id))
        info = self.coco.loadImgs(img_id)[0]
        img = _load_image(f"{self.root_path}/{self.data_dir}/{info['file_name']}")
        return img_id, anns, info, img

    def __getitem__(self, idx):
        """(image (S, S, 3) float32, heatmaps [per scale (J, s, s)], masks
        [per scale (s, s)], keypoints (30, J, 3) in the last scale's
        coordinates, factors (30, J), AE targets [per scale (30, J, 2)]).
        reference: CocoKeypoints_hr.py:84-163."""
        if self.transforms is None or self.heatmap_generator is None:
            raise ValueError("a training sample needs transforms and target generators")
        _, anns, info, img = self.load_raw(idx)
        h, w = info["height"], info["width"]

        sig = self.sigmas()
        people = [a for a in anns if a.get("num_keypoints", 0) > 0]
        keypoints = np.array(
            [np.array(a["keypoints"], np.float64).reshape(-1, 3)[: self.num_joints]
             for a in people], np.float64)
        factors = np.array([(sig * 2) ** 2 * (a.get("area", 1.0) + np.spacing(1)) * 2.0
                            for a in people], np.float64)
        scales = np.array([(a.get("area", 1.0) + np.spacing(1)) * 2.0 for a in people],
                          np.float64)

        mask = np.zeros((h, w))
        if self.mask_crowds:
            for a in anns:
                if a.get("iscrowd") or (a.get("num_keypoints", 0) == 0 and "segmentation" in a):
                    mask += segmentation_to_mask(a["segmentation"], h, w)
        mask = (mask < 0.5).astype(np.float32)

        n_scales = len(self.heatmap_generator)
        masks = [mask.copy() for _ in range(n_scales)]
        joints = [keypoints.copy() for _ in range(n_scales)]
        img, masks, joints, factors = self.transforms(img, masks, joints, factors)

        heatmaps, ae_targets = [], []
        for s in range(n_scales):
            heatmaps.append(self.heatmap_generator[s](joints[s], scales).astype(np.float32))
            ae_targets.append(self.joint_generator[s](joints[s]).astype(np.int32))
            joints[s] = filter_visible(joints[s], masks[s].shape)
            masks[s] = masks[s].astype(np.float32)

        kpts = joints[-1]
        if len(kpts):
            keep = kpts[:, :, 2].sum(axis=1) != 0.0
            kpts = pack_for_batch(kpts[keep].astype(np.float32), MAX_PEOPLE)
            factors = pack_for_batch(np.asarray(factors)[keep], MAX_PEOPLE)
        else:
            kpts = np.zeros((MAX_PEOPLE, self.num_joints, 3), np.float32)
            factors = np.zeros((MAX_PEOPLE, self.num_joints), np.float64)
        return img, heatmaps, masks, kpts, factors.astype(np.float32), ae_targets


class CrowdPoseKeypoints(CocoKeypoints):
    """reference: src/data/CrowdPoseKeypoints.py:12-120 (14 joints, no
    crowd masking)."""

    def __init__(self, path, mini=False, mode="test", seed=0, filter_empty=True,
                 img_ids=None, transforms=None, heatmap_generator=None,
                 joint_generator=None):
        rng = np.random.RandomState(seed)
        self.root_path = path
        self.coco = COCO(f"{path}/json/crowdpose_{mode}.json")
        self.num_joints = 14
        self.transforms = transforms
        self.heatmap_generator = heatmap_generator
        self.joint_generator = joint_generator
        self.img_ids = img_ids if img_ids is not None else list(self.coco.imgs.keys())
        if filter_empty and img_ids is None:
            self.img_ids = [i for i in self.img_ids if _has_keypoints(self.coco, i)]
        if mini and img_ids is None:
            self.img_ids = rng.choice(self.img_ids, min(4000, len(self.img_ids)), replace=False)

    def sigmas(self):
        return CROWDPOSE_SIGMAS


class OCHumans(CocoKeypoints):
    """Eval-only COCO-format set. reference: src/data/OCHumans.py."""

    def __init__(self, path, mode="val"):
        self.root_path = path
        self.coco = COCO(f"{path}/ochuman_coco_format_{mode}_range_0.00_1.00.json")
        self.num_joints = 17
        self.img_ids = list(self.coco.imgs.keys())


class CocoKeypointsTest(CocoKeypoints):
    """Images only, for test-dev. reference: src/data/CocoKeypoints_test.py."""

    def __init__(self, path, year=17):
        self.root_path = path
        self.coco = COCO(f"{path}/annotations/image_info_test-dev20{year}.json")
        self.num_joints = 17
        self.data_dir = f"test20{year}"
        self.img_ids = list(self.coco.imgs.keys())


class DataLoader:
    """Batches of a set, optionally shuffled, loaded by ``num_workers``
    threads with a bounded prefetch (copy of pemp_tpu.data.DataLoader).

    The order is a permutation drawn from ``RandomState(seed)`` once per
    epoch; with workers, at most ``2 * num_workers`` batches are in flight
    and they are yielded in order. Samples that draw from a shared
    ``RandomState`` (the augmentation) draw in thread order, as in the JAX
    package; with ``num_workers=0`` the draws are in sample order.

    ``shard=(r, W)``: the loader of rank r of W under data parallelism;
    ``batch_size`` is the global batch, whose rows ``[r B / W, (r + 1) B /
    W)`` it loads, and ``len`` counts global batches. Every rank draws the
    same permutation."""

    def __init__(self, dataset, batch_size=1, shuffle=False, num_workers=0,
                 drop_last=True, seed=0, collate=None, shard=(0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.collate = collate or default_collate
        rank, world = shard
        if batch_size % world:
            raise ValueError(f"batch size {batch_size} is not divisible by the {world} ranks")
        rows = batch_size // world
        self.rows = slice(rank * rows, (rank + 1) * rows)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [order[i: i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        batches = [b[self.rows] for b in batches]
        if self.num_workers <= 0:
            for b in batches:
                yield self._load_batch(b)
            return

        # bounded prefetch, so loaded but unconsumed batches cannot pile up
        window = 2 * self.num_workers
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = deque()
            it = iter(batches)
            for b in it:
                pending.append(pool.submit(self._load_batch, b))
                if len(pending) >= window:
                    break
            while pending:
                f = pending.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(self._load_batch, nxt))
                yield f.result()

    def _load_batch(self, idxs):
        return self.collate([self.dataset[int(i)] for i in idxs])


def default_collate(samples):
    """Stacks sample tuples into the train step's batch dict: imgs (B, S,
    S, 3), heatmaps [per scale (B, s, s, J)], masks [per scale (B, s, s)],
    keypoints (B, 30, J, 3), factors (B, 30, J), ae_targets [per scale (B,
    30, J, 2)]."""
    n_scales = len(samples[0][1])
    return {
        "imgs": np.stack([s[0] for s in samples]).astype(np.float32),
        "heatmaps": [np.stack([s[1][i] for s in samples]).transpose(0, 2, 3, 1)
                     for i in range(n_scales)],
        "masks": [np.stack([s[2][i] for s in samples]) for i in range(n_scales)],
        "keypoints": np.stack([s[3] for s in samples]),
        "factors": np.stack([s[4] for s in samples]).astype(np.float32),
        "ae_targets": [np.stack([s[5][i] for s in samples]) for i in range(n_scales)],
    }
