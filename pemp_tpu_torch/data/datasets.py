"""The COCO, CrowdPose, OCHuman and COCO test-dev keypoint sets, as the
eval entry point reads them (counterpart of pemp_tpu.data.datasets:
``img_ids``, ``coco``, ``sigmas`` and ``load_raw``).

reference: src/data/CocoKeypoints_hr.py, CrowdPoseKeypoints.py,
OCHumans.py, CocoKeypoints_test.py. The training samples (``__getitem__``
with its targets) and the loader are not ported.
"""

from __future__ import annotations

import numpy as np

from pemp_tpu_torch.data.coco_api import COCO

KPT_OKS_SIGMAS = (
    np.array(
        [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87, .89, .89]
    )
    / 10.0
)
CROWDPOSE_SIGMAS = (
    np.array([.79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87, .89, .89, .79, .79]) / 10.0
)

# test-time flip: the joint each joint becomes in the mirrored image
# (pemp_tpu/data/transforms.py)
FLIP_CONFIG = {
    "COCO": [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15],
    "COCO_WITHOUT_REARANGING": list(range(17)),
    "CROWDPOSE": [1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 12, 13],
}


def _load_image(path):
    from PIL import Image

    with open(path, "rb") as f:
        return np.array(Image.open(f).convert("RGB"))


def _has_keypoints(coco, img_id) -> bool:
    return any(np.count_nonzero(np.array(a["keypoints"])[2::3]) > 1
               for a in coco.loadAnns(coco.getAnnIds(imgIds=img_id)))


class CocoKeypoints:
    """reference: src/data/CocoKeypoints_hr.py:13-82. ``filter_empty``
    keeps the images with a person of two or more labelled joints; ``mini``
    draws 500 of val2017 (4000 otherwise) with ``seed``."""

    data_dir = "images"

    def __init__(self, path, mini=False, mode="val", seed=0, filter_empty=True,
                 img_ids=None, year=17, num_joints=17):
        rng = np.random.RandomState(seed)
        self.root_path = path
        self.coco = COCO(f"{path}/annotations/person_keypoints_{mode}20{year}.json")
        self.num_joints = num_joints
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


class CrowdPoseKeypoints(CocoKeypoints):
    """reference: src/data/CrowdPoseKeypoints.py:12-120 (14 joints)."""

    def __init__(self, path, mini=False, mode="test", seed=0, filter_empty=True,
                 img_ids=None):
        rng = np.random.RandomState(seed)
        self.root_path = path
        self.coco = COCO(f"{path}/json/crowdpose_{mode}.json")
        self.num_joints = 14
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
