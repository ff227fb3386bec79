"""Training-time image and keypoint augmentation, host-side numpy (copy of
pemp_tpu.data.transforms; reference: src/Utils/transforms/transforms.py
and build.py).

Images stay HWC float32 in [0, 1] until ``Normalize``; the models take
NHWC batches, so there is no CHW permute. The random transforms draw from
the ``rng`` they are given (a ``np.random.RandomState``; the global
``np.random`` when None) in the JAX package's order: per sample the scale,
the rotation, the x and y translation, then the flip. The same seed thus
gives the same samples bit for bit.

``FLIP_CONFIG`` is the one table of which joint each joint becomes in a
mirrored image; the test-time flip reads it too.
"""

from __future__ import annotations

import numpy as np

from pemp_tpu_torch.geometry.affine import factor_affine, get_transform, kpt_affine
from pemp_tpu_torch.geometry.warp import warp_affine

FLIP_CONFIG = {
    "COCO": [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15],
    "COCO_WITHOUT_REARANGING": list(range(17)),
    "COCO_WITH_CENTER": [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15, 17],
    "CROWDPOSE": [1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 12, 13],
    "CROWDPOSE_WITH_CENTER": [1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 12, 13, 14],
}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, image, mask, joints, factors):
        for t in self.transforms:
            image, mask, joints, factors = t(image, mask, joints, factors)
        return image, mask, joints, factors


class ToFloat:
    """uint8 HWC -> float32 in [0, 1] (ToTensor without the permute)."""

    def __call__(self, image, mask, joints, factors):
        img = np.asarray(image, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        return img, mask, joints, factors


class Normalize:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, image, mask, joints, factors):
        return (image - self.mean) / self.std, mask, joints, factors


class RandomHorizontalFlip:
    """reference: transforms.py:81-102. ``mask`` and ``joints`` are per
    output scale; joint x becomes ``out_size - x - 1``."""

    def __init__(self, flip_index, output_size, prob=0.5, rng=None):
        self.flip_index = list(flip_index)
        self.prob = prob
        self.output_size = output_size if isinstance(output_size, list) else [output_size]
        self.rng = rng or np.random

    def __call__(self, image, mask, joints, factors):
        if self.rng.random() < self.prob:
            image = image[:, ::-1].copy()
            for i, out_size in enumerate(self.output_size):
                mask[i] = mask[i][:, ::-1].copy()
                if len(joints[i]):
                    joints[i] = joints[i][:, self.flip_index]
                    joints[i][:, :, 0] = out_size - joints[i][:, :, 0] - 1
            if len(factors):
                factors = factors[:, self.flip_index]
        return image, mask, joints, factors


class RandomAffineTransform:
    """Rotation, scale and translation. reference: transforms.py:398-506.

    Draws the scale, the rotation and (when ``max_translate`` > 0) the x
    and y shifts, in that order; warps the input to ``input_size`` and
    each scale's mask to its output size (thresholded at 0.5), maps the
    joints and scales the OKS factors by the last output's area change."""

    def __init__(self, input_size, output_size, max_rotation, min_scale, max_scale,
                 scale_type, max_translate, rng=None):
        self.input_size = input_size
        self.output_size = output_size if isinstance(output_size, list) else [output_size]
        self.max_rotation = max_rotation
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.scale_type = scale_type
        self.max_translate = max_translate
        self.rng = rng or np.random

    def __call__(self, image, mask, joints, factors):
        height, width = image.shape[:2]
        center = np.array((width / 2.0, height / 2.0))
        if self.scale_type == "long":
            scale = max(height, width) / 200.0
        elif self.scale_type == "short":
            scale = min(height, width) / 200.0
        else:
            raise ValueError(self.scale_type)
        aug_scale = self.rng.random() * (self.max_scale - self.min_scale) + self.min_scale
        scale *= aug_scale
        aug_rot = (self.rng.random() * 2 - 1) * self.max_rotation
        if self.max_translate > 0:
            shift = int(self.max_translate * scale)
            dx = self.rng.randint(-shift, shift + 1)
            dy = self.rng.randint(-shift, shift + 1)
            center = center + np.array([dx, dy])

        scale_v = np.array([scale, scale])
        for i, out_size in enumerate(self.output_size):
            mat = get_transform(center, scale_v, (out_size, out_size), aug_rot)[:2]
            m = warp_affine((mask[i] * 255).astype(np.float32), mat, (out_size, out_size)) / 255.0
            mask[i] = (m > 0.5).astype(np.float32)
            if len(joints[i]):
                joints[i][:, :, 0:2] = kpt_affine(joints[i][:, :, 0:2], mat)
        if len(factors):
            factors = factor_affine(
                factors, get_transform(center, scale_v, (self.output_size[-1],) * 2, 0))
        mat_input = get_transform(center, scale_v, (self.input_size, self.input_size), aug_rot)[:2]
        image = warp_affine(image, mat_input, (self.input_size, self.input_size))
        return image, mask, joints, factors


def transforms_hr_train(config, rng=None):
    """The training augmentation of a configuration. reference:
    build.py:16-49."""
    flip_index = (
        FLIP_CONFIG["COCO"] if config.DATASET.DATASET == "coco" else FLIP_CONFIG["CROWDPOSE"]
    )
    d = config.DATASET
    return Compose([
        ToFloat(),
        RandomAffineTransform(d.INPUT_SIZE, list(d.OUTPUT_SIZE), d.MAX_ROTATION, d.MIN_SCALE,
                              d.MAX_SCALE, d.SCALING_TYPE, d.MAX_TRANSLATE, rng=rng),
        RandomHorizontalFlip(flip_index, list(d.OUTPUT_SIZE), d.FLIP, rng=rng),
        Normalize(),
    ])
