"""Writes a small fake COCO-format keypoint set (JPEG images and
annotations) for smoke tests and CLI drives without real data.

    python -m pemp_tpu_torch.make_fake_coco [--root tmp/fake_coco] [--images 8] \
        [--mode val] [--size 256] [--people N] [--flavor coco|testdev|ochuman]

The counterpart of ``tools/make_fake_coco.py``: the same scenes from
``RandomState(0)`` (``data.synthetic``), the same JSON byte for byte and
the same JPEGs. ``coco`` writes ``annotations/person_keypoints_<mode>2017.json``
and ``<mode>2017/``; ``testdev`` the image-info file and ``test2017/``;
``ochuman`` OCHuman's JSON and ``images/``. Needs PIL for the JPEGs;
nothing runs on a device.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from pemp_tpu_torch.data.synthetic import random_scene, render_image

IMAGE_DIRS = {"coco": "{mode}2017", "testdev": "test2017", "ochuman": "images"}


def _annotation(aid, image_id, kp, area):
    xs, ys = kp[kp[:, 2] > 0, 0], kp[kp[:, 2] > 0, 1]
    flat = []
    for x, y, v in kp:
        flat += [float(x), float(y), int(v)]
    return {
        "id": aid, "image_id": image_id, "category_id": 1, "keypoints": flat,
        "num_keypoints": int((kp[:, 2] > 0).sum()), "area": float(area),
        "bbox": [float(xs.min()), float(ys.min()),
                 float(xs.max() - xs.min()), float(ys.max() - ys.min())],
        "iscrowd": 0,
        "segmentation": [[float(xs.min()), float(ys.min()), float(xs.max()), float(ys.min()),
                          float(xs.max()), float(ys.max()), float(xs.min()), float(ys.max())]],
    }


def make_fake_coco(root, images=8, mode="val", size=256, people=None, flavor="coco") -> str:
    """Writes the set under ``root``; returns the annotation file's path.
    ``people`` fixes the persons an image (random 1-4 when None)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("make_fake_coco writes JPEGs with PIL, which is not installed") from e

    img_dir = IMAGE_DIRS[flavor].format(mode=mode)
    os.makedirs(f"{root}/annotations", exist_ok=True)
    os.makedirs(f"{root}/{img_dir}", exist_ok=True)
    rng = np.random.RandomState(0)
    records, annotations = [], []
    for i in range(1, images + 1):
        kps, areas = random_scene(rng, input_size=size, n_people=people)
        img = render_image(kps, size, rng)
        fname = f"{i:012d}.jpg"
        Image.fromarray((img * 255).astype(np.uint8)).save(f"{root}/{img_dir}/{fname}")
        records.append({"id": i, "width": size, "height": size, "file_name": fname})
        for kp, area in zip(kps, areas):
            annotations.append(_annotation(len(annotations) + 1, i, kp, area))
    categories = [{"id": 1, "name": "person"}]
    if flavor == "testdev":
        # the submission path: image records only (reference: CocoKeypoints_test.py)
        ds = {"images": records, "categories": categories}
        out = f"{root}/annotations/image_info_test-dev2017.json"
    else:
        ds = {"images": records, "annotations": annotations, "categories": categories}
        out = (f"{root}/ochuman_coco_format_val_range_0.00_1.00.json" if flavor == "ochuman"
               else f"{root}/annotations/person_keypoints_{mode}2017.json")
    with open(out, "w") as f:
        json.dump(ds, f)
    print(f"wrote {images} images to {root}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Write a fake COCO keypoint set")
    p.add_argument("--root", default="tmp/fake_coco")
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--mode", default="val")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--people", type=int, default=None,
                   help="fixed people per image (default: random 1-4)")
    p.add_argument("--flavor", default="coco", choices=sorted(IMAGE_DIRS))
    args = p.parse_args(argv)
    return make_fake_coco(args.root, args.images, args.mode, args.size, args.people,
                          args.flavor)


if __name__ == "__main__":
    main()
