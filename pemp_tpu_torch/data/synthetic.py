"""Synthetic pose dataset for tests and benchmarks (numpy copy of
pemp_tpu.data.synthetic: the same ``RandomState`` gives the same batch).

No COCO data ships in this environment, so this generates random multi-person
scenes with exact ground truth: stick-figure keypoints, rendered blob images,
heatmap/AE targets, crowd masks, and OKS distance factors using the same
formula as the reference dataset (reference: src/data/CocoKeypoints_hr.py:94-104).
"""

from __future__ import annotations

import numpy as np

from pemp_tpu_torch.data.targets import HeatmapGenerator, JointsGenerator, pack_for_batch

KPT_OKS_SIGMAS = (
    np.array(
        [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87, .89, .89]
    )
    / 10.0
)

# rough humanoid template in a unit box: (x, y) per COCO joint
_TEMPLATE = np.array(
    [
        (0.50, 0.10), (0.46, 0.08), (0.54, 0.08), (0.42, 0.10), (0.58, 0.10),
        (0.38, 0.25), (0.62, 0.25), (0.33, 0.42), (0.67, 0.42), (0.30, 0.58),
        (0.70, 0.58), (0.42, 0.55), (0.58, 0.55), (0.41, 0.75), (0.59, 0.75),
        (0.40, 0.95), (0.60, 0.95),
    ]
)


def random_scene(rng, input_size=128, num_joints=17, max_people=30, n_people=None,
                 scale_range=(0.25, 0.6)):
    """Returns keypoints (P, J, 3) in input resolution and person scales.

    ``scale_range``: person size as a fraction of the image. The default
    produces realistically-small people; overfit/convergence tests should
    pass larger scales — OKS matching tolerance shrinks with person area
    ((2*sigma)^2 * area * 2), and at the default sizes on a 64px output
    grid the face joints' matchable radius drops below one pixel.
    """
    if n_people is None:
        n_people = rng.randint(1, 5)
    kps = []
    areas = []
    for _ in range(n_people):
        scale = rng.uniform(*scale_range) * input_size
        cx = rng.uniform(0.2, 0.8) * input_size
        cy = rng.uniform(0.2, 0.8) * input_size
        pts = _TEMPLATE[:num_joints] - 0.5
        pts = pts * scale
        pts = pts + rng.normal(0, scale * 0.02, pts.shape)
        pts = pts + np.array([cx, cy])
        vis = (
            (pts[:, 0] >= 0) & (pts[:, 0] < input_size)
            & (pts[:, 1] >= 0) & (pts[:, 1] < input_size)
        )
        kp = np.concatenate([pts, np.where(vis, 2.0, 0.0)[:, None]], axis=1)
        if vis.sum() >= 2:
            kps.append(kp)
            areas.append((scale * 0.6) ** 2)
    if not kps:
        return random_scene(rng, input_size, num_joints, max_people, n_people=1)
    return np.asarray(kps, np.float32), np.asarray(areas, np.float32)


def render_image(keypoints, input_size, rng):
    """Blobby render so a backbone has something to look at."""
    img = rng.rand(input_size, input_size, 3).astype(np.float32) * 0.1
    yy, xx = np.mgrid[0:input_size, 0:input_size]
    for kp in keypoints:
        for j, (x, y, v) in enumerate(kp):
            if v > 0:
                d2 = (xx - x) ** 2 + (yy - y) ** 2
                img[..., j % 3] += np.exp(-d2 / 18.0)
    return np.clip(img, 0, 1)


def make_sample(rng, input_size=128, output_sizes=(32, 64), num_joints=17, max_people=30,
                n_people=None, scale_range=(0.25, 0.6)):
    """One training sample with reference-shaped targets."""
    keypoints, areas = random_scene(
        rng, input_size, num_joints, max_people, n_people=n_people,
        scale_range=scale_range,
    )
    img = render_image(keypoints, input_size, rng)

    sig = KPT_OKS_SIGMAS[:num_joints]
    factors = ((sig * 2) ** 2)[None, :] * (areas[:, None] + np.spacing(1)) * 2.0

    heatmaps, masks, ae_targets = [], [], []
    kp_scaled_last = None
    for res in output_sizes:
        s = res / input_size
        kp_s = keypoints.copy()
        kp_s[:, :, :2] *= s
        # the reference's sigma = res/64 assumes res >= 128; keep sigma >= 1
        # and integral so the splat window arithmetic stays exact
        gen = HeatmapGenerator(res, num_joints, sigma=max(int(res / 64), 1))
        heatmaps.append(gen(kp_s).astype(np.float32))
        masks.append(np.ones((res, res), np.float32))
        jg = JointsGenerator(max_people, num_joints, res, True)
        ae_targets.append(jg(kp_s).astype(np.int32))
        kp_scaled_last = kp_s

    # factors are defined in input resolution; scale to last output resolution
    # like the affine pipeline does (area scales with the square of the map)
    s_last = (output_sizes[-1] / input_size) ** 2
    factors_out = factors * s_last

    kp_packed = pack_for_batch(kp_scaled_last.astype(np.float32), max_people)
    fac_packed = pack_for_batch(factors_out.astype(np.float32), max_people)
    return {
        "img": img.astype(np.float32),
        "heatmaps": heatmaps,
        "masks": masks,
        "keypoints": kp_packed,
        "factors": fac_packed,
        "ae_targets": ae_targets,
    }


def make_batch(rng, batch_size=2, input_size=128, output_sizes=(32, 64), num_joints=17,
               max_people=30, n_people=None, scale_range=(0.25, 0.6)):
    samples = [
        make_sample(rng, input_size, output_sizes, num_joints, max_people,
                    n_people=n_people, scale_range=scale_range)
        for _ in range(batch_size)
    ]
    n_scales = len(output_sizes)
    return {
        "imgs": np.stack([s["img"] for s in samples]),
        "heatmaps": [
            np.stack([s["heatmaps"][i] for s in samples]).transpose(0, 2, 3, 1)
            for i in range(n_scales)
        ],
        "masks": [
            np.stack([s["masks"][i] for s in samples]) for i in range(n_scales)
        ],
        "keypoints": np.stack([s["keypoints"] for s in samples]),
        "factors": np.stack([s["factors"] for s in samples]),
        "ae_targets": [
            np.stack([s["ae_targets"][i] for s in samples]) for i in range(n_scales)
        ],
    }


def _render(keypoints, height, width, rng):
    """render_image on an (height, width) canvas, each blob drawn in its
    own window (exp(-d2 / 18) is below 4e-4 past 12 pixels)."""
    img = rng.rand(height, width, 3).astype(np.float32) * 0.1
    for kp in keypoints:
        for j, (x, y, v) in enumerate(kp):
            if v > 0:
                x0, x1 = max(int(x) - 12, 0), min(int(x) + 13, width)
                y0, y1 = max(int(y) - 12, 0), min(int(y) + 13, height)
                yy, xx = np.mgrid[y0:y1, x0:x1]
                img[y0:y1, x0:x1, j % 3] += np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 18.0)
    return np.clip(img, 0, 1)


def eval_scenes(rng, sizes, num_joints=17, n_people=3, render=True, crowd_fraction=0.0):
    """An eval set in memory: COCO-format ground truth for images of the
    given (height, width) sizes (people placed in a random square of the
    short side, crowdIndex rising evenly from 0 to 1 over the images, a
    person marked ``iscrowd`` with probability ``crowd_fraction``) and,
    with ``render``, the images as (H, W, 3) uint8. Returns (images or
    None, dataset)."""
    images, records, anns = [], [], []
    for i, (h, w) in enumerate(sizes, 1):
        side = min(h, w)
        kps, areas = random_scene(rng, input_size=side, num_joints=num_joints,
                                  n_people=n_people, scale_range=(0.3, 0.8))
        kps[..., 0] += rng.randint(0, w - side + 1)
        kps[..., 1] += rng.randint(0, h - side + 1)
        records.append({"id": i, "width": w, "height": h, "file_name": f"{i:012d}.jpg",
                        "crowdIndex": (i - 1) / max(len(sizes) - 1, 1)})
        for kp, area in zip(kps, areas):
            vis = kp[:, 2] > 0
            x0, y0 = kp[vis, :2].min(0)
            x1, y1 = kp[vis, :2].max(0)
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": 1,
                         "keypoints": [float(v) for v in kp.ravel()],
                         "num_keypoints": int(vis.sum()), "area": float(area),
                         "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                         "iscrowd": int(rng.rand() < crowd_fraction)})
        if render:
            images.append((_render(kps, h, w, rng) * 255).astype(np.uint8))
    dataset = {"images": records, "annotations": anns,
               "categories": [{"id": 1, "name": "person"}]}
    return (images if render else None), dataset


def noisy_results(rng, dataset, noise):
    """Per image a list of COCO keypoint results: each ground-truth person
    moved by ``noise`` pixels (normal) with random scores and confidences,
    and one false person at random places."""
    per_image = {img["id"]: [] for img in dataset["images"]}
    sizes = {img["id"]: (img["width"], img["height"]) for img in dataset["images"]}
    for ann in dataset["annotations"]:
        kp = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3).copy()
        kp[:, :2] += rng.randn(len(kp), 2) * noise
        kp[:, 2] = rng.uniform(0.2, 1.0, len(kp))
        per_image[ann["image_id"]].append(
            {"image_id": ann["image_id"], "category_id": 1,
             "keypoints": [float(v) for v in kp.ravel()], "score": float(rng.rand())})
    for img_id, results in per_image.items():
        j = len(dataset["annotations"][0]["keypoints"]) // 3
        fake = rng.rand(j, 3) * [*sizes[img_id], 1.0]
        results.append({"image_id": img_id, "category_id": 1,
                        "keypoints": [float(v) for v in fake.ravel()],
                        "score": float(rng.rand())})
    return list(per_image.values())
