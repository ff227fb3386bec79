"""Host-side result formatting: COCO-format annotations + reverse mapping
(copy of pemp_tpu.decode.format).

reference: src/Utils/eval.py:189-253 (gen_ann_format variants) and the tail
of pred_to_ann (src/Utils/Utils.py:1478-1490).
"""

from __future__ import annotations

import numpy as np

from pemp_tpu_torch.geometry.affine import reverse_affine_map


def gen_ann_format(pred, image_id=0):
    """Score = mean(conf>0.09) + sum of all confidences. reference: eval.py:189-211."""
    ans = []
    for person in pred:
        tmp = {"image_id": int(image_id), "category_id": 1, "keypoints": [], "score": 1.0}
        strong = person[:, 2] > 0.09
        score = float(person[strong, 2].mean()) if strong.sum() > 0 else 0.0
        for j in range(len(person)):
            tmp["keypoints"] += [float(person[j, 0]), float(person[j, 1]), float(person[j, 2])]
            score += float(person[j, 2])
        tmp["score"] = score
        ans.append(tmp)
    return ans


def gen_ann_format_correct(pred, image_id=0):
    """Score = sum of confidences. reference: eval.py:213-231."""
    ans = []
    for person in pred:
        tmp = {"image_id": int(image_id), "category_id": 1, "keypoints": [], "score": 1.0}
        score = 0.0
        for j in range(len(person)):
            tmp["keypoints"] += [float(person[j, 0]), float(person[j, 1]), float(person[j, 2])]
            score += float(person[j, 2])
        tmp["score"] = score
        ans.append(tmp)
    return ans


def gen_ann_format_mean(pred, image_id=0):
    """Score = mean(conf>0.09). reference: eval.py:233-253."""
    ans = []
    for person in pred:
        tmp = {"image_id": int(image_id), "category_id": 1, "keypoints": [], "score": 1.0}
        strong = person[:, 2] > 0.09
        score = float(person[strong, 2].mean()) if strong.sum() > 0 else 0.0
        for j in range(len(person)):
            tmp["keypoints"] += [float(person[j, 0]), float(person[j, 1]), float(person[j, 2])]
        tmp["score"] = score
        ans.append(tmp)
    return ans


_FORMATS = {
    "default": gen_ann_format,
    "correct": gen_ann_format_correct,
    "mean": gen_ann_format_mean,
}


def persons_to_ann(
    persons,            # (P, J, 3) device output of decode_poses
    person_valid,       # (P,)
    img_shape,          # (width, height) of the network-input image space
    input_size: int,
    img_id: int,
    scaling_type: str,
    min_scale: float = 1.0,
    scoring_method: str = "default",
):
    """Map decoded poses back to original coordinates and format.

    reference pred_to_ann tail: Utils.py:1478-1490. Returns None when no
    person survives (the reference's early-None contract).
    """
    persons = np.asarray(persons)
    person_valid = np.asarray(person_valid)
    persons = persons[person_valid]
    if persons.shape[0] == 0:
        return None
    persons = reverse_affine_map(
        persons.copy(), img_shape, input_size, scaling_type=scaling_type, min_scale=min_scale
    )
    return _FORMATS[scoring_method](persons, img_id)
