"""The port's COCO index, RLE decoding and eval sets against pemp_tpu.data
on sets written by tools/make_fake_coco.py (coco, ochuman and test-dev
flavours, and a CrowdPose layout made from the coco one): the same ids,
annotations and image bytes."""

import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from pemp_tpu.data import coco_api as jcoco_api
from pemp_tpu.data import datasets as jdatasets
from pemp_tpu.data import rle as jrle
from pemp_tpu_torch.data import coco_api, datasets, rle

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def fake_sets(tmp_path_factory):
    base = tmp_path_factory.mktemp("fake")
    roots = {}
    for flavor in ("coco", "ochuman", "testdev"):
        roots[flavor] = base / flavor
        subprocess.run([sys.executable, str(ROOT / "tools" / "make_fake_coco.py"), "--root",
                        str(roots[flavor]), "--images", "5", "--size", "72",
                        "--flavor", flavor], check=True, capture_output=True)
    # CrowdPose's layout: json/crowdpose_<mode>.json and images/
    crowd = base / "crowdpose"
    (crowd / "json").mkdir(parents=True)
    shutil.copytree(roots["coco"] / "val2017", crowd / "images")
    ds = json.loads((roots["coco"] / "annotations" / "person_keypoints_val2017.json").read_text())
    for ann in ds["annotations"]:
        ann["keypoints"] = ann["keypoints"][: 14 * 3]
    (crowd / "json" / "crowdpose_test.json").write_text(json.dumps(ds))
    roots["crowdpose"] = crowd
    return roots


def _pairs(roots):
    coco = str(roots["coco"])
    return {
        "coco": (datasets.CocoKeypoints(coco, filter_empty=False),
                 jdatasets.CocoKeypoints(coco, mode="val", filter_empty=False)),
        "coco_filtered": (datasets.CocoKeypoints(coco),
                          jdatasets.CocoKeypoints(coco, mode="val", cache_dir=str(roots["coco"]))),
        "coco_mini": (datasets.CocoKeypoints(coco, mini=True, filter_empty=False, seed=3),
                      jdatasets.CocoKeypoints(coco, mini=True, mode="val", filter_empty=False,
                                              seed=3)),
        "crowdpose": (datasets.CrowdPoseKeypoints(str(roots["crowdpose"]), filter_empty=False),
                      jdatasets.CrowdPoseKeypoints(str(roots["crowdpose"]), filter_empty=False)),
        "ochuman": (datasets.OCHumans(str(roots["ochuman"])),
                    jdatasets.OCHumans(str(roots["ochuman"]))),
    }


@pytest.mark.parametrize("name", ["coco", "coco_filtered", "coco_mini", "crowdpose", "ochuman"])
def test_eval_sets_match(fake_sets, name):
    port, jax_set = _pairs(fake_sets)[name]
    assert len(port) == len(jax_set) > 0
    np.testing.assert_array_equal(np.asarray(port.img_ids), np.asarray(jax_set.img_ids))
    np.testing.assert_array_equal(port.sigmas(), jax_set.sigmas())
    assert port.coco.dataset == jax_set.coco.dataset
    for i in range(len(port)):
        got, want = port.load_raw(i), jax_set.load_raw(i)
        assert got[:3] == want[:3]
        assert got[3].dtype == np.uint8 and np.array_equal(got[3], want[3])


def test_test_dev_set_matches(fake_sets):
    port = datasets.CocoKeypointsTest(str(fake_sets["testdev"]))
    jax_set = jdatasets.CocoKeypointsTest(str(fake_sets["testdev"]))
    assert list(port.img_ids) == list(jax_set.img_ids)
    for i in range(len(port)):
        img_id, anns, info, image = port.load_raw(i)
        assert anns == [] and info == jax_set.coco.loadImgs(img_id)[0]
        assert np.array_equal(image, jax_set[i][0])


def test_coco_index_matches(fake_sets):
    path = str(fake_sets["coco"] / "annotations" / "person_keypoints_val2017.json")
    port, jax_coco = coco_api.COCO(path), jcoco_api.COCO(path)
    assert port.getCatIds(catNms=["person"]) == jax_coco.getCatIds(catNms=["person"])
    assert port.getImgIds() == jax_coco.getImgIds()
    for img_id in port.getImgIds():
        ids = port.getAnnIds(imgIds=img_id, iscrowd=0)
        assert ids == jax_coco.getAnnIds(imgIds=img_id, iscrowd=0)
        assert port.loadAnns(ids) == jax_coco.loadAnns(ids)
    dets = [{"image_id": a["image_id"], "category_id": 1, "score": 0.5,
             "keypoints": a["keypoints"]} for a in port.dataset["annotations"]]
    assert port.loadRes(dets).dataset == jax_coco.loadRes(dets).dataset


def test_segmentation_to_mask_matches():
    rng = np.random.RandomState(2)
    h, w = 37, 53
    polys = [list((rng.rand(4, 2) * [w, h]).ravel()) for _ in range(3)] + [[3.0, 4.0, 9.0, 4.5]]
    counts = list(rng.randint(1, 40, 30))
    counts.append(h * w - int(np.sum(counts)))
    for segm in (polys, {"size": [h, w], "counts": counts}):
        got = rle.segmentation_to_mask(segm, h, w)
        assert got.any()
        np.testing.assert_array_equal(got, jrle.segmentation_to_mask(segm, h, w))
    # the compressed counts string of the COCO API
    s = "0123456789:;<=>?@ABCDEFGHIJ" * 2
    assert rle.decode_compressed_counts(s) == jrle.decode_compressed_counts(s)
