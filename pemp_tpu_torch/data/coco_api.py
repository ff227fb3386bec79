"""Minimal pure-python COCO annotation API (copy of pemp_tpu.data.coco_api).

Drop-in for the subset of pycocotools.coco.COCO the framework uses
(reference usage: src/data/CocoKeypoints_hr.py:24-82, src/Utils/eval.py:152):
constructor from a JSON file or dict, getAnnIds/loadAnns/loadImgs/getCatIds,
imgs mapping, and loadRes for detection results.
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict


class COCO:
    def __init__(self, annotation_file=None):
        self.dataset = {}
        self.anns = {}
        self.imgs = {}
        self.cats = {}
        self.img_to_anns = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, str):
                with open(annotation_file) as f:
                    self.dataset = json.load(f)
            else:
                self.dataset = annotation_file
            self.create_index()

    def create_index(self):
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    def getCatIds(self, catNms=None, supNms=None, catIds=None):
        cats = list(self.cats.values())
        if catNms:
            cats = [c for c in cats if c.get("name") in catNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getImgIds(self, imgIds=None, catIds=None):
        ids = set(self.imgs.keys())
        if catIds:
            with_cat = {
                a["image_id"]
                for a in self.anns.values()
                if a.get("category_id") in set(catIds)
            }
            ids &= with_cat
        if imgIds:
            ids &= set(imgIds)
        return sorted(ids)

    def getAnnIds(self, imgIds=None, catIds=None, iscrowd=None):
        if imgIds is not None and not isinstance(imgIds, (list, tuple)):
            imgIds = [imgIds]
        anns = []
        if imgIds is not None:
            for i in imgIds:
                anns.extend(self.img_to_anns.get(i, []))
        else:
            anns = list(self.anns.values())
        if catIds is not None:
            cs = set(catIds if isinstance(catIds, (list, tuple)) else [catIds])
            anns = [a for a in anns if a.get("category_id") in cs]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def loadAnns(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def loadRes(self, res):
        """Create a result COCO from a list of detections or a JSON path."""
        if isinstance(res, str):
            with open(res) as f:
                res = json.load(f)
        out = COCO()
        out.dataset = {
            "images": list(self.dataset.get("images", [])),
            "categories": copy.deepcopy(self.dataset.get("categories", [])),
        }
        anns = copy.deepcopy(res)
        for i, ann in enumerate(anns):
            ann["id"] = i + 1
            if "keypoints" in ann and "area" not in ann:
                kp = ann["keypoints"]
                xs = kp[0::3]
                ys = kp[1::3]
                x0, x1 = min(xs), max(xs)
                y0, y1 = min(ys), max(ys)
                ann["area"] = (x1 - x0) * (y1 - y0)
                ann.setdefault("bbox", [x0, y0, x1 - x0, y1 - y0])
            ann.setdefault("iscrowd", 0)
        out.dataset["annotations"] = anns
        out.create_index()
        return out
