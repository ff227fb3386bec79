"""Pose and graph drawings as PNG files, without matplotlib.

The counterpart of ``pemp_tpu.utils.vis`` (reference: src/Utils/Utils.py:
43-258, 1180-1442: save_valid_image and add_joints with the COCO and
CrowdPose skeletons, and the detection, cluster, node-label and
edge-confidence drawings). Each drawing is split in two:

* a selection in numpy (the ``*_marks`` functions) that decides what is
  drawn: skeleton segments, points, each cluster's focus node and its
  edges, and their colours (matplotlib's ``tab10`` and ``tab20`` tables,
  the edge confidence's four bands, green and red node labels). It yields
  the segments, points and colours that the JAX module hands matplotlib,
  in the same order;
* a renderer (:func:`render`) that draws those lines and then those dots
  over the image in an RGB array, and :func:`write_png`, which stores it
  with the standard library's ``zlib`` and ``struct``.

The pixels are this module's own: the PNG has the image's size (no figure
margins or dpi), lines are drawn opaque and one pixel wide for widths up
to 2, a dot of matplotlib marker area ``s`` is a disc of radius
``max(sqrt(s) / 2, 1)`` pixels.
"""

from __future__ import annotations

import math
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

COCO_SKELETON = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
]
CROWDPOSE_SKELETON = [
    (0, 2), (1, 3), (2, 4), (3, 5), (0, 1), (6, 8), (7, 9), (8, 10),
    (9, 11), (6, 7), (0, 13), (1, 13), (12, 13),
]


def _hex(codes):
    return [tuple(int(c[i:i + 2], 16) / 255.0 for i in (0, 2, 4)) for c in codes]


# matplotlib's qualitative colour maps (the Tableau 10 and 20 palettes)
TAB10 = _hex(["1f77b4", "ff7f0e", "2ca02c", "d62728", "9467bd", "8c564b", "e377c2", "7f7f7f",
              "bcbd22", "17becf"])
TAB20 = _hex(["1f77b4", "aec7e8", "ff7f0e", "ffbb78", "2ca02c", "98df8a", "d62728", "ff9896",
              "9467bd", "c5b0d5", "8c564b", "c49c94", "e377c2", "f7b6d2", "7f7f7f", "c7c7c7",
              "bcbd22", "dbdb8d", "17becf", "9edae5"])
WHITE = (1.0, 1.0, 1.0)
TRUE_NODE = (0.1, 0.8, 0.1)       # green: a true keypoint
FALSE_NODE = (0.9, 0.1, 0.1)      # red: a false positive


def edge_color(score: float):
    """The edge confidence's four bands (reference: Utils.py:1292)."""
    if score > 0.75:
        return (0.1, 0.7, 0.1)
    if score > 0.5:
        return (0.6, 0.8, 0.1)
    if score > 0.25:
        return (0.95, 0.6, 0.1)
    return (0.9, 0.1, 0.1)


@dataclass
class Marks:
    """What one drawing shows, in drawing order: ``lines`` of (xs (2,), ys
    (2,), rgb, width) and ``dots`` of (xs (n,), ys (n,), rgbs (n, 3), marker
    area)."""

    lines: list = field(default_factory=list)
    dots: list = field(default_factory=list)

    def line(self, p, q, color, width):
        self.lines.append((np.array([p[0], q[0]], np.float64),
                           np.array([p[1], q[1]], np.float64), tuple(color), float(width)))

    def scatter(self, xs, ys, colors, size):
        xs = np.asarray(xs, np.float64).reshape(-1)
        colors = np.asarray(colors, np.float64).reshape(-1, 3)
        if len(colors) == 1:
            colors = np.repeat(colors, len(xs), axis=0)
        self.dots.append((xs, np.asarray(ys, np.float64).reshape(-1), colors, float(size)))


# ------------------------------------------------------------------ selections


def add_joints(marks: Marks, joints, color, skeleton):
    """One person's skeleton segments between visible joints (width 1.5)
    and its visible joints (area 8)."""
    joints = np.asarray(joints)
    for a, b in skeleton:
        if a < len(joints) and b < len(joints) and joints[a, 2] > 0 and joints[b, 2] > 0:
            marks.line(joints[a, :2], joints[b, :2], color, 1.5)
    vis = joints[:, 2] > 0
    marks.scatter(joints[vis, 0], joints[vis, 1], [color], 8)


def pose_marks(persons, dataset="COCO", gt_persons=None) -> Marks:
    """Predicted persons in ``tab10``'s colours, then GT persons in white."""
    skeleton = COCO_SKELETON if dataset.upper() == "COCO" else CROWDPOSE_SKELETON
    marks = Marks()
    for i, person in enumerate(np.asarray(persons)):
        add_joints(marks, person, TAB10[i % 10], skeleton)
    if gt_persons is not None:
        for person in np.asarray(gt_persons):
            add_joints(marks, person, WHITE, skeleton)
    return marks


def detection_marks(joint_det, valid) -> Marks:
    """The valid candidates coloured by joint type (``tab20``)."""
    det = np.asarray(joint_det)[np.asarray(valid)]
    marks = Marks()
    marks.scatter(det[:, 0], det[:, 1], [TAB20[int(t) % 20] for t in det[:, 2]], 10)
    return marks


def cluster_marks(joint_det, person_labels, valid) -> Marks:
    """The valid candidates coloured by cluster id (``tab20``)."""
    det, lab, v = np.asarray(joint_det), np.asarray(person_labels), np.asarray(valid)
    marks = Marks()
    marks.scatter(det[v, 0], det[v, 1], [TAB20[int(i) % 20] for i in lab[v]], 12)
    return marks


def classification_marks(joint_det, joint_labels, valid) -> Marks:
    """The valid candidates green where labelled a keypoint, else red."""
    det, v = np.asarray(joint_det), np.asarray(valid)
    lab = np.asarray(joint_labels).astype(int)
    colors = np.where(lab[v, None] > 0, [TRUE_NODE], [FALSE_NODE])
    marks = Marks()
    marks.scatter(det[v, 0], det[v, 1], colors, 12)
    return marks


def _focus(det, lab, v, ns, person, joint_type):
    """The highest-scoring node of ``joint_type`` in cluster ``person``, or
    None for a cluster of fewer than two nodes or without one."""
    sel = v & (lab == person)
    if sel.sum() < 2:
        return None
    scores = np.where(sel & (det[:, 2] == joint_type), ns, -1.0)
    if scores.max() <= -1.0:
        return None
    return int(np.argmax(scores))


def edges_conf_marks(joint_det, person_labels, preds_nodes, edge_index, preds_edges, valid,
                     focus_type: int = 0) -> Marks:
    """Per cluster its best ``focus_type`` node, every edge into it from a
    valid node coloured by confidence (width 1), the node in white
    (reference: Utils.py:1270-1352)."""
    det, lab, v = np.asarray(joint_det), np.asarray(person_labels), np.asarray(valid)
    ns, ei, es = np.asarray(preds_nodes), np.asarray(edge_index), np.asarray(preds_edges)
    marks = Marks()
    for person in np.unique(lab[v]):
        focus = _focus(det, lab, v, ns, person, focus_type)
        if focus is None:
            continue
        inc = ei[1] == focus
        for src, s in zip(ei[0][inc], es[inc]):
            if v[src]:
                marks.line(det[focus, :2], det[src, :2], edge_color(float(s)), 1.0)
        marks.scatter([det[focus, 0]], [det[focus, 1]], [WHITE], 20)
    return marks


def inter_person_marks(joint_det, person_labels, preds_nodes, edge_index, preds_edges, valid,
                       type_to_draw, num_joints: int = 17) -> Marks:
    """Per cluster its best ``type_to_draw`` node and, for every other
    cluster of two or more of its sources, the edge from that cluster's
    best source of each type, coloured by confidence (width 0.8), the node
    in white (reference: Utils.py:1355-1442)."""
    det, lab, v = np.asarray(joint_det), np.asarray(person_labels), np.asarray(valid)
    ns, ei, es = np.asarray(preds_nodes), np.asarray(edge_index), np.asarray(preds_edges)
    persons = np.unique(lab[v])
    marks = Marks()
    for person in persons:
        focus = _focus(det, lab, v, ns, person, type_to_draw)
        if focus is None:
            continue
        inc = ei[1] == focus
        src_idx, edge_sc = ei[0][inc], es[inc]
        for other in persons:
            if other == person:
                continue
            src_person = v[src_idx] & (lab[src_idx] == other)
            if src_person.sum() < 2:
                continue
            for other_type in range(num_joints):
                m = src_person & (det[src_idx, 2] == other_type)
                if not m.any():
                    continue
                k = int(np.argmax(np.where(m, ns[src_idx], -1.0)))
                marks.line(det[focus, :2], det[int(src_idx[k]), :2],
                           edge_color(float(edge_sc[k])), 0.8)
        marks.scatter([det[focus, 0]], [det[focus, 1]], [WHITE], 20)
    return marks


# ------------------------------------------------------------------ renderer


def _disc(radius: float) -> np.ndarray:
    r = int(math.floor(radius))
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    keep = dx ** 2 + dy ** 2 <= radius ** 2
    return np.stack([dy[keep], dx[keep]], 1)


def _paint(img, ys, xs, offsets, color):
    """``color`` on the pixels within ``offsets`` of each rounded (y, x)."""
    ok = np.isfinite(xs) & np.isfinite(ys)
    yy = (np.rint(ys[ok])[:, None] + offsets[None, :, 0]).astype(np.int64).reshape(-1)
    xx = (np.rint(xs[ok])[:, None] + offsets[None, :, 1]).astype(np.int64).reshape(-1)
    h, w = img.shape[:2]
    inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    img[yy[inside], xx[inside]] = color


def render(image, marks: Marks) -> np.ndarray:
    """The image (H, W, 3), uint8 or float in [0, 1], with the lines and
    then the dots drawn over it: (H, W, 3) uint8."""
    img = np.asarray(image, np.float64)
    if img.max() > 1.5:
        img = img / 255.0
    img = np.clip(img, 0, 1).copy()
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    for xs, ys, color, width in marks.lines:
        n = int(math.ceil(2 * math.hypot(xs[1] - xs[0], ys[1] - ys[0]))) + 1 \
            if np.isfinite(xs).all() and np.isfinite(ys).all() else 1
        t = np.linspace(0.0, 1.0, max(n, 2))
        _paint(img, ys[0] + t * (ys[1] - ys[0]), xs[0] + t * (xs[1] - xs[0]),
               _disc(max(width / 2, 0.5)), color)
    for xs, ys, colors, size in marks.dots:
        offsets = _disc(max(math.sqrt(size) / 2, 1.0))
        for x, y, color in zip(xs, ys, colors):
            _paint(img, np.array([y]), np.array([x]), offsets, color)
    return np.floor(img * 255 + 0.5).astype(np.uint8)


def write_png(fname, rgb) -> str:
    """An (H, W, 3) uint8 array as an 8-bit RGB PNG (no filter)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(fname, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))
    return fname


# ------------------------------------------------------------------ drawings


def save_valid_image(image, persons, fname, dataset="COCO", gt_persons=None) -> str:
    """Predicted (and GT) poses over the image, to ``fname``."""
    return write_png(fname, render(image, pose_marks(persons, dataset, gt_persons)))


def draw_detections(image, joint_det, valid, fname) -> str:
    """Keypoint candidates coloured by type (reference: Utils.py:43-...)."""
    return write_png(fname, render(image, detection_marks(joint_det, valid)))


def draw_detection_with_cluster(image, joint_det, person_labels, valid, fname) -> str:
    """Candidates coloured by cluster, to ``<fname>_det_cluster.png``
    (reference: Utils.py:43-78)."""
    return write_png(f"{fname}_det_cluster.png",
                     render(image, cluster_marks(joint_det, person_labels, valid)))


def draw_detection_classification_result(image, joint_det, joint_labels, valid, fname) -> str:
    """Candidates green or red by node label, to ``<fname>_det_fp.png``
    (reference: Utils.py:231-258)."""
    return write_png(f"{fname}_det_fp.png",
                     render(image, classification_marks(joint_det, joint_labels, valid)))


def draw_edges_conf(image, joint_det, person_labels, preds_nodes, edge_index, preds_edges,
                    valid, fname, focus_type: int = 0) -> str:
    """:func:`edges_conf_marks` to ``<fname>_edge_conf.png``."""
    return write_png(f"{fname}_edge_conf.png", render(image, edges_conf_marks(
        joint_det, person_labels, preds_nodes, edge_index, preds_edges, valid, focus_type)))


def draw_inter_person_edge_conf(image, joint_det, person_labels, preds_nodes, edge_index,
                                preds_edges, valid, type_to_draw, fname,
                                num_joints: int = 17) -> str:
    """:func:`inter_person_marks` to
    ``<fname>_inter_per_edge_conf_<type_to_draw>.png``."""
    return write_png(f"{fname}_inter_per_edge_conf_{type_to_draw}.png", render(
        image, inter_person_marks(joint_det, person_labels, preds_nodes, edge_index,
                                  preds_edges, valid, type_to_draw, num_joints)))
