"""Multi-scale + flip test-time augmentation, batched on the card
(counterpart of pemp_tpu.tta.multi_scale's TTAPipeline).

reference: src/Models/PoseEstimation/PoseEstimation.py:147-253,
src/Utils/hr_utils/multi_scales_testing.py:1-389. Per image the host
resizes the input to every scale (numpy warp, the reference's 64-multiple
sizing), normalises it and pads it to a 128-pixel bucket. Images whose
padded shapes agree run together: per scale the backbone's forward and
flipped forward, the flipped maps rolled back per image and their joints
swapped (``FLIP_CONFIG``), and every map projected onto the common base
canvas and summed. Graph construction, the MPN and (with ``threshold``
grouping) the decode then run once on the aggregate, the canvas's valid
region serving as the detection mask.

Tag channels follow the reference: the scale-1 pass (or the only scale)
contributes its original and flipped tag maps as separate channels, so
tags are (H, W, J, S) with S = 2 with flip and 1 without
(multi_scales_testing.py:148-161).

With long-side scaling (the Hourglass's, ``DATASET.SCALING_TYPE: long``)
every scale is a square input of its 64-multiple and the canvas is the
largest scale's, at score-map resolution (``INPUT_SIZE / max(OUTPUT_SIZE)``,
4 for the Hourglass; reference: PoseEstimationHourglass.py:111-147).
``maps_only`` stops at the aggregated heat and tag maps, for the
AE-grouping entry point, whose model has no graph or MPN.

The JAX pipeline can fan each batch out over a process's local devices
(its ``mesh``, pemp_tpu/tta/multi_scale.py:119-127). Here a pipeline runs
on its model's one card; several cards are several processes, among which
the entry points share the images (parallel.distributed, ``valid``,
``valid_hr``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pemp_tpu_torch.data.transforms import FLIP_CONFIG
from pemp_tpu_torch.decode.assembly import decode_poses
from pemp_tpu_torch.geometry.affine import (
    get_affine_transform,
    get_multi_scale_size,
    get_multi_scale_size_hourglass,
    get_scaling_type,
)
from pemp_tpu_torch.geometry.warp import warp_affine
from pemp_tpu_torch.graph.constructor import construct_graph_batch
from pemp_tpu_torch.models.pose_estimation import head_probs

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def _bucket(x: int, granularity: int = 128) -> int:
    return int(-(-x // granularity) * granularity)


def _triangle_weights(in_size: int, out_size: int, scale, antialias: bool = False):
    """(B, in_size, out_size) weights of bilinear sampling at ``scale`` (B,)
    output pixels per input pixel, half-pixel centres, no translation:
    ``compute_weight_mat`` of ``jax.image.scale_and_translate``; with
    ``antialias`` a shrinking scale widens the triangle by 1 / scale. Each
    column is normalised over all ``in_size`` inputs, and a column whose
    sample falls outside them is 0."""
    f32 = torch.float32
    inv_scale = 1.0 / scale.to(f32)
    sample = (torch.arange(out_size, dtype=f32, device=scale.device)[None] + 0.5) \
        * inv_scale[:, None] - 0.5                                          # (B, out)
    src = torch.arange(in_size, dtype=f32, device=scale.device)[None, :, None]
    dist = torch.abs(sample[:, None, :] - src)                              # (B, in, out)
    if antialias:
        dist = dist / torch.clamp(inv_scale, min=1.0)[:, None, None]
    w = torch.clamp(1.0 - dist, min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def project_region(x, src_h, src_w, out_h: int, out_w: int, tgt_h=None, tgt_w=None):
    """Bilinear projection of the valid ``[0:src_h, 0:src_w]`` region of each
    padded map of ``x`` (B, H, W, C) onto the ``[0:tgt_h, 0:tgt_w]`` region
    of an ``(out_h, out_w)`` buffer. ``src_*`` and ``tgt_*`` are (B,)
    float32 tensors (``tgt`` defaults to the whole buffer).

    This is pemp_tpu/tta/multi_scale.py:86-113, ``jax.image.
    scale_and_translate`` with bilinear weights, ``antialias=False`` and
    translation 0, as one weight matrix per image and axis: out = W_y^T x
    W_x. Rows past the source region read the padding, as in JAX (not
    ``F.interpolate`` on the cropped region, the original reference's
    projection, which differs in a one-pixel border band).
    """
    if tgt_h is None:
        tgt_h = torch.full_like(src_h, float(out_h))
        tgt_w = torch.full_like(src_w, float(out_w))
    wy = _triangle_weights(x.shape[1], out_h, tgt_h / src_h)
    wx = _triangle_weights(x.shape[2], out_w, tgt_w / src_w)
    y = torch.einsum("bhwc,bhi->biwc", x, wy)
    return torch.einsum("biwc,bwj->bijc", y, wx)


def resize_bilinear(x, out_h: int, out_w: int):
    """``jax.image.resize(x, (B, out_h, out_w, C), "bilinear")`` of x (B, H,
    W, C): half-pixel centres, antialiased where an axis shrinks (for
    growth it equals ``F.interpolate(..., align_corners=False)``)."""
    b, h, w = x.shape[:3]
    one = torch.ones(b, dtype=torch.float32, device=x.device)
    wy = _triangle_weights(h, out_h, one * (out_h / h), antialias=True).to(x.dtype)
    wx = _triangle_weights(w, out_w, one * (out_w / w), antialias=True).to(x.dtype)
    y = torch.einsum("bhwc,bhi->biwc", x, wy)
    return torch.einsum("biwc,bwj->bijc", y, wx)


class TTAPipeline:
    """Host preparation and the batched device pass of the eval entry points.

    ``model`` is a :class:`~pemp_tpu_torch.models.pose_estimation.
    PoseEstimationBaseline`, or with ``maps_only`` any model with a
    ``backbone_forward`` (models.ae_group); it runs on the device its
    parameters are on. ``with_decode`` decodes on the device (threshold
    grouping); without it the outputs stop at the MPN's probabilities, for
    host clustering. ``maps_only`` stops at the aggregated maps.
    ``stage_times``, when a dict, gathers the seconds each stage takes
    (``warp``; per scale s ``backbone s`` with the flipped pass and
    ``projection s``; ``graph_mpn``, ``decode``), the device synchronised
    at each stage's end.
    """

    def __init__(self, model, config, with_decode: bool = True, maps_only: bool = False):
        self.model = model
        self.maps_only = maps_only
        self.device = next(model.parameters()).device
        self.config = config
        self.input_size = config.DATASET.INPUT_SIZE
        self.scales = sorted(config.TEST.SCALE_FACTOR, reverse=True)
        self.min_scale = min(config.TEST.SCALE_FACTOR)
        self.flip = bool(config.TEST.FLIP_TEST)
        dataset = "COCO" if "coco" in config.DATASET.DATASET else "CROWDPOSE"
        if not config.TEST.FLIP_AND_REARANGE:
            dataset = "COCO_WITHOUT_REARANGING"
        self.flip_index = torch.tensor(FLIP_CONFIG[dataset], device=self.device)
        self.num_joints = config.DATASET.NUM_JOINTS
        self.with_decode = with_decode
        self.node_threshold = config.MODEL.MPN.NODE_THRESHOLD
        # PROJECT2IMAGE: aggregate at input resolution and map back with
        # "short_with_resize"; otherwise at score-map resolution ("short",
        # "long"): input / 2 for HigherHRNet, input / 4 for the Hourglass
        self.project2image = bool(config.TEST.PROJECT2IMAGE)
        self.scaling_type = get_scaling_type(config)
        self.scaling_long = config.DATASET.SCALING_TYPE == "long"
        self.size_fn = (get_multi_scale_size_hourglass if self.scaling_long
                        else get_multi_scale_size)
        self.out_ratio = self.input_size / float(max(config.DATASET.OUTPUT_SIZE))
        self.stage_times = None

    def _mark(self, stage: str, t0: float) -> float:
        if self.stage_times is None:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.stage_times[stage] = self.stage_times.get(stage, 0.0) + t1 - t0
        return t1

    # ------------------------------------------------------------------ host
    def _prepare(self, image: np.ndarray):
        """Per scale the resized, normalised image padded to its bucket, and
        its valid (hs, ws); and the base size (h, w): at scale 1, or with
        long-side scaling at the largest scale."""
        h, w = image.shape[:2]
        base_scale = max(self.scales) if self.scaling_long else 1.0
        base_size, center, _ = self.size_fn(h, w, self.input_size, base_scale, self.min_scale)
        base_w, base_h = base_size
        prepared = []
        # keyed on the input dtype, not its values: a near-black uint8 image
        # is still scaled by 255 (the reference's ToTensor)
        is_uint = np.issubdtype(image.dtype, np.integer)
        for s in self.scales:
            size_resized, _, sc = self.size_fn(h, w, self.input_size, s, self.min_scale)
            mat = get_affine_transform(center, sc, size_resized)
            img_r = warp_affine(image.astype(np.float32), mat, size_resized)
            if is_uint:
                img_r = img_r / 255.0
            img_r = (img_r - MEAN) / STD
            ws, hs = size_resized
            padded = np.zeros((_bucket(hs), _bucket(ws), 3), np.float32)
            padded[:hs, :ws] = img_r
            prepared.append(dict(padded=padded, hs=hs, ws=ws))
        return prepared, (base_h, base_w)

    def _canvas(self, base_h, base_w):
        if self.project2image:
            return float(base_h), float(base_w)
        return base_h / self.out_ratio, base_w / self.out_ratio

    # ---------------------------------------------------------------- device
    def _unflip(self, x, ws):
        """The flipped pass's maps back in the original's frame: flip, then
        roll each image left by half_w - round(ws / 2) (round half to even,
        as jnp.round)."""
        half_w = x.shape[2]
        x = torch.flip(x, dims=[2])
        return torch.stack([torch.roll(x[i], -(half_w - round(w / 2.0)), dims=1)
                            for i, w in enumerate(ws)])

    @torch.no_grad()
    def _run(self, in_shapes, out_shape, preps, canvas):
        """The batched device pass over images of one padded-shape signature.
        ``preps``: their prepared scales; ``canvas``: (B, 2) float32."""
        model, dev = self.model, self.device
        bh, bw = out_shape
        b = len(preps)
        heat_acc = feat_acc = tag_acc = None
        t0 = time.perf_counter()
        for s, scale in enumerate(self.scales):
            hs = [p[s]["hs"] for p in preps]
            ws = [p[s]["ws"] for p in preps]
            imgs = torch.from_numpy(np.stack([p[s]["padded"] for p in preps])).to(dev)
            _, sm, feat, tg = model.backbone_forward(imgs)
            tag_vars = [tg]
            if self.flip:
                flipped = torch.zeros_like(imgs)
                for i, (h, w) in enumerate(zip(hs, ws)):
                    flipped[i, :h, :w] = imgs[i, :h, :w].flip(1)
                _, sm_f, _, tg_f = model.backbone_forward(flipped)
                sm_f = self._unflip(sm_f, ws)
                tg_f = self._unflip(tg_f, ws)
                sm = (sm + sm_f[..., self.flip_index]) / 2.0
                # tags are not averaged: original and flipped stay channels
                tag_vars.append(tg_f[..., self.flip_index])
            tg = torch.stack(tag_vars, dim=-1)                       # (B, h, w, J, S)
            t0 = self._mark(f"backbone {scale:g}", t0)

            ih, iw = in_shapes[s]
            hs_t, ws_t = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (hs, ws))

            def proj(x):
                return project_region(x, hs_t * (x.shape[1] / float(ih)),
                                      ws_t * (x.shape[2] / float(iw)), bh, bw,
                                      canvas[:, 0], canvas[:, 1])

            heat_acc = proj(sm) if heat_acc is None else heat_acc + proj(sm)
            if not self.maps_only:
                feat_acc = proj(feat) if feat_acc is None else feat_acc + proj(feat)
            # only the scale-1 pass contributes tags (reference
            # aggregate_results_mpn: multi_scales_testing.py:148-150)
            if scale == 1.0 or len(self.scales) == 1 or (
                tag_acc is None and s == len(self.scales) - 1
            ):
                tag_acc = proj(tg.flatten(3)).reshape(b, bh, bw, *tg.shape[3:])
            del sm, feat, tg, tag_vars
            t0 = self._mark(f"projection {scale:g}", t0)
        heat_acc = heat_acc / float(len(self.scales))
        if self.maps_only:
            return dict(scoremaps=heat_acc, tags=tag_acc)
        feat_acc = feat_acc / float(len(self.scales))

        yy = torch.arange(bh, dtype=torch.float32, device=dev)[None, :, None]
        xx = torch.arange(bw, dtype=torch.float32, device=dev)[None, None, :]
        base_mask = ((yy < canvas[:, 0, None, None])
                     & (xx < canvas[:, 1, None, None])).float()
        gb = construct_graph_batch(model.gc, heat_acc, feat_acc, tag_acc, masks=base_mask)
        # the aggregated feature map for SelfAttention, which the JAX
        # package's TTA does not pass (its SelfAttention fails there)
        preds = model.mpn_forward(gb, feature_maps=feat_acc)
        n = gb.joint_det.shape[0] // b
        e = gb.edge_index.shape[1] // b
        per_img = lambda t: t.reshape(b, -1, *t.shape[1:])  # noqa: E731
        offsets = torch.arange(b, device=dev)[:, None, None] * n
        edge_pred, node_pred, class_prob = head_probs(preds, gb.joint_scores, gb.edge_valid)
        out = dict(
            nodes=per_img(gb.joint_det),
            node_features=per_img(gb.x),
            node_scores=per_img(node_pred),
            detector_scores=per_img(gb.joint_scores),
            node_valid=per_img(gb.node_valid),
            edge_index=gb.edge_index.reshape(2, b, e).transpose(0, 1) - offsets,
            edge_valid=gb.edge_valid.reshape(b, e),
            edge_pred=edge_pred.reshape(b, e),
            class_prob=None if class_prob is None else per_img(class_prob),
            scoremaps=heat_acc,
            tags=tag_acc,
        )
        # tag-regression MPNs: their per-node tags, for the grouping by tag
        # (pemp_tpu/tta/multi_scale.py:438-440)
        if preds["tag"][-1] is not None:
            out["tag_pred"] = preds["tag"][-1].float().reshape(b, n, -1)
        t0 = self._mark("graph_mpn", t0)
        if self.with_decode:
            out["persons"], out["person_valid"] = self.decode(out)
            self._mark("decode", t0)
        return out

    def decode(self, out):
        """The threshold decode of a batch of ``_run``'s outputs, on the
        device their tensors lie on: (persons (B, P, J, 3), person_valid)."""
        test = self.config.TEST
        return decode_poses(
            out["scoremaps"], out["tags"], out["nodes"], out["node_scores"],
            out["edge_index"], out["edge_valid"], out["edge_pred"], out["node_valid"],
            node_threshold=self.node_threshold, num_joints=self.num_joints,
            blocked_c=self.model.gc.blocked_c, class_probs=out["class_prob"],
            with_fill_mean=test.FILL_MEAN, with_refine=test.WITH_REFINE,
            with_adjust=test.ADJUST,
        )

    def run_batched(self, images, batch_size: int = 8):
        """Evaluates a list of images (H, W, 3), uint8 or float in [0, 1].

        Images are grouped by the padded shapes of their scales and canvas
        and run ``batch_size`` at a time (the last batch of a group may be
        smaller: nothing is compiled per shape, so it is not padded as the
        JAX package pads it). Returns one dict per image, its tensors on the
        device: the aggregated scoremaps (H, W, J) and tags (H, W, J, S) on
        the padded canvas; unless ``maps_only``, nodes, node_features,
        node_scores, detector_scores, node_valid, edge_index (per-image ids),
        edge_valid, edge_pred, class_prob, and persons and person_valid with
        the decode, and tag_pred (N, 1) for an MPN with a tag head; and
        base_size (w, h), canvas_size (h, w) and scaling_type.
        """
        t0 = time.perf_counter()
        preps, metas = [], []
        for image in images:
            prepared, (base_h, base_w) = self._prepare(np.asarray(image))
            canvas = self._canvas(base_h, base_w)
            sig = (tuple(p["padded"].shape[:2] for p in prepared),
                   (_bucket(int(canvas[0])), _bucket(int(canvas[1]))))
            preps.append(prepared)
            metas.append(dict(sig=sig, canvas=canvas, base=(base_w, base_h)))
        self._mark("warp", t0)

        groups: dict = {}
        for idx, m in enumerate(metas):
            groups.setdefault(m["sig"], []).append(idx)
        outs: list = [None] * len(images)
        for (in_shapes, out_shape), idxs in groups.items():
            for start in range(0, len(idxs), batch_size):
                chunk = idxs[start:start + batch_size]
                canvas = torch.tensor([metas[i]["canvas"] for i in chunk],
                                      dtype=torch.float32, device=self.device)
                out = self._run(in_shapes, out_shape, [preps[i] for i in chunk], canvas)
                for k, idx in enumerate(chunk):
                    o = {key: None if value is None else value[k]
                         for key, value in out.items()}
                    o["base_size"] = metas[idx]["base"]
                    o["canvas_size"] = tuple(int(c) for c in metas[idx]["canvas"])
                    o["scaling_type"] = self.scaling_type
                    outs[idx] = o
        return outs

    def __call__(self, image):
        """One image: ``run_batched([image])[0]``."""
        return self.run_batched([image], batch_size=1)[0]
