"""Losses of the training path (counterpart of pemp_tpu.losses.factories;
reference: src/Utils/loss.py).

All losses take explicit masks, which also carry node and edge validity,
so padding is inert. Ported: ``ClassMultiLossFactory`` (the flagship) with
the edge, node, class and heatmap losses, the associative-embedding loss
on the tag maps (``tagmap``) and on the MPN's per-node tags
(``tag_loss``, :func:`node_ae_loss`); the tag-regression factories
``TagMultiLossFactory`` and ``PureTagMultiLossFactory``; the background
class's ``BackgroundClassMultiLossFactory``; ``ClassMPNLossFactory``; and
the edge-only ``MPNLossFactory`` and ``MultiLossFactory``.
``dispatch_loss_func`` routes to them as the JAX package does. Every
factory is called ``(outputs, labels, masks, graph)``; ``PureTagMultiLossFactory``
with ``SYNC_TAGS`` reads the graph's nodes, the rest ignore it.
"""

from __future__ import annotations

import torch


def sigmoid_bce_with_logits(logits, targets):
    """binary_cross_entropy_with_logits, elementwise."""
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def focal_loss(logits, targets, mask=None, alpha=1.0, gamma=2.0):
    """reference FocalLoss (loss.py:865-891): alpha * (1 - pt)^gamma * BCE,
    mask-normalised mean (sum / mask.sum())."""
    bce = sigmoid_bce_with_logits(logits, targets)
    pt = torch.exp(-bce)
    f = alpha * (1 - pt) ** gamma * bce
    if mask is None:
        return f.mean()
    return (f * mask).sum() / torch.clamp(mask.sum(), min=1e-12)


def bce_loss_with_logits(logits, targets, mask=None, pos_weight=None):
    """reference BCELossWtihLogits (loss.py:893-910): plain mean over all
    elements (the mask multiplies but does not renormalise)."""
    bce = sigmoid_bce_with_logits(logits, targets)
    if mask is not None:
        bce = bce * mask
    if pos_weight is not None:
        bce = torch.where(targets == 1.0, bce * pos_weight, bce)
    return bce.mean()


def cross_entropy_with_logits(logits, targets, mask=None):
    """reference CrossEntropyLossWithLogits (loss.py:923-933): mean over all
    elements after the mask multiply."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, 1, targets.long()[:, None])[:, 0]
    if mask is not None:
        ce = ce * mask
    return ce.mean()


def heatmap_loss(pred, gt, mask):
    """Masked MSE, per-image mean over (H, W, J), NHWC. reference
    HeatmapLoss (loss.py:17-27)."""
    return ((pred - gt) ** 2 * mask[..., None]).mean(dim=(1, 2, 3))


def ae_loss(tags_pred_flat, joints, loss_type="exp"):
    """Associative-embedding push and pull on tag maps, per image.

    tags_pred_flat (B, L): the tag maps flattened in (J, H, W) order;
    joints (B, P, J, 2) int: (flat index into L, valid) per person and
    joint. reference AELoss (loss.py:37-98). Returns (push (B,), pull (B,)).
    """
    idx = joints[..., 0].long().clamp(0, tags_pred_flat.shape[1] - 1)   # (B, P, J)
    v = joints[..., 1] > 0
    b, p, j = idx.shape
    t = torch.gather(tags_pred_flat, 1, idx.reshape(b, p * j)).reshape(b, p, j)
    zero = torch.zeros_like(t)
    cnt = v.sum(dim=2)                                          # (B, P)
    person_valid = cnt > 0
    safe_cnt = cnt.clamp(min=1)
    mean_t = torch.where(v, t, zero).sum(dim=2) / safe_cnt      # (B, P)
    pull_pp = torch.where(v, (t - mean_t[:, :, None]) ** 2, zero).sum(dim=2) / safe_cnt
    num_tags = person_valid.sum(dim=1)                          # (B,)
    pull = torch.where(person_valid, pull_pp, torch.zeros_like(pull_pp)).sum(dim=1) \
        / num_tags.clamp(min=1)

    diff = mean_t[:, :, None] - mean_t[:, None, :]
    pair_valid = person_valid[:, :, None] & person_valid[:, None, :]
    if loss_type == "exp":
        push_mat = torch.exp(-(diff ** 2))
    else:   # max
        push_mat = torch.clamp(1 - diff.abs(), min=0)
    push = torch.where(pair_valid, push_mat, torch.zeros_like(push_mat)).sum(dim=(1, 2)) - num_tags
    denom = ((num_tags - 1) * num_tags).clamp(min=1)
    push = torch.where(num_tags > 1, push / denom * 0.5, torch.zeros_like(push))
    pull = torch.where(num_tags > 0, pull, torch.zeros_like(pull))
    return push, pull


def node_ae_loss(tags, person_label, batch_index, node_valid, num_images: int,
                 max_people: int = 30, loss_type: str = "exp"):
    """Associative-embedding push and pull on the MPN's per-node tags, per
    image (pemp_tpu.losses.factories.node_ae_loss; reference NodeAELoss,
    loss.py:101-159). tags (N,); person_label (N,), -1 where unmatched;
    batch_index (N,) each node's image; node_valid (N,) the nodes that
    count. The reference's semantics exactly: an image holds ``max(person
    id) + 1`` tags, so a person id with no node is a tag of mean 0 that
    enters the push pairs and the pull denominator; segments are (image,
    person) with the id clipped at ``max_people - 1``. An image with no
    counted node holds no tag. Returns (push (B,), pull (B,))."""
    from pemp_tpu_torch.ops.segment import segment_mean

    ok = node_valid.bool() & (person_label >= 0)
    bi = batch_index.long()
    seg = bi * max_people + person_label.long().clamp(0, max_people - 1)
    n_seg = num_images * max_people
    mean_t = segment_mean(tags, seg, n_seg, ok)                      # (B * P,)
    pull_pp = segment_mean((tags - mean_t[seg]) ** 2, seg, n_seg, ok)
    mean_t = mean_t.reshape(num_images, max_people)
    pull_pp = pull_pp.reshape(num_images, max_people)

    # the reference's tag count: scatter_mean's output length, max id + 1;
    # an image with no counted node keeps its start value -1, so 0 tags
    pid = torch.where(ok, person_label.long(), torch.full_like(bi, -1))
    max_pid = torch.full((num_images,), -1, dtype=torch.long, device=tags.device)
    max_pid = max_pid.scatter_reduce(0, bi, pid, "amax", include_self=False)
    num_tags = (max_pid + 1).clamp(min=0)                               # (B,)
    in_range = torch.arange(max_people, device=tags.device)[None] < num_tags[:, None]

    zero = torch.zeros_like(pull_pp)
    pull = torch.where(in_range, pull_pp, zero).sum(dim=1)
    pull = torch.where(num_tags > 0, pull / num_tags.clamp(min=1), torch.zeros_like(pull))
    diff = mean_t[:, :, None] - mean_t[:, None, :]
    pv = in_range[:, :, None] & in_range[:, None, :]
    if loss_type == "exp":
        push_mat = torch.exp(-(diff ** 2))
    else:
        push_mat = torch.clamp(1 - diff.abs(), min=0)
    push = torch.where(pv, push_mat, torch.zeros_like(push_mat)).sum(dim=(1, 2)) - num_tags
    denom = ((num_tags - 1) * num_tags).clamp(min=1)
    push = torch.where(num_tags > 1, push / denom * 0.5, torch.zeros_like(push))
    return push, pull


def _node_tag_loss(tag, labels, sel, max_people, loss_type, tags_sel=None, person=None,
                   batch_index=None):
    """mean(push) + mean(pull) of :func:`node_ae_loss` on ``tag`` over the
    nodes ``sel`` marks (labels' persons and images, or the given ones),
    0 without a positive node (reference loss.py:712-716); ``tags_sel``
    (the selection of ``tag``'s rows) defaults to ``sel``."""
    tags_sel = sel if tags_sel is None else tags_sel
    person = labels["person"] if person is None else person
    batch_index = labels["batch_index"] if batch_index is None else batch_index
    push, pull = node_ae_loss(tag, torch.where(tags_sel, person, torch.full_like(person, -1)),
                              batch_index, tags_sel, num_images=int(labels["num_images"]),
                              max_people=max_people, loss_type=loss_type)
    total = push.mean() + pull.mean()
    return torch.where(sel.sum() > 0, total, torch.zeros_like(total))


def _positive_nodes(labels, masks):
    """The label-positive valid nodes, which the per-node tag losses count."""
    sel = labels["node"] == 1.0
    if isinstance(masks, dict) and masks.get("node_valid") is not None:
        sel = sel & masks["node_valid"].bool()
    return sel


def mask_node_connections(preds_nodes_sigmoid, edge_index, threshold, node_labels=None,
                          include_bordering_nodes=False):
    """Graph-reduction mask for the edge loss: edges between nodes that are
    predicted (or labelled) positive. reference: src/train.py:103-112."""
    tp = preds_nodes_sigmoid > threshold
    if node_labels is not None:
        tp = tp | (node_labels == 1.0)
    src, dst = edge_index[0].long(), edge_index[1].long()
    if include_bordering_nodes:
        return tp[src] | tp[dst]
    return tp[src] & tp[dst]


class _HeatmapAE:
    """The heatmap MSE and tag-map AE terms the factories share (reference:
    the identical loops at loss.py:259-290, 367-400, 485-510, 625-660;
    pemp_tpu/losses/factories.py:316-360)."""

    def _init_heatmap_ae(self, config, with_heatmap=True, with_tagmap=True):
        self.num_joints = config.MODEL.HRNET.NUM_JOINTS
        self.with_heatmap = with_heatmap
        self.with_tagmap = with_tagmap
        if config.MODEL.KP in ("hrnet", "mmpose_hrnet"):
            self.with_heatmaps_loss = tuple(config.MODEL.HRNET.LOSS.WITH_HEATMAPS_LOSS)
            self.heatmaps_loss_factor = tuple(config.MODEL.HRNET.LOSS.HEATMAPS_LOSS_FACTOR)
        else:
            # the Hourglass: every stack's heatmaps, weight 1
            # (pemp_tpu/losses/factories.py:325-332)
            nstack = config.MODEL.HG.NSTACK
            self.with_heatmaps_loss = (True,) * nstack
            self.heatmaps_loss_factor = (1.0,) * nstack
        self.with_ae = tuple(config.TRAIN.WITH_AE_LOSS)
        self.ae_loss_type = config.MODEL.HRNET.LOSS.AE_LOSS_TYPE
        self.push_factor = tuple(config.MODEL.HRNET.LOSS.PUSH_LOSS_FACTOR)
        self.pull_factor = tuple(config.MODEL.HRNET.LOSS.PULL_LOSS_FACTOR)
        self.max_people = config.DATASET.MAX_NUM_PEOPLE

    def _heatmap_ae(self, outputs, labels, masks):
        """(heatmap total, tag-map AE total)."""
        heatmap_total = 0.0
        if self.with_heatmap:
            for idx, pred in enumerate(outputs["heatmap"]):
                if idx < len(self.with_heatmaps_loss) and self.with_heatmaps_loss[idx]:
                    hl = heatmap_loss(pred[..., :self.num_joints], labels["heatmap"][idx],
                                      masks["heatmap"][idx])
                    heatmap_total = heatmap_total + hl.mean() * self.heatmaps_loss_factor[idx]
        ae_total = 0.0
        if self.with_tagmap:
            for idx, pred in enumerate(outputs["heatmap"]):
                if idx < len(self.with_ae) and self.with_ae[idx]:
                    tags = pred[..., self.num_joints:]
                    # flattened in the reference's CHW order: (J, H, W)
                    flat = tags.permute(0, 3, 1, 2).reshape(tags.shape[0], -1)
                    push, pull = ae_loss(flat, labels["tag"][idx], self.ae_loss_type)
                    ae_total = (ae_total + push.mean() * self.push_factor[idx]
                                + pull.mean() * self.pull_factor[idx])
        return heatmap_total, ae_total


def _per_step(x, i):
    """A per-step list's entry ``i``, or ``x`` itself when it is one tensor."""
    return x[i] if isinstance(x, (list, tuple)) else x


def _focal_edges(outputs, labels, masks, alpha, gamma):
    """The focal edge loss averaged over the steps' edge logits (a None
    entry adds nothing but counts), 0 where nan (an empty mask; reference
    loss.py:682-684): the background and node-edge factories' edge term."""
    preds = outputs["edge"]
    total = 0.0
    for i, p in enumerate(preds):
        if p is not None:
            total = total + focal_loss(p, _per_step(labels["edge"], i),
                                       _per_step(masks["edge"], i), alpha, gamma)
    total = torch.as_tensor(total) / max(len(preds), 1)
    return torch.where(torch.isnan(total), torch.zeros_like(total), total)


def _class_ce(outputs, labels, mask):
    """Cross entropy averaged over the steps' class logits (0 without a
    class head)."""
    total = 0.0
    if outputs["class"] is not None:
        for p in outputs["class"]:
            total = total + cross_entropy_with_logits(p, labels["class"], mask)
        total = total / max(len(outputs["class"]), 1)
    return total


def _require_node_head(outputs, factory):
    """The node terms of the JAX package's factories take the sigmoid of
    every node output; an MPN without a node head (node ``[None]``) fails
    there (a TypeError), so the port refuses it by name."""
    if any(p is None for p in outputs["node"]):
        raise NotImplementedError(
            f"{factory}: this MPN has no node head (node [None]); the JAX package's factory "
            f"fails on it too")


class ClassMultiLossFactory(_HeatmapAE):
    """Flagship multi-loss: heatmap + tag-map AE + node + edge + class +
    the per-node tag AE (``tag_loss``). reference: loss.py:539-758.
    Stateless; settings from the config tree."""

    def __init__(self, config):
        losses = set(config.MODEL.LOSS.NAME)
        self._init_heatmap_ae(config, "heatmap" in losses, "tagmap" in losses)
        self.with_edge = "edge" in losses
        self.with_node = "node" in losses
        self.with_class = "class" in losses
        self.with_tag_loss = "tag_loss" in losses
        loss = config.MODEL.LOSS
        self.edge_weight = loss.EDGE_WEIGHT
        self.node_weight = loss.NODE_WEIGHT
        self.class_weight = loss.CLASS_WEIGHT
        self.tag_weight = loss.TAG_WEIGHT
        self.alpha = loss.FOCAL_ALPHA
        self.gamma = loss.FOCAL_GAMMA
        self.use_focal = loss.USE_FOCAL
        self.edge_pos_weight = loss.EDGE_BCE_POS_WEIGHT
        if self.with_node and not loss.NODE_USE_FOCAL:
            # the reference raises for a non-focal node loss here too
            # (loss.py:618-621)
            raise NotImplementedError("MODEL.LOSS.NODE_USE_FOCAL=False")

    def __call__(self, outputs, labels, masks, graph=None):
        """Returns (total loss, {part name: loss})."""
        heatmap_total, ae_total = self._heatmap_ae(outputs, labels, masks)
        logging = {"heatmap": heatmap_total, "tag_loss": ae_total}
        total = heatmap_total + ae_total

        node_total = 0.0
        if self.with_node:
            _require_node_head(outputs, "ClassMultiLossFactory")
            preds = outputs["node"]
            for p in preds:
                node_total = node_total + focal_loss(
                    p, labels["node"], masks["node"], self.alpha, self.gamma)
            node_total = node_total / max(len(preds), 1)
        node_total = node_total * self.node_weight
        total = total + node_total
        logging["node"] = node_total

        edge_total = 0.0
        if self.with_edge:
            preds = outputs["edge"]
            for i, p in enumerate(preds):
                if self.use_focal:
                    step = focal_loss(p, labels["edge"][i], masks["edge"][i],
                                      self.alpha, self.gamma)
                else:
                    step = bce_loss_with_logits(p, labels["edge"][i], masks["edge"][i],
                                                self.edge_pos_weight)
                # nan (empty mask) contributes zero, as the reference's isnan
                # guard (loss.py:682-684)
                edge_total = edge_total + torch.where(torch.isnan(step), 0.0, step)
            edge_total = edge_total / max(len(preds), 1)
        edge_total = edge_total * self.edge_weight
        total = total + edge_total
        logging["edge"] = edge_total

        class_total = 0.0
        if self.with_class:
            class_total = _class_ce(outputs, labels, masks["class"])
        class_total = class_total * self.class_weight
        total = total + class_total
        logging["class_loss"] = class_total

        tag_total = 0.0
        if self.with_tag_loss and outputs["tag"][-1] is not None:
            tag_total = _node_tag_loss(outputs["tag"][-1], labels, _positive_nodes(labels, masks),
                                       self.max_people, self.ae_loss_type)
        total = total + tag_total * self.tag_weight

        logging["loss"] = total
        return total, logging


class BackgroundClassMultiLossFactory(_HeatmapAE):
    """heatmap + tag-map AE + focal edge + cross entropy over J + 1 classes
    (the background class of ``WITH_BACKGROUND``), weighted by
    ``LOSS_WEIGHTS`` [edge, class]. reference: loss.py:218-319;
    pemp_tpu/losses/factories.py:363-412."""

    def __init__(self, config):
        self._init_heatmap_ae(config)
        self.loss_weights = list(config.MODEL.LOSS.LOSS_WEIGHTS)
        if len(self.loss_weights) != 2:
            raise ValueError(f"MODEL.LOSS.LOSS_WEIGHTS={self.loss_weights}: [edge, class]")
        if not config.MODEL.LOSS.USE_FOCAL:
            # the reference raises otherwise (loss.py:251-254)
            raise NotImplementedError("MODEL.LOSS.USE_FOCAL=False with the background loss")
        self.alpha = config.MODEL.LOSS.FOCAL_ALPHA
        self.gamma = config.MODEL.LOSS.FOCAL_GAMMA

    def __call__(self, outputs, labels, masks, graph=None):
        heatmap_total, ae_total = self._heatmap_ae(outputs, labels, masks)
        edge_total = _focal_edges(outputs, labels, masks, self.alpha, self.gamma)
        class_total = _class_ce(outputs, labels, masks["class"])
        total = (edge_total * self.loss_weights[0] + heatmap_total + ae_total
                 + class_total * self.loss_weights[1])
        return total, {"heatmap": heatmap_total, "tag_loss": ae_total, "edge": edge_total,
                       "class_loss": class_total, "loss": total}


class TagMultiLossFactory(_HeatmapAE):
    """heatmap + tag-map AE + focal node + per-node tag AE + class, the
    tag-regression MPN's loss (``tag_loss``); ``LOSS_WEIGHTS`` [node, tag]
    or [node, tag, class]. reference: loss.py:322-432;
    pemp_tpu/losses/factories.py:415-482. The class loss's mask is the
    node labels, as the reference's (:420)."""

    def __init__(self, config):
        self._init_heatmap_ae(config)
        self.loss_weights = list(config.MODEL.LOSS.LOSS_WEIGHTS)
        if len(self.loss_weights) not in (2, 3):
            raise ValueError(f"MODEL.LOSS.LOSS_WEIGHTS={self.loss_weights}: [node, tag] or "
                             f"[node, tag, class]")
        if not config.MODEL.LOSS.NODE_USE_FOCAL:
            # the reference raises otherwise (loss.py:355-358)
            raise NotImplementedError("MODEL.LOSS.NODE_USE_FOCAL=False with the tag loss")
        self.alpha = config.MODEL.LOSS.FOCAL_ALPHA
        self.gamma = config.MODEL.LOSS.FOCAL_GAMMA

    def __call__(self, outputs, labels, masks, graph=None):
        heatmap_total, ae_total = self._heatmap_ae(outputs, labels, masks)
        _require_node_head(outputs, "TagMultiLossFactory")
        node_total = 0.0
        for p in outputs["node"]:
            node_total = node_total + focal_loss(p, labels["node"], masks["node"], self.alpha,
                                                 self.gamma)
        node_total = node_total / max(len(outputs["node"]), 1)
        sel = _positive_nodes(labels, masks)
        tag_total = 0.0
        for t in outputs["tag"]:
            if t is not None:
                tag_total = tag_total + _node_tag_loss(t, labels, sel, self.max_people,
                                                       self.ae_loss_type)
        class_total = _class_ce(outputs, labels, labels["node"])
        logging = {"heatmap": heatmap_total, "tag_loss": ae_total, "tag": tag_total,
                   "node": node_total, "class_loss": class_total}
        if len(self.loss_weights) == 3:
            class_total = class_total * self.loss_weights[2]
        total = (self.loss_weights[0] * node_total + tag_total * self.loss_weights[1]
                 + heatmap_total + ae_total + class_total)
        logging["loss"] = total
        return total, logging


class PureTagMultiLossFactory(_HeatmapAE):
    """heatmap + tag-map AE + the per-node tag AE alone (``pure_tag_loss``,
    and the list ``[heatmap, tag]``), weighted by ``TAG_WEIGHT``. reference:
    loss.py:434-536; pemp_tpu/losses/factories.py:485-548. With
    ``SYNC_TAGS`` the first stage's tag map, resized bilinearly to the
    second stage's size as ``jax.image.resize`` resizes (half-pixel
    centres, antialiased when it shrinks), is sampled at the graph's
    detections and pooled with the MPN's tags per person."""

    def __init__(self, config):
        self._init_heatmap_ae(config)
        self.sync_tags = bool(config.MODEL.LOSS.SYNC_TAGS)
        self.loss_weight = config.MODEL.LOSS.TAG_WEIGHT

    def __call__(self, outputs, labels, masks, graph=None):
        heatmap_total, ae_total = self._heatmap_ae(outputs, labels, masks)
        sel = _positive_nodes(labels, masks)
        person, batch_index = labels["person"], labels["batch_index"]
        preds = list(outputs["tag"])
        sel_all, person_all, batch_all = sel, person, batch_index
        if self.sync_tags:
            if len(preds) != 1 or graph is None:
                raise ValueError("SYNC_TAGS needs one tag output and the graph")
            from pemp_tpu_torch.tta.multi_scale import resize_bilinear

            hm0 = outputs["heatmap"][0][..., self.num_joints:]
            th, tw = outputs["heatmap"][1].shape[1:3]
            hm0 = resize_bilinear(hm0, th, tw)
            det = graph["nodes"].long()
            ht = hm0[batch_index.long(), det[:, 1].clamp(0, th - 1),
                     det[:, 0].clamp(0, tw - 1), det[:, 2].clamp(0, hm0.shape[-1] - 1)]
            preds[-1] = torch.cat([preds[-1], ht])
            sel_all = torch.cat([sel, sel])
            person_all = torch.cat([person, person])
            batch_all = torch.cat([batch_index, batch_index])
        tag_total = 0.0
        for t in preds:
            if t is not None:
                tag_total = tag_total + _node_tag_loss(
                    t, labels, sel, self.max_people, self.ae_loss_type, tags_sel=sel_all,
                    person=person_all, batch_index=batch_all)
        total = tag_total * self.loss_weight + heatmap_total + ae_total
        return total, {"heatmap": heatmap_total, "tag_loss": ae_total, "tag": tag_total,
                       "loss": total}


class MPNLossFactory:
    """Edge-only focal loss, the mean over the steps' edge logits
    (pemp_tpu.losses.factories.MPNLossFactory; reference loss.py:761-783)."""

    def __init__(self, config):
        if not config.MODEL.LOSS.USE_FOCAL:
            raise NotImplementedError("MODEL.LOSS.USE_FOCAL=False with the edge-only loss")
        self.alpha = config.MODEL.LOSS.FOCAL_ALPHA
        self.gamma = config.MODEL.LOSS.FOCAL_GAMMA

    def __call__(self, outputs, labels, masks, graph=None):
        preds = outputs["edge"]
        total = 0.0
        for i, p in enumerate(preds):
            total = total + focal_loss(p, _per_step(labels["edge"], i),
                                       _per_step(masks["edge"], i), self.alpha, self.gamma)
        total = total / max(len(preds), 1)
        return total, {"loss": total}


class ClassMPNLossFactory:
    """node + edge + class with ``LOSS_WEIGHTS`` [node, edge] or [node,
    edge, class] (the legacy ``node_edge_loss``). reference: loss.py:785-862;
    pemp_tpu/losses/factories.py:570-617."""

    def __init__(self, config):
        self.loss_weights = list(config.MODEL.LOSS.LOSS_WEIGHTS)
        if len(self.loss_weights) not in (2, 3):
            raise ValueError(f"MODEL.LOSS.LOSS_WEIGHTS={self.loss_weights}: [node, edge] or "
                             f"[node, edge, class]")
        loss = config.MODEL.LOSS
        self.alpha = loss.FOCAL_ALPHA
        self.gamma = loss.FOCAL_GAMMA
        self.node_use_focal = loss.NODE_USE_FOCAL
        self.node_pos_weight = loss.NODE_BCE_POS_WEIGHT

    def __call__(self, outputs, labels, masks, graph=None):
        _require_node_head(outputs, "ClassMPNLossFactory")
        node_total = 0.0
        for p in outputs["node"]:
            if self.node_use_focal:
                node_total = node_total + focal_loss(p, labels["node"], masks["node"],
                                                     self.alpha, self.gamma)
            else:
                node_total = node_total + bce_loss_with_logits(
                    p, labels["node"], masks["node"], self.node_pos_weight)
        node_total = node_total / max(len(outputs["node"]), 1)
        edge_total = _focal_edges(outputs, labels, masks, self.alpha, self.gamma)
        class_total = _class_ce(outputs, labels, masks["class"])
        if len(self.loss_weights) == 3:
            class_total = class_total * self.loss_weights[2]
        total = (self.loss_weights[0] * node_total + self.loss_weights[1] * edge_total
                 + class_total)
        return total, {"node": node_total, "edge": edge_total, "class_loss": class_total,
                       "loss": total}


class MultiLossFactory:
    """The edge + heatmap list of the older configs: the edge-only loss, as
    in the JAX package (pemp_tpu.losses.factories.MultiLossFactory; reference
    loss.py:162-215)."""

    def __init__(self, config):
        self.inner = MPNLossFactory(config)

    def __call__(self, outputs, labels, masks, graph=None):
        return self.inner(outputs, labels, masks)


# the legacy string names of MODEL.LOSS.NAME (pemp_tpu/losses/factories.py:
# 639-645)
_BY_NAME = {"edge_loss": MPNLossFactory, "node_edge_loss": ClassMPNLossFactory,
            "node_with_background_edge_loss": BackgroundClassMultiLossFactory,
            "tag_loss": TagMultiLossFactory, "pure_tag_loss": PureTagMultiLossFactory}


def dispatch_loss_func(config):
    """The loss factory ``MODEL.LOSS.NAME`` selects (reference:
    src/train.py:186-204; pemp_tpu/losses/factories.py:630-657): a plain
    string through the legacy table (:data:`_BY_NAME`); a list holding
    ``node`` to ClassMultiLossFactory, ``{heatmap, tag}`` to
    PureTagMultiLossFactory, ``{edge, heatmap}`` to MultiLossFactory,
    ``{edge}`` (or ``{edge_loss}``) to MPNLossFactory. Any other name raises
    ``NotImplementedError``, as in the JAX package."""
    name = config.MODEL.LOSS.NAME
    if isinstance(name, str):
        if name not in _BY_NAME:
            raise NotImplementedError(f"MODEL.LOSS.NAME={name!r}: the legacy names are "
                                      f"{sorted(_BY_NAME)}")
        return _BY_NAME[name](config)
    losses = set(name)
    if "node" in losses:
        return ClassMultiLossFactory(config)
    if losses == {"heatmap", "tag"}:
        return PureTagMultiLossFactory(config)
    if losses == {"edge", "heatmap"}:
        return MultiLossFactory(config)
    if losses in ({"edge"}, {"edge_loss"}):
        return MPNLossFactory(config)
    raise NotImplementedError(f"MODEL.LOSS.NAME={sorted(losses)}: the JAX package has the lists "
                              f"with 'node', [heatmap, tag], [edge, heatmap] and [edge]")
