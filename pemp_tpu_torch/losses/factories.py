"""Losses of the training path (counterpart of pemp_tpu.losses.factories;
reference: src/Utils/loss.py).

All losses take explicit masks, which also carry node and edge validity,
so padding is inert. Only the flagship factory is ported:
``ClassMultiLossFactory`` with the edge, node, class and heatmap losses and
the associative-embedding loss on the tag maps (``tagmap``; the per-node
``tag_loss`` term, which needs the MPN zoo's tag outputs, is refused), and
``dispatch_loss_func`` routes to it alone.
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


class ClassMultiLossFactory:
    """Flagship multi-loss: heatmap + tag-map AE + node + edge + class.
    reference: loss.py:539-758. Stateless; settings from the config tree."""

    def __init__(self, config):
        losses = set(config.MODEL.LOSS.NAME)
        if "tag_loss" in losses:
            raise NotImplementedError(
                "MODEL.LOSS.NAME ['tag_loss']: the per-node tag loss needs the MPN zoo's tag "
                "outputs, which the port does not have")
        self.num_joints = config.MODEL.HRNET.NUM_JOINTS
        self.with_heatmap = "heatmap" in losses
        self.with_tagmap = "tagmap" in losses
        self.with_edge = "edge" in losses
        self.with_node = "node" in losses
        self.with_class = "class" in losses
        loss = config.MODEL.LOSS
        self.edge_weight = loss.EDGE_WEIGHT
        self.node_weight = loss.NODE_WEIGHT
        self.class_weight = loss.CLASS_WEIGHT
        self.alpha = loss.FOCAL_ALPHA
        self.gamma = loss.FOCAL_GAMMA
        self.use_focal = loss.USE_FOCAL
        self.edge_pos_weight = loss.EDGE_BCE_POS_WEIGHT
        if self.with_node and not loss.NODE_USE_FOCAL:
            # the reference raises for a non-focal node loss here too
            # (loss.py:618-621)
            raise NotImplementedError("MODEL.LOSS.NODE_USE_FOCAL=False")
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

    def __call__(self, outputs, labels, masks):
        """Returns (total loss, {part name: loss})."""
        logging = {}
        total = 0.0

        heatmap_total = 0.0
        if self.with_heatmap:
            for idx, pred in enumerate(outputs["heatmap"]):
                if idx < len(self.with_heatmaps_loss) and self.with_heatmaps_loss[idx]:
                    hl = heatmap_loss(pred[..., :self.num_joints], labels["heatmap"][idx],
                                      masks["heatmap"][idx])
                    heatmap_total = heatmap_total + hl.mean() * self.heatmaps_loss_factor[idx]
        total = total + heatmap_total
        logging["heatmap"] = heatmap_total

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
        total = total + ae_total
        logging["tag_loss"] = ae_total

        node_total = 0.0
        if self.with_node:
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
            preds = outputs["class"]
            for p in preds:
                class_total = class_total + cross_entropy_with_logits(
                    p, labels["class"], masks["class"])
            class_total = class_total / max(len(preds), 1)
        class_total = class_total * self.class_weight
        total = total + class_total
        logging["class_loss"] = class_total

        logging["loss"] = total
        return total, logging


def dispatch_loss_func(config):
    """reference: src/train.py:186-204. Of the JAX package's routes
    (pemp_tpu/losses/factories.py:630-657) only the flagship one is ported:
    a loss list holding ``node`` goes to ClassMultiLossFactory."""
    name = config.MODEL.LOSS.NAME
    if not isinstance(name, str) and "node" in set(name):
        return ClassMultiLossFactory(config)
    raise NotImplementedError(f"MODEL.LOSS.NAME={name!r}: only the flagship multi-loss "
                              "(a list with 'node') is ported")
