"""Losses of the training path (counterpart of pemp_tpu.losses.factories;
reference: src/Utils/loss.py).

All losses take explicit masks, which also carry node and edge validity,
so padding is inert. Only the flagship factory is ported:
``ClassMultiLossFactory`` with the edge, node, class and heatmap losses
(the associative-embedding ``tagmap`` and per-node ``tag_loss`` terms are
refused), and ``dispatch_loss_func`` routes to it alone.
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
    """Flagship multi-loss: heatmap + node + edge + class. reference:
    loss.py:539-758. Stateless; settings from the config tree."""

    def __init__(self, config):
        losses = set(config.MODEL.LOSS.NAME)
        refused = losses & {"tagmap", "tag_loss"}
        if refused:
            raise NotImplementedError(
                f"MODEL.LOSS.NAME {sorted(refused)}: the port has no tag losses")
        self.num_joints = config.MODEL.HRNET.NUM_JOINTS
        self.with_heatmap = "heatmap" in losses
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
        self.with_heatmaps_loss = tuple(config.MODEL.HRNET.LOSS.WITH_HEATMAPS_LOSS)
        self.heatmaps_loss_factor = tuple(config.MODEL.HRNET.LOSS.HEATMAPS_LOSS_FACTOR)

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
