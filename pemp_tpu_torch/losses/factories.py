"""Losses of the training path (counterpart of pemp_tpu.losses.factories;
reference: src/Utils/loss.py).

All losses take explicit masks, which also carry node and edge validity,
so padding is inert. Ported: ``ClassMultiLossFactory`` (the flagship) with
the edge, node, class and heatmap losses and the associative-embedding
loss on the tag maps (``tagmap``; the per-node ``tag_loss`` term, which
needs the MPN zoo's tag outputs, is refused), and the edge-only factories
``MPNLossFactory`` and ``MultiLossFactory``. ``dispatch_loss_func`` routes
to them as the JAX package does; ``ClassMPNLossFactory`` (the legacy
``node_edge_loss``), which no file of configs/ selects, and the background
and tag factories wait.
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


def _per_step(x, i):
    """A per-step list's entry ``i``, or ``x`` itself when it is one tensor."""
    return x[i] if isinstance(x, (list, tuple)) else x


class MPNLossFactory:
    """Edge-only focal loss, the mean over the steps' edge logits
    (pemp_tpu.losses.factories.MPNLossFactory; reference loss.py:761-783)."""

    def __init__(self, config):
        if not config.MODEL.LOSS.USE_FOCAL:
            raise NotImplementedError("MODEL.LOSS.USE_FOCAL=False with the edge-only loss")
        self.alpha = config.MODEL.LOSS.FOCAL_ALPHA
        self.gamma = config.MODEL.LOSS.FOCAL_GAMMA

    def __call__(self, outputs, labels, masks):
        preds = outputs["edge"]
        total = 0.0
        for i, p in enumerate(preds):
            total = total + focal_loss(p, _per_step(labels["edge"], i),
                                       _per_step(masks["edge"], i), self.alpha, self.gamma)
        total = total / max(len(preds), 1)
        return total, {"loss": total}


class MultiLossFactory:
    """The edge + heatmap list of the older configs: the edge-only loss, as
    in the JAX package (pemp_tpu.losses.factories.MultiLossFactory; reference
    loss.py:162-215)."""

    def __init__(self, config):
        self.inner = MPNLossFactory(config)

    def __call__(self, outputs, labels, masks):
        return self.inner(outputs, labels, masks)


# the legacy string names of MODEL.LOSS.NAME (pemp_tpu/losses/factories.py:
# 639-645); None: a factory not ported (no file of configs/ names one)
_BY_NAME = {"edge_loss": MPNLossFactory, "node_edge_loss": None,
            "node_with_background_edge_loss": None, "tag_loss": None, "pure_tag_loss": None}


def dispatch_loss_func(config):
    """The loss factory ``MODEL.LOSS.NAME`` selects (reference:
    src/train.py:186-204; pemp_tpu/losses/factories.py:630-657): a plain
    string through the legacy table; a list holding ``node`` to
    ClassMultiLossFactory, ``{edge, heatmap}`` to MultiLossFactory,
    ``{edge}`` (or ``{edge_loss}``) to MPNLossFactory. The other legacy
    factories (``node_edge_loss``, ``node_with_background_edge_loss``,
    ``tag_loss``, ``pure_tag_loss``) and ``{heatmap, tag}`` raise
    ``NotImplementedError``, as does any other name."""
    name = config.MODEL.LOSS.NAME
    if isinstance(name, str):
        factory = _BY_NAME.get(name)
        if factory is None:
            have = sorted(k for k, v in _BY_NAME.items() if v)
            raise NotImplementedError(f"MODEL.LOSS.NAME={name!r}: the port has {have}; the "
                                      f"background and tag losses wait for the MPN zoo, "
                                      f"node_edge_loss for a configuration that selects it")
        return factory(config)
    losses = set(name)
    if "node" in losses:
        return ClassMultiLossFactory(config)
    if losses == {"edge", "heatmap"}:
        return MultiLossFactory(config)
    if losses in ({"edge"}, {"edge_loss"}):
        return MPNLossFactory(config)
    raise NotImplementedError(f"MODEL.LOSS.NAME={sorted(losses)}: the port has the lists with "
                              f"'node', [edge, heatmap] and [edge]; the tag losses wait for the "
                              f"MPN zoo")
