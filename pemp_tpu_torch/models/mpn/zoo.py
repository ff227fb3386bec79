"""The research zoo's MPNs (counterpart of pemp_tpu.models.mpn.zoo but
MPNTag, which models.py holds): the reference's ablation architectures that
do not reduce to the flagship.

* on the flagship's shared layer (the per-type layer with ``AGGR_TYPE:
  per_type``, MPLayer with ``agnostic``), so on its routes:
  ``NodeClassificationMPNTypeBased`` (a per-type node embedding),
  ``NodeClassificationMPNFPConstrained`` (edge logits less the endpoints'
  false-positive probabilities), ``NodeClassificationMPNTypeConstrained``
  (edge scores softmax-normalised per target and source class),
  ``NodeClassificationMPNSimpleWithRef`` (the edge head's trunk fed into a
  node stack), ``ClassificationMPNSimple`` and ``ClassificationMPNSimple2``
  (the node head after ``STEPS``, the edge head after ``EDGE_STEPS`` more);
* on MPLayer whatever ``AGGR_TYPE`` says, the ``agnostic`` route (no
  kernel: the JAX package computes these in plain XLA):
  ``ClassificationMPN`` (node passes, then grouping passes on the
  true-positive subgraph), ``NodeClassificationMPNAttention`` (the class
  softmax re-mixes a per-type embedding bank into the skip input),
  ``NodeClassificationMPNSelfAttention`` (attention from the nodes into
  the feature map each step);
* ``VanillaMPN2``: a layer of its own each step (Linear, ReLU, BatchNorm
  over the valid edges), kernel-free.

Every model runs its step stacks through models._Steps (one ``_stepper``
a stack), takes the forward arguments of models.NodeClassificationMPN
plus ``node_labels``, ``feature_maps`` and ``batch_index``, and returns
the heads the JAX model returns (``[None]`` or ``None`` for the others).
Module names are the reference's ``state_dict`` keys as
pemp_tpu/train/convert.py spells them (``mpn_node_cls``, ``mpn_grouping``,
``mpn_edge_cls``, ``edge_out``, ``edge_const_emb``, ``key_transform``,
``mpn.{i}``); the node-embedding bank, which no converter maps, keeps one
MLP a type under ``node_embedding.{t}``.
"""

from __future__ import annotations

import torch
from torch import nn

from pemp_tpu_torch.models.mpn.layers import (
    MLP,
    Linear,
    MaskedBatchNorm,
    MPLayer,
    TypeAwareMPNLayer,
    _aggregate,
    _split_edge_mlp,
    _targets_part,
)
from pemp_tpu_torch.models.mpn.models import (
    _embeddings,
    _mp_layer,
    _shared_layer,
    _Steps,
    edge_width,
)
from pemp_tpu_torch.ops.segment import segment_max, segment_sum

# the width of SelfAttention's keys, queries and values (reference
# NodeClassificationMPNSelftAttention.py)
_ATTN = 16


def _node_end(c: dict) -> bool:
    return c["NODE_EMB"].get("END_WITH_RELU", False)


def _head(c: dict, key: str, in_dim: int | None = None):
    """The MLP head ``key`` (``EDGE_CLASS``, ``NODE_CLASS``, ``CLASS``) on
    the node or edge features, with ``MPN.BN``."""
    if in_dim is None:
        in_dim = edge_width(c) if key == "EDGE_CLASS" else c["NODE_FEATURE_DIM"]
    return MLP(in_dim, c[key]["OUTPUT_SIZES"], c["BN"])


class _Zoo(_Steps):
    """The forward prologue the zoo shares: route, its loop-invariant
    columns and both embeddings."""

    def _begin(self, route, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
               node_valid, node_types):
        route = self._route(route)
        pre = self._pre(route, x, edge_index, edge_valid, edge_src_local, node_types)
        edges = self.edge_embedding(edge_attr.to(dtype), edge_valid)
        return route, pre, self.node_embedding(x.to(dtype), node_valid), edges


class _NodeMlpBank(nn.ModuleList):
    """One node-embedding MLP a joint type (reference
    NodeClassificationMPNAttention.py:10-25): (N, F) -> (N, T, D)."""

    def __init__(self, in_dim: int, dims, bn: bool, end_with_relu: bool, num_types: int):
        super().__init__(MLP(in_dim, dims, bn, end_with_relu) for _ in range(num_types))

    def forward(self, x, valid=None):
        return torch.stack([mlp(x, valid) for mlp in self], dim=1)


def _bank(c: dict, end_with_relu: bool):
    e = c["NODE_EMB"]
    return _NodeMlpBank(c["NODE_INPUT_DIM"], e["OUTPUT_SIZES"], e["BN"], end_with_relu,
                        c["NUM_JOINTS"])


def _typed_rows(bank, node_types):
    """Each node's row of its own type in the bank (N, T, D) -> (N, D)."""
    return bank[torch.arange(bank.shape[0], device=bank.device), node_types.long()]


class ClassificationMPN(_Zoo):
    """Two phases on two MPLayers (pemp_tpu.models.mpn.zoo.ClassificationMPN;
    reference ClassificationMPN.py:53-111): ``STEPS_NODE`` (``STEPS`` when
    absent) passes of ``mpn_node_cls``, the node head; then the subgraph
    of true positives (sigmoid above 0.5, or labelled 1 in training)
    becomes the edge-validity mask of ``STEPS_GROUP`` passes of
    ``mpn_grouping``, and the edge head. Embeddings with ``MPN.BN`` and the
    node embedding's END_WITH_RELU; class ``None``."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup(mpn_cfg)
        c = self.cfg
        self.node_embedding, self.edge_embedding = _embeddings(c, c["BN"], _node_end(c))
        self.mpn_node_cls = _mp_layer(c)
        if c.get("STEPS_GROUP", 0):
            self.mpn_grouping = _mp_layer(c)
        self.node_classification = _head(c, "NODE_CLASS")
        self.edge_classification = _head(c, "EDGE_CLASS")

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                node_labels=None, feature_maps=None, batch_index=None):
        """As NodeClassificationMPN.forward; ``node_labels`` (N,) join the
        true positives in training."""
        c = self.cfg
        route, pre, nodes, edges = self._begin(route, x, edge_attr, edge_index, edge_valid,
                                               edge_src_local, dtype, node_valid, node_types)
        init_nodes, init_edges = nodes, edges
        step = self._stepper(self.mpn_node_cls, route, init_nodes, init_edges, dtype)
        for _ in range(c.get("STEPS_NODE", c["STEPS"])):
            nodes, edges = step(nodes, edges, pre)
        node = self.node_classification(nodes, node_valid)[..., 0]
        tp = torch.sigmoid(node) > 0.5
        if self.training and node_labels is not None:
            tp = tp | (node_labels == 1.0)
        sub = edge_valid.bool() & tp[edge_index[0].long()] & tp[edge_index[1].long()]
        if c.get("STEPS_GROUP", 0):
            step = self._stepper(self.mpn_grouping, route, init_nodes, init_edges, dtype)
            pre_group = {**pre, "valid": sub}
            for _ in range(c["STEPS_GROUP"]):
                nodes, edges = step(nodes, edges, pre_group)
        return {"edge": [self.edge_classification(edges, edge_valid)[..., 0]], "node": [node],
                "class": None, "tag": [None]}


class NodeClassificationMPNSelfAttention(_Zoo):
    """Each step adds spatial attention to the node features
    (pemp_tpu.models.mpn.zoo.NodeClassificationMPNSelfAttention; reference
    NodeClassificationMPNSelftAttention.py:64-141): a 16-wide key per node
    (``key_transform``) against queries and values of the image's feature
    map (``query_transform``, ``value_transform``), its softmax over the
    map's pixels, the values' weighted sum concatenated to the nodes, then
    a pass of MPLayer ``mpn_node_cls``. The JAX package maps the images one
    at a time; here it is one batched product, in plain PyTorch, as the
    JAX package computes it outside any kernel."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup(mpn_cfg)
        c = self.cfg
        nd, ed = c["NODE_FEATURE_DIM"], edge_width(c)
        self.node_embedding, self.edge_embedding = _embeddings(c, None, _node_end(c))
        node_in, edge_in = nd + _ATTN, ed
        if c["SKIP"]:
            node_in += c["NODE_EMB"]["OUTPUT_SIZES"][-1]
            edge_in += c["EDGE_EMB"]["OUTPUT_SIZES"][-1]
        # the JAX model builds it without the node update MLP (zoo.py:167-170)
        self.mpn_node_cls = MPLayer(node_in, edge_in, nd, c["EDGE_FEATURE_DIM"],
                                    c["EDGE_FEATURE_HIDDEN"], c["AGGR"],
                                    edge_mlp=c.get("EDGE_MLP", "agnostic"),
                                    num_types=c["NUM_JOINTS"])
        self.key_transform = Linear(nd, _ATTN)
        self.query_transform = Linear(c["NODE_INPUT_DIM"], _ATTN)
        self.value_transform = Linear(c["NODE_INPUT_DIM"], _ATTN)
        self.edge_classification = _head(c, "EDGE_CLASS")
        self.node_classification = _head(c, "NODE_CLASS")
        self.classification = _head(c, "CLASS")

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                node_labels=None, feature_maps=None, batch_index=None):
        """As NodeClassificationMPN.forward; ``feature_maps`` (B, H, W,
        NODE_INPUT_DIM) the graph's feature map (the ``feature_gather``
        output), its images' nodes in order, the same number an image."""
        if feature_maps is None:
            raise ValueError("NodeClassificationMPNSelfAttention needs the feature maps")
        c = self.cfg
        route, pre, nodes, edges = self._begin(route, x, edge_attr, edge_index, edge_valid,
                                               edge_src_local, dtype, node_valid, node_types)
        b = feature_maps.shape[0]
        fm = feature_maps.to(dtype).reshape(b, -1, feature_maps.shape[-1])
        queries = self.query_transform(fm).transpose(1, 2)          # (B, 16, HW)
        values = self.value_transform(fm)                           # (B, HW, 16)

        def attend(nodes):
            keys = self.key_transform(nodes).reshape(b, -1, _ATTN)  # (B, n, 16)
            weights = torch.softmax(torch.bmm(keys, queries), dim=-1)
            return torch.bmm(weights, values).reshape(-1, _ATTN)

        step = self._stepper(self.mpn_node_cls, route, nodes, edges, dtype)
        for _ in range(c["STEPS"]):
            nodes, edges = step(torch.cat([nodes, attend(nodes)], dim=-1), edges, pre)
        return {"edge": [self.edge_classification(edges, edge_valid)[..., 0]],
                "node": [self.node_classification(nodes, node_valid)[..., 0]],
                "class": [self.classification(nodes, node_valid)], "tag": [None]}


class NodeClassificationMPNAttention(_Zoo):
    """The class softmax re-mixes a per-type embedding bank
    (pemp_tpu.models.mpn.zoo.NodeClassificationMPNAttention; reference
    NodeClassificationMPNAttention.py:27-86): the nodes start from their
    own type's row of the bank; after each of ``STEPS`` passes of MPLayer
    ``mpn_node_cls`` the class head runs and its softmax over the types
    weighs the bank into the next pass's skip input. The edge head after
    those, then ``NODE_STEPS`` more passes and the node head. Returns the
    class head of every step. The edge embedding takes ``EDGE_EMB``'s BN and
    ``NODE_EMB``'s END_WITH_RELU."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup(mpn_cfg)
        c = self.cfg
        self.node_embedding = _bank(c, _node_end(c))
        self.edge_embedding = _embeddings(c, None, _node_end(c))[1]
        self.mpn_node_cls = _mp_layer(c)
        self.edge_classification = _head(c, "EDGE_CLASS")
        self.node_classification = _head(c, "NODE_CLASS")
        self.classification = _head(c, "CLASS")

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                node_labels=None, feature_maps=None, batch_index=None):
        """As NodeClassificationMPN.forward; ``node_types`` (N,) pick each
        node's row of the bank."""
        c = self.cfg
        route, pre, bank, edges = self._begin(route, x, edge_attr, edge_index, edge_valid,
                                              edge_src_local, dtype, node_valid, node_types)
        nodes = _typed_rows(bank, node_types)
        init_nodes, init_edges = nodes, edges
        classes = []
        for _ in range(c["STEPS"]):
            step = self._stepper(self.mpn_node_cls, route, init_nodes, init_edges, dtype)
            nodes, edges = step(nodes, edges, pre)
            classes.append(self.classification(nodes, node_valid))
            init_nodes = (bank * torch.softmax(classes[-1], dim=1)[:, :, None]).sum(dim=1)
        edge = self.edge_classification(edges, edge_valid)[..., 0]
        step = self._stepper(self.mpn_node_cls, route, init_nodes, init_edges, dtype)
        for _ in range(c.get("NODE_STEPS", 0)):
            nodes, edges = step(nodes, edges, pre)
        return {"edge": [edge], "node": [self.node_classification(nodes, node_valid)[..., 0]],
                "class": classes, "tag": [None]}


class _HeadsAfterSteps(_Zoo):
    """``STEPS`` passes of the shared layer ``mpn_node_cls``, then the edge,
    node and class heads on the final features (the TypeBased,
    FPConstrained and TypeConstrained models)."""

    def _build(self, node_embedding, edge_embedding):
        c = self.cfg
        self.node_embedding, self.edge_embedding = node_embedding, edge_embedding
        self.mpn_node_cls = _shared_layer(c, self.num_types)
        self.edge_classification = _head(c, "EDGE_CLASS")
        self.node_classification = _head(c, "NODE_CLASS")
        self.classification = _head(c, "CLASS")

    def _steps(self, route, pre, nodes, edges, dtype, node_valid, edge_valid):
        """(final nodes, node logits, class logits, edge logits)."""
        step = self._stepper(self.mpn_node_cls, route, nodes, edges, dtype)
        for _ in range(self.cfg["STEPS"]):
            nodes, edges = step(nodes, edges, pre)
        return (nodes, self.node_classification(nodes, node_valid)[..., 0],
                self.classification(nodes, node_valid),
                self.edge_classification(edges, edge_valid)[..., 0])


class NodeClassificationMPNTypeBased(_HeadsAfterSteps):
    """A per-type node embedding
    (pemp_tpu.models.mpn.zoo.NodeClassificationMPNTypeBased; reference
    NodeClassificationMPNTypeBased.py): each node takes its own type's MLP
    of the bank, then the flagship's steps and heads. As the JAX model, the
    layer has ``NUM_JOINTS`` types and reads the raw types whatever
    ``NODE_TYPE_SUMMARY`` says."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup({**mpn_cfg, "NODE_TYPE_SUMMARY": "not"})
        c = self.cfg
        self._build(_bank(c, _node_end(c)), _embeddings(c)[1])

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                node_labels=None, feature_maps=None, batch_index=None):
        """As NodeClassificationMPN.forward; ``node_types`` (N,) pick each
        node's embedding."""
        route, pre, bank, edges = self._begin(route, x, edge_attr, edge_index, edge_valid,
                                              edge_src_local, dtype, node_valid, node_types)
        _, node, cls, edge = self._steps(route, pre, _typed_rows(bank, node_types), edges,
                                         dtype, node_valid, edge_valid)
        return {"edge": [edge], "node": [node], "class": [cls], "tag": [None]}


class NodeClassificationMPNFPConstrained(_HeadsAfterSteps):
    """Edge logits less the endpoints' false-positive probabilities,
    ``edge - (1 - p_src) - (1 - p_dst)`` with p the node head's sigmoid
    (pemp_tpu.models.mpn.zoo.NodeClassificationMPNFPConstrained; reference
    NodeClassificationMPNFPConstrained.py:50-72)."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup(mpn_cfg)
        self._build(*_embeddings(self.cfg))

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                node_labels=None, feature_maps=None, batch_index=None):
        """As NodeClassificationMPN.forward."""
        route, pre, nodes, edges = self._begin(route, x, edge_attr, edge_index, edge_valid,
                                               edge_src_local, dtype, node_valid, node_types)
        _, node, cls, edge = self._steps(route, pre, nodes, edges, dtype, node_valid,
                                         edge_valid)
        offset = 1.0 - torch.sigmoid(node)
        edge = edge - offset[edge_index[0].long()] - offset[edge_index[1].long()]
        return {"edge": [edge], "node": [node], "class": [cls], "tag": [None]}


class NodeClassificationMPNTypeConstrained(_HeadsAfterSteps):
    """Edge scores normalised per target and source class
    (pemp_tpu.models.mpn.zoo.NodeClassificationMPNTypeConstrained; reference
    NodeClassificationMPNTypeConstrained.py:41-82): the dot products of
    ``edge_const_emb``'s node embeddings at both ends, softmax over each
    target's valid in-edges whose sources share a class (the class head's
    argmax, no gradient), times the sigmoid of the edge logit. The edge
    outputs are probabilities, not logits: the decode and the losses take
    their sigmoid again, as in the JAX package."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup(mpn_cfg)
        self._build(*_embeddings(self.cfg))
        nd = self.cfg["NODE_FEATURE_DIM"]
        self.edge_const_emb = Linear(nd, nd)

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                node_labels=None, feature_maps=None, batch_index=None):
        """As NodeClassificationMPN.forward."""
        route, pre, nodes, edges = self._begin(route, x, edge_attr, edge_index, edge_valid,
                                               edge_src_local, dtype, node_valid, node_types)
        nodes, node, cls, edge_logit = self._steps(route, pre, nodes, edges, dtype,
                                                   node_valid, edge_valid)
        src, dst = edge_index[0].long(), edge_index[1].long()
        t = self.cfg["NUM_JOINTS"]
        src_cls = cls.detach().argmax(dim=-1)[src].clamp(0, t - 1)
        emb = self.edge_const_emb(nodes)
        scores = (emb[src] * emb[dst]).sum(dim=-1)
        # the masked softmax of the JAX package: invalid edges at -1e30, a
        # group with no valid edge shifted by 0, the sum floored at 1e-16
        ev = edge_valid.bool()
        seg, nseg = dst * t + src_cls, x.shape[0] * t
        shift = segment_max(scores, seg, nseg, ev).detach()[seg]
        e = torch.exp(torch.where(ev, scores, torch.full_like(scores, -1e30)) - shift) * ev
        edge = e / segment_sum(e, seg, nseg).clamp_min(1e-16)[seg]
        return {"edge": [edge * torch.sigmoid(edge_logit)], "node": [node], "class": [cls],
                "tag": [None]}


class NodeClassificationMPNSimpleWithRef(_Zoo):
    """The edge head's trunk fed back into a node stack
    (pemp_tpu.models.mpn.zoo.NodeClassificationMPNSimpleWithRef; reference
    NodeClassificationMPNSimpleWithRef.py:28-84): ``STEPS`` passes of
    ``mpn_edge_cls``; the edge head split into its trunk ``edge_out`` (all
    of ``EDGE_CLASS`` but the last layer, ending in ReLU) and the Linear
    ``edge_classification``; then ``NODE_STEPS`` passes of a second layer
    ``mpn_node_cls`` whose initial features are the first stack's final
    nodes and ``cat[trunk, final edges]`` (its ``init_edge_dim`` the trunk
    width plus the edge carry's), and the node and class heads.

    The node stack's carry starts as its initial edges, so its width
    changes after one pass: the JAX model fails at a second, and the port
    refuses ``NODE_STEPS`` above 1. On the fused step the carry's trunk
    columns, constant over that one pass, join the loop-invariant
    projection, so the kernel keeps its carry width."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup(mpn_cfg)
        c = self.cfg
        nd, ed = c["NODE_FEATURE_DIM"], edge_width(c)
        self.node_embedding, self.edge_embedding = _embeddings(c)
        self.mpn_edge_cls = _shared_layer(c, self.num_types)
        sizes = c["EDGE_CLASS"]["OUTPUT_SIZES"]
        self.edge_out = MLP(ed, sizes[:-1], c["BN"], end_with_relu=True)
        self.edge_classification = Linear(sizes[-2], sizes[-1])
        if c.get("NODE_STEPS", 0):
            init = sizes[-2] + ed
            node_in, edge_in = (2 * nd, 2 * init) if c["SKIP"] else (nd, init)
            edge_mlp = c.get("EDGE_MLP", "agnostic")
            if c["AGGR_TYPE"] == "agnostic":
                self.mpn_node_cls = MPLayer(
                    node_in, edge_in, nd, c["EDGE_FEATURE_DIM"], c["EDGE_FEATURE_HIDDEN"],
                    c["AGGR"], edge_mlp=edge_mlp, num_types=self.num_types,
                    use_node_update_mlp=c.get("USE_NODE_UPDATE_MLP", False))
            else:
                self.mpn_node_cls = TypeAwareMPNLayer(
                    node_in=node_in, edge_in=edge_in, init_edge_dim=init, node_dim=nd,
                    edge_dim=c["EDGE_FEATURE_DIM"], edge_hidden=c["EDGE_FEATURE_HIDDEN"],
                    num_types=self.num_types, edge_mlp=edge_mlp, aggr=c["AGGR"],
                    aggr_sub=c["AGGR_SUB"], update_type=c.get("UPDATE_TYPE", "mlp"))
        self.node_classification = _head(c, "NODE_CLASS")
        self.classification = _head(c, "CLASS")

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                node_labels=None, feature_maps=None, batch_index=None):
        """As NodeClassificationMPN.forward."""
        c = self.cfg
        route, pre, nodes, edges = self._begin(route, x, edge_attr, edge_index, edge_valid,
                                               edge_src_local, dtype, node_valid, node_types)
        step = self._stepper(self.mpn_edge_cls, route, nodes, edges, dtype)
        for _ in range(c["STEPS"]):
            nodes, edges = step(nodes, edges, pre)
        trunk = self.edge_out(edges, edge_valid)
        edge = self.edge_classification(trunk)[..., 0]
        if c.get("NODE_STEPS", 0):
            edges = torch.cat([trunk, edges], dim=-1)
            step = self._stepper(self.mpn_node_cls, route, nodes, edges, dtype, fixed=trunk)
            nodes, edges = step(nodes, edges, pre)
        return {"edge": [edge], "node": [self.node_classification(nodes, node_valid)[..., 0]],
                "class": [self.classification(nodes, node_valid)], "tag": [None]}


class ClassificationMPNSimple2(_Zoo):
    """One shared layer ``mpn_node_cls`` for ``STEPS`` passes, the node head,
    ``EDGE_STEPS`` more passes, the edge head
    (pemp_tpu.models.mpn.zoo.ClassificationMPNSimple2; reference
    ClassificationMPNSimple2.py:53-101). Class ``None``."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup(mpn_cfg)
        c = self.cfg
        self.node_embedding, self.edge_embedding = self._embeddings(c)
        self.mpn_node_cls = _shared_layer(c, self.num_types)
        self.node_classification = _head(c, "NODE_CLASS")
        self.edge_classification = _head(c, "EDGE_CLASS")

    @staticmethod
    def _embeddings(c):
        return _embeddings(c)

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                node_labels=None, feature_maps=None, batch_index=None):
        """As NodeClassificationMPN.forward."""
        c = self.cfg
        route, pre, nodes, edges = self._begin(route, x, edge_attr, edge_index, edge_valid,
                                               edge_src_local, dtype, node_valid, node_types)
        step = self._stepper(self.mpn_node_cls, route, nodes, edges, dtype)
        for _ in range(c["STEPS"]):
            nodes, edges = step(nodes, edges, pre)
        node = self.node_classification(nodes, node_valid)[..., 0]
        for _ in range(c.get("EDGE_STEPS", 0)):
            nodes, edges = step(nodes, edges, pre)
        return {"edge": [self.edge_classification(edges, edge_valid)[..., 0]], "node": [node],
                "class": None, "tag": [None]}


class ClassificationMPNSimple(ClassificationMPNSimple2):
    """ClassificationMPNSimple2 with the reference's edge embedding, which
    takes ``EDGE_EMB``'s BN and ``NODE_EMB``'s END_WITH_RELU
    (pemp_tpu.models.mpn.zoo.ClassificationMPNSimple; reference
    ClassificationMPNSimple.py:16-66). Its forward reads the raw types
    while its layer is sized by ``NODE_TYPE_SUMMARY``; the two agree only
    at ``not``, which every reference file sets, so the port refuses any
    other value (models._check_flagship)."""

    @staticmethod
    def _embeddings(c):
        return _embeddings(c, None, _node_end(c))


class _VanillaMPLayer2(nn.Module):
    """VanillaMPN2's layer (pemp_tpu.models.mpn.zoo._VanillaMPLayer2;
    reference VanillaMPN2.py:19-56): ``mlp_edge`` = Sequential(Linear,
    ReLU, BatchNorm) on [x_i, x_j, e], ``mlp_node`` the same on [x_i, e']
    for each message (its BatchNorm over the valid edges too), then
    ``aggr`` over each node's valid in-edges. Products with x_i and x_j
    are taken per node and gathered."""

    def __init__(self, node_in: int, edge_in: int, node_dim: int, edge_dim: int, aggr: str):
        super().__init__()
        self.aggr = aggr
        self.mlp_edge = nn.Sequential(Linear(2 * node_in + edge_in, edge_dim), nn.ReLU(),
                                      MaskedBatchNorm(edge_dim))
        self.mlp_node = nn.Sequential(Linear(node_in + edge_dim, node_dim), nn.ReLU(),
                                      MaskedBatchNorm(node_dim))

    def forward(self, x, edges, pre):
        """x (N, node_in), edges (E, edge_in), ``pre`` MPLayer's index
        columns. Returns (new nodes, new edges)."""
        h = torch.relu(_split_edge_mlp(self.mlp_edge[0], x, edges, pre))
        new_edge = self.mlp_edge[2](h, pre["valid"])
        lin = self.mlp_node[0]
        m = torch.relu(_targets_part(lin, x, pre) + new_edge @ lin.weight.to(x.dtype)[
            :, x.shape[1]:].t() + lin.bias.to(x.dtype))
        m = self.mlp_node[2](m, pre["valid"])
        return _aggregate(m, pre, x.shape[0], self.aggr), new_edge


class VanillaMPN2(_Zoo):
    """Edge classification with a layer of its own each step
    (pemp_tpu.models.mpn.zoo.VanillaMPN2; reference VanillaMPN2.py:58-93):
    embeddings with ``MPN.BN`` (each its own END_WITH_RELU), ``STEPS``
    layers ``mpn.{i}`` without skip connections, the edge head
    ``classification`` (``CLASS``, its last bias -2 at initialisation) on
    the last ``AUX_LOSS_STEPS + 1`` steps, in both modes. Node ``[None]``,
    class ``None``; the ``agnostic`` route (no kernel)."""

    def __init__(self, mpn_cfg: dict):
        super().__init__()
        self._setup(mpn_cfg)
        c = self.cfg
        self.node_embedding, self.edge_embedding = _embeddings(c, c["BN"])
        node_in, edge_in = c["NODE_EMB"]["OUTPUT_SIZES"][-1], c["EDGE_EMB"]["OUTPUT_SIZES"][-1]
        layers = []
        for _ in range(c["STEPS"]):
            layers.append(_VanillaMPLayer2(node_in, edge_in, c["NODE_FEATURE_DIM"],
                                           c["EDGE_FEATURE_DIM"], c["AGGR"]))
            node_in, edge_in = c["NODE_FEATURE_DIM"], c["EDGE_FEATURE_DIM"]
        self.mpn = nn.ModuleList(layers)
        self.classification = _head(c, "CLASS", c["EDGE_FEATURE_DIM"])
        nn.init.constant_(self.classification[-1].bias, -2.0)

    def forward(self, x, edge_attr, edge_index, edge_valid, edge_src_local, dtype,
                node_valid=None, route=None, node_types=None, joint_tags=None,
                node_labels=None, feature_maps=None, batch_index=None):
        """As VanillaMPN.forward."""
        c = self.cfg
        _, pre, nodes, edges = self._begin(route, x, edge_attr, edge_index, edge_valid,
                                           edge_src_local, dtype, node_valid, None)
        steps, preds = c["STEPS"], []
        for i, layer in enumerate(self.mpn):
            nodes, edges = layer(nodes, edges, pre)
            if i >= steps - c.get("AUX_LOSS_STEPS", 0) - 1:
                preds.append(self.classification(edges, edge_valid)[..., 0])
        return {"edge": preds, "node": [None], "class": None, "tag": [None]}


# the reference factory's names for these (MessagePassingNetwork/__init__.py:
# 27-73; pemp_tpu/models/mpn/models.py:520-540)
ZOO = {
    "ClassificationMPN": ClassificationMPN,
    "ClassificationMPNSimple": ClassificationMPNSimple,
    "ClassificationMPNSimple2": ClassificationMPNSimple2,
    "NodeClassificationMPNTypeBased": NodeClassificationMPNTypeBased,
    "NodeClassificationMPNAttention": NodeClassificationMPNAttention,
    "NodeClassificationMPNSelfAttention": NodeClassificationMPNSelfAttention,
    "NodeClassificationMPNWithRef": NodeClassificationMPNSimpleWithRef,
    "NodeClassificationMPNFPConstrained": NodeClassificationMPNFPConstrained,
    "NodeClassificationMPNTypeConstrained": NodeClassificationMPNTypeConstrained,
    "VanillaMPN2": VanillaMPN2,
}
