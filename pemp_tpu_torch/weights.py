"""Carries the JAX model's weights into the port.

:func:`from_jax_variables` takes the variables of a ``pemp_tpu``
composite model or AE-grouping model (``params`` and ``batch_stats`` as
nested dicts of numpy arrays) and returns a ``state_dict`` for
:class:`pemp_tpu_torch.models.pose_estimation.PoseEstimationBaseline` or
:class:`pemp_tpu_torch.models.ae_group.PoseEstimationAeGroup`.

The port's modules carry the original reference's ``state_dict`` names, so
this is the inverse of ``pemp_tpu.train.convert.convert_composite_state_dict``
and ``convert_hourglass_state_dict`` (their layout maps, inverted here):

  Conv2d        HWIO           -> OIHW
  ConvTranspose (k, k, out, in) -> (in, out, k, k)
  Linear        (in, out)       -> (out, in)
  BatchNorm     scale/bias + mean/var -> weight/bias/running_mean/running_var

and the fused MPN layer's stacked ``mlp_node`` kernel (T, din, dout) becomes
the reference's T separate Linears. The MPN is any of the port's
(models.mpn.models.MODELS), with a TypeAwareMPNLayer or an MPLayer.
"""

from __future__ import annotations

import numpy as np
import torch

from pemp_tpu_torch.models.hourglass import hg_spec
from pemp_tpu_torch.models.hrnet import HRNetSpec
from pemp_tpu_torch.models.mpn.models import mpn_cfg_from_config


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


class _Carrier:
    def __init__(self, params, stats):
        self.params, self.stats, self.sd = params, stats, {}

    def put(self, key, value):
        self.sd[key] = torch.from_numpy(np.array(value, copy=True))

    def conv(self, key, path, bias=False):
        k = _get(self.params, (*path, "kernel"))
        # HWIO -> OIHW; flax ConvTranspose (k,k,out,in) -> torch (in,out,k,k):
        # both are the same axis permutation
        self.put(f"{key}.weight", np.transpose(k, (3, 2, 0, 1)))
        if bias:
            self.put(f"{key}.bias", _get(self.params, (*path, "bias")))

    def linear(self, key, path):
        self.put(f"{key}.weight", _get(self.params, (*path, "kernel")).T)
        self.put(f"{key}.bias", _get(self.params, (*path, "bias")))

    def bn(self, key, path):
        self.put(f"{key}.weight", _get(self.params, (*path, "scale")))
        self.put(f"{key}.bias", _get(self.params, (*path, "bias")))
        self.put(f"{key}.running_mean", _get(self.stats, (*path, "mean")))
        self.put(f"{key}.running_var", _get(self.stats, (*path, "var")))
        self.sd[f"{key}.num_batches_tracked"] = torch.tensor(0)


def _block(cr, key, path, names, downsample):
    for i in names:
        cr.conv(f"{key}.conv{i}", (*path, f"conv{i}"))
        cr.bn(f"{key}.bn{i}", (*path, f"bn{i}"))
    if downsample:
        cr.conv(f"{key}.downsample.0", (*path, "downsample_conv"))
        cr.bn(f"{key}.downsample.1", (*path, "downsample_bn"))


def _hrnet(cr, spec: HRNetSpec, pre="backbone"):
    """Inverse of convert.convert_hrnet_state_dict (same walk)."""
    P = ("backbone",)
    for name in ("conv1", "conv2"):
        cr.conv(f"{pre}.{name}", (*P, name))
    for name in ("bn1", "bn2"):
        cr.bn(f"{pre}.{name}", (*P, name))
    for k in range(4):
        _block(cr, f"{pre}.layer1.{k}", (*P, f"layer1_{k}"), (1, 2, 3), k == 0)

    prev = [256]
    for si, (num_modules, num_branches, num_blocks, num_channels) in enumerate(spec.stages):
        t = si + 1
        for i in range(num_branches):
            if i < len(prev):
                if prev[i] != num_channels[i]:
                    cr.conv(f"{pre}.transition{t}.{i}.0", (*P, f"transition{t}_{i}_conv"))
                    cr.bn(f"{pre}.transition{t}.{i}.1", (*P, f"transition{t}_{i}_bn"))
            else:
                for j in range(i + 1 - len(prev)):
                    cr.conv(f"{pre}.transition{t}.{i}.{j}.0", (*P, f"transition{t}_{i}_{j}_conv"))
                    cr.bn(f"{pre}.transition{t}.{i}.{j}.1", (*P, f"transition{t}_{i}_{j}_bn"))
        for m in range(num_modules):
            key = f"{pre}.stage{si + 2}.{m}"
            path = (*P, f"stage{si + 2}_{m}")
            for i in range(num_branches):
                for k in range(num_blocks[i]):
                    _block(cr, f"{key}.branches.{i}.{k}", (*path, f"branches_{i}_{k}"),
                           (1, 2), False)
            last = si == len(spec.stages) - 1 and m == num_modules - 1
            for i in range(1 if last else num_branches):
                for j in range(num_branches):
                    if j > i:
                        cr.conv(f"{key}.fuse_layers.{i}.{j}.0", (*path, f"fuse_{i}_{j}_conv"))
                        cr.bn(f"{key}.fuse_layers.{i}.{j}.1", (*path, f"fuse_{i}_{j}_bn"))
                    elif j < i:
                        for k in range(i - j):
                            fk = f"{key}.fuse_layers.{i}.{j}.{k}"
                            cr.conv(f"{fk}.0", (*path, f"fuse_{i}_{j}_{k}_conv"))
                            cr.bn(f"{fk}.1", (*path, f"fuse_{i}_{j}_{k}_bn"))
        prev = list(num_channels)

    cr.conv(f"{pre}.final_layers.0", (*P, "final_layers_0"), bias=True)
    for i in range(spec.num_deconvs):
        cr.conv(f"{pre}.final_layers.{i + 1}", (*P, f"final_layers_{i + 1}"), bias=True)
        cr.conv(f"{pre}.deconv_layers.{i}.0.0", (*P, f"deconv_{i}_conv"))
        cr.bn(f"{pre}.deconv_layers.{i}.0.1", (*P, f"deconv_{i}_bn"))
        for k in range(spec.deconv_num_basic_blocks):
            _block(cr, f"{pre}.deconv_layers.{i}.{k + 1}.0", (*P, f"deconv_{i}_block{k}"),
                   (1, 2), False)


def _hourglass(cr, nstack, pre="backbone"):
    """Inverse of convert.convert_hourglass_state_dict (same walk, depth-4
    hourglasses): the flax ``ConvBnRelu`` scopes' ``conv`` onto the
    reference's ``Conv`` modules' ``conv``."""
    P = ("backbone",)

    def conv(key, name):
        cr.conv(f"{pre}.{key}.conv", (*P, *name, "conv"), bias=True)

    def block(key, path, n):
        for name in ("up1", "low1", "low3"):
            conv(f"{key}.{name}", (*path, name))
        if n > 1:
            block(f"{key}.low2", (*path, "low2"), n - 1)
        else:
            conv(f"{key}.low2", (*path, "low2"))

    for flax_i, torch_i in zip(range(4), (0, 1, 3, 4)):
        conv(f"pre.{torch_i}", (f"pre_{flax_i}",))
    for i in range(nstack):
        block(f"features.{i}.0", (f"hg_{i}",), 4)
        conv(f"features.{i}.1", (f"feat_{i}_0",))
        conv(f"features.{i}.2", (f"feat_{i}_1",))
        conv(f"outs.{i}", (f"outs_{i}",))
        if i != nstack - 1:
            conv(f"merge_preds.{i}.conv", (f"merge_preds_{i}",))
            conv(f"merge_features.{i}.conv", (f"merge_features_{i}",))


def _mlp(cr, key, path, dims, bn, end_with_relu=False):
    """flax MLP lin{i}/bn{i} -> reference _make_mlp Sequential indices."""
    seq = 0
    for i in range(len(dims)):
        cr.linear(f"{key}.{seq}", (*path, f"lin{i}"))
        seq += 1
        if i < len(dims) - 1 or end_with_relu:
            seq += 1  # ReLU
            if bn:
                name = f"bn{i}" if i < len(dims) - 1 else "bn_end"
                cr.bn(f"{key}.{seq}", (*path, name))
                seq += 1


def _mp_layer(cr, key, path):
    """MPLayer (reference layers.py:32-86; pemp_tpu/train/convert.py:
    354-381): ``mlp_edge_0`` / ``mlp_edge_1`` onto the reference's
    Sequential(Linear, ReLU, Linear, ReLU), and ``mlp_node.0``."""
    cr.linear(f"{key}.mlp_edge.0", (*path, "mlp_edge_0"))
    cr.linear(f"{key}.mlp_edge.2", (*path, "mlp_edge_1"))
    cr.linear(f"{key}.mlp_node.0", (*path, "mlp_node"))


def _type_aware_layer(cr, key, path):
    """TypeAwareMPNLayer: the edge MLP, the stacked ``mlp_node`` as T
    Linears, the attention head and the update."""
    cr.linear(f"{key}.mlp_edge.0", (*path, "mlp_edge_0"))
    cr.linear(f"{key}.mlp_edge.2", (*path, "mlp_edge_1"))
    kernel = _get(cr.params, (*path, "mlp_node", "kernel"))
    bias = _get(cr.params, (*path, "mlp_node", "bias"))
    for t in range(kernel.shape[0]):
        cr.put(f"{key}.mlp_node.mlp.{t}.0.weight", kernel[t].T)
        cr.put(f"{key}.mlp_node.mlp.{t}.0.bias", bias[t])
    cr.linear(f"{key}.attn_net.0", (*path, "attn_net"))
    cr.linear(f"{key}.update_mlp.0", (*path, "update_mlp"))


# per MPN: its heads (port name, config key) and the scope of its shared
# layer in the JAX tree (``("mpn", "layer")`` is nn.scan's scope, then the
# layer; the group-based model and MPNTag build theirs unscanned)
_EDGE, _NODE, _CLASS, _TAG = (("edge_classification", "EDGE_CLASS"),
                              ("node_classification", "NODE_CLASS"),
                              ("classification", "CLASS"), ("tag_pred", "NODE_TAG"))
_MPN_LAYOUT = {
    "NodeClassificationMPN": ((_EDGE, _NODE, _CLASS), ("mpn", "layer")),
    "NodeClassificationMPNWithBackground": ((_EDGE, _NODE, _CLASS), ("mpn", "layer")),
    "VanillaMPN": ((_EDGE,), ("mpn", "layer")),
    "JointTypeClassification": ((_CLASS,), ("mpn", "layer")),
    "NodeClassificationMPNTag": ((_TAG, _NODE, _CLASS), ("mpn", "layer")),
    "NodeClassificationMPNGroupBased": ((_EDGE, _NODE, _CLASS), ("layer",)),
    "MPNTag": ((_TAG,), ("mpn_node_cls",)),
}


def mpn_from_jax_variables(params, batch_stats, mpn_cfg: dict) -> dict:
    """JAX MPN variables -> the port's MPN ``state_dict``, for every model of
    models.mpn.models.MODELS (for the flagship the inverse of
    convert.convert_flagship_mpn_state_dict, for MPNTag of
    convert.convert_mpn_tag_state_dict): the embeddings, the heads, the
    shared layer, the tag model's second step stack ``mpn_node`` with
    ``NODE_STEPS``, LogisticEdgeClassifier's ``linear``."""
    cr = _Carrier(params, batch_stats)
    c = mpn_cfg
    name = c["NAME"]
    if name == "LogisticEdgeClassifier":
        cr.linear("linear", ("linear",))
        return cr.sd
    if name in ("TagThreshold", "PlainTag"):
        return cr.sd
    heads, path = _MPN_LAYOUT[name]
    vanilla = name == "VanillaMPN"
    for emb, key in (("node_embedding", "NODE_EMB"), ("edge_embedding", "EDGE_EMB")):
        if vanilla:   # MPN.BN and the node embedding's END_WITH_RELU for both
            _mlp(cr, emb, (emb,), c[key]["OUTPUT_SIZES"], c["BN"],
                 c["NODE_EMB"].get("END_WITH_RELU", False))
        else:
            _mlp(cr, emb, (emb,), c[key]["OUTPUT_SIZES"], c[key]["BN"],
                 c[key].get("END_WITH_RELU", False))
    for head, key in heads:
        _mlp(cr, head, (head,), c[key]["OUTPUT_SIZES"], c["BN"])
    layer = _mp_layer if vanilla or name == "MPNTag" or c.get("AGGR_TYPE") == "agnostic" \
        else _type_aware_layer
    layer(cr, "mpn_node_cls", path)
    if name == "NodeClassificationMPNTag" and c.get("NODE_STEPS", 0):
        layer(cr, "mpn_node", ("mpn_node", "layer"))
    return cr.sd


def from_jax_variables(params, batch_stats, cfg, backbone=None) -> dict:
    """JAX composite, AE-grouping or upper-bound variables -> the port's
    ``state_dict``.

    ``params`` / ``batch_stats``: the ``"params"`` and ``"batch_stats"``
    collections of ``pemp_tpu``'s PoseEstimationBaseline (``MODEL.KP``'s
    backbone, flagship MPN), PoseEstimationAeGroup or UpperBoundModel (the
    backbone alone), as nested dicts of arrays. ``cfg``: the config tree
    the models were built from; ``backbone`` names the backbone when it is
    not ``MODEL.KP`` (the upper-bound model's ``UB.KP``).
    """
    cr = _Carrier(params, batch_stats)
    if (backbone or cfg.MODEL.KP) == "hourglass":
        _hourglass(cr, hg_spec(cfg)[0])
    else:
        _hrnet(cr, HRNetSpec.from_config(cfg))
    if "mpn" not in params:
        return cr.sd
    cr.conv("feature_gather", ("feature_gather",), bias=True)
    mpn = mpn_from_jax_variables(params["mpn"], batch_stats.get("mpn", {}),
                                 mpn_cfg_from_config(cfg.MODEL.MPN))
    cr.sd.update({f"mpn.{k}": v for k, v in mpn.items()})
    return cr.sd
