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
(models.mpn.models.registry: the flagship's family, the baselines and the
research zoo).
"""

from __future__ import annotations

import numpy as np
import torch

from pemp_tpu_torch.models.hourglass import hg_spec
from pemp_tpu_torch.models.hrnet import HRNetSpec
from pemp_tpu_torch.models.mpn import zoo
from pemp_tpu_torch.models.mpn.layers import (
    MLP,
    Linear,
    MaskedBatchNorm,
    MPLayer,
    TypeAwareMPNLayer,
)
from pemp_tpu_torch.models.mpn.models import get_mpn_model, mpn_cfg_from_config


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


def _mlp(cr, key, path, mlp):
    """flax MLP lin{i}/bn{i}/bn_end -> the port's MLP (the reference's
    _make_mlp Sequential indices), walked on the port's module: the
    BatchNorm after Linear i is ``bn{i}``, after the last ``bn_end``."""
    n = sum(isinstance(m, Linear) for m in mlp)
    i = -1
    for seq, m in enumerate(mlp):
        if isinstance(m, Linear):
            i += 1
            cr.linear(f"{key}.{seq}", (*path, f"lin{i}"))
        elif isinstance(m, MaskedBatchNorm):
            cr.bn(f"{key}.{seq}", (*path, f"bn{i}" if i < n - 1 else "bn_end"))


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


def _vanilla_layer2(cr, key, path):
    """VanillaMPN2's layer (pemp_tpu/train/convert.py:482-512):
    ``mlp_edge_0`` / ``mlp_edge_bn`` onto Sequential(Linear, ReLU,
    BatchNorm), the same for ``mlp_node``."""
    for part in ("mlp_edge", "mlp_node"):
        cr.linear(f"{key}.{part}.0", (*path, f"{part}_0"))
        cr.bn(f"{key}.{part}.2", (*path, f"{part}_bn"))


# the JAX scope of a port module where it is not the module's own name:
# nn.scan's ("mpn", "layer") around the scanned models' shared layer and
# the tag model's second stack; "layer" for the two models that build
# theirs unscanned under that name
_SCANNED = ("NodeClassificationMPN", "NodeClassificationMPNWithBackground", "VanillaMPN",
            "JointTypeClassification", "NodeClassificationMPNTag")
_SCOPES = {
    **{name: {"mpn_node_cls": ("mpn", "layer"), "mpn_node": ("mpn_node", "layer")}
       for name in _SCANNED},
    "NodeClassificationMPNGroupBased": {"mpn_node_cls": ("layer",)},
    "ClassificationMPNSimple2": {"mpn_node_cls": ("layer",)},
}


def _carry(cr, key, path, module):
    """The JAX variables at ``path`` onto the port's ``module`` at ``key``."""
    if isinstance(module, MLP):
        _mlp(cr, key, path, module)
    elif isinstance(module, MPLayer):
        _mp_layer(cr, key, path)
    elif isinstance(module, TypeAwareMPNLayer):
        _type_aware_layer(cr, key, path)
    elif isinstance(module, Linear):
        cr.linear(key, path)
    elif isinstance(module, zoo._VanillaMPLayer2):
        _vanilla_layer2(cr, key, path)
    elif isinstance(module, zoo._NodeMlpBank):       # flax's _NodeMlpBank: mlp_{t}
        for t, mlp in enumerate(module):
            _mlp(cr, f"{key}.{t}", (*path, f"mlp_{t}"), mlp)
    elif isinstance(module, torch.nn.ModuleList):    # VanillaMPN2's mpn.{i}: mpn_{i}
        for i, layer in enumerate(module):
            _carry(cr, f"{key}.{i}", (f"{path[-1]}_{i}",), layer)
    else:
        raise NotImplementedError(f"{key}: {type(module).__name__} has no JAX counterpart")


def mpn_from_jax_variables(params, batch_stats, mpn_cfg: dict) -> dict:
    """JAX MPN variables -> the port's MPN ``state_dict``, for every model
    of models.mpn.models.registry (for the flagship the inverse of
    convert.convert_flagship_mpn_state_dict, for MPNTag of
    convert.convert_mpn_tag_state_dict, for ClassificationMPNSimple and
    VanillaMPN2 of convert_classification_simple_state_dict and
    convert_vanilla_mpn2_state_dict): walks the port's model built from
    ``mpn_cfg``, each submodule from the JAX scope of its name (or
    :data:`_SCOPES`'), so every parameter and statistic the port has is
    carried and none other."""
    cfg = {**mpn_cfg, "_PLAIN_ROUTE": mpn_cfg.get("_PLAIN_ROUTE") or "segment"}
    model = get_mpn_model(cfg)        # only its structure is read (no layout checks)
    cr = _Carrier(params, batch_stats)
    scopes = _SCOPES.get(mpn_cfg["NAME"], {})
    for key, module in model.named_children():
        _carry(cr, key, scopes.get(key, (key,)), module)
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
