"""Carries the JAX model's weights into the port.

:func:`from_jax_variables` takes the variables of a ``pemp_tpu``
composite model (``params`` and ``batch_stats`` as nested dicts of numpy
arrays) and returns a ``state_dict`` for
:class:`pemp_tpu_torch.models.pose_estimation.PoseEstimationBaseline`.

The port's modules carry the original reference's ``state_dict`` names, so
this is the inverse of ``pemp_tpu.train.convert.convert_composite_state_dict``
(its layout maps, inverted here):

  Conv2d        HWIO           -> OIHW
  ConvTranspose (k, k, out, in) -> (in, out, k, k)
  Linear        (in, out)       -> (out, in)
  BatchNorm     scale/bias + mean/var -> weight/bias/running_mean/running_var

and the fused MPN layer's stacked ``mlp_node`` kernel (T, din, dout) becomes
the reference's T separate Linears.
"""

from __future__ import annotations

import numpy as np
import torch

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


def mpn_from_jax_variables(params, batch_stats, mpn_cfg: dict) -> dict:
    """JAX NodeClassificationMPN variables -> the port's MPN ``state_dict``
    (inverse of convert.convert_flagship_mpn_state_dict)."""
    cr = _Carrier(params, batch_stats)
    c = mpn_cfg
    for name, key in (("node_embedding", "NODE_EMB"), ("edge_embedding", "EDGE_EMB")):
        _mlp(cr, name, (name,), c[key]["OUTPUT_SIZES"], c[key]["BN"],
             c[key].get("END_WITH_RELU", False))
    for name, key in (("edge_classification", "EDGE_CLASS"),
                      ("node_classification", "NODE_CLASS"), ("classification", "CLASS")):
        _mlp(cr, name, (name,), c[key]["OUTPUT_SIZES"], c["BN"])
    L = ("mpn", "layer")   # nn.scan's scope, then the shared layer
    lk = "mpn_node_cls"
    cr.linear(f"{lk}.mlp_edge.0", (*L, "mlp_edge_0"))
    cr.linear(f"{lk}.mlp_edge.2", (*L, "mlp_edge_1"))
    kernel = _get(cr.params, (*L, "mlp_node", "kernel"))
    bias = _get(cr.params, (*L, "mlp_node", "bias"))
    for t in range(kernel.shape[0]):
        cr.put(f"{lk}.mlp_node.mlp.{t}.0.weight", kernel[t].T)
        cr.put(f"{lk}.mlp_node.mlp.{t}.0.bias", bias[t])
    cr.linear(f"{lk}.attn_net.0", (*L, "attn_net"))
    cr.linear(f"{lk}.update_mlp.0", (*L, "update_mlp"))
    return cr.sd


def from_jax_variables(params, batch_stats, cfg) -> dict:
    """JAX composite variables -> the port's ``state_dict``.

    ``params`` / ``batch_stats``: the ``"params"`` and ``"batch_stats"``
    collections of ``pemp_tpu``'s PoseEstimationBaseline (hrnet backbone,
    flagship MPN), as nested dicts of arrays. ``cfg``: the config tree both
    models were built from.
    """
    cr = _Carrier(params, batch_stats)
    _hrnet(cr, HRNetSpec.from_config(cfg))
    cr.conv("feature_gather", ("feature_gather",), bias=True)
    mpn = mpn_from_jax_variables(params["mpn"], batch_stats.get("mpn", {}),
                                 mpn_cfg_from_config(cfg.MODEL.MPN))
    cr.sd.update({f"mpn.{k}": v for k, v in mpn.items()})
    return cr.sd
