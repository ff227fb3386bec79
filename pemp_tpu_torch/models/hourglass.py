"""The 4-stack Hourglass backbone in PyTorch (counterpart of
pemp_tpu.models.hourglass).

reference: src/Models/Hourglass/Hourglass.py:39-91, Layers.py:1-88. A
stride-4 stem, then per stack a recursive hourglass of depth 4, two 3x3
convolutions and a 1x1 head (``OUTPUT_DIM`` 68: 17 heatmaps, 17 tags and 34
channels no path reads), the stacks joined by ``x + merge_preds(pred) +
merge_features(feature)``.

Module names follow the reference's ``state_dict`` (``pre.{0,1,3,4}`` with
the max-pool at ``pre.2``, ``features.{i}.0`` the hourglass and
``features.{i}.{1,2}`` its two convolutions, ``outs.{i}``,
``merge_preds.{i}.conv`` and ``merge_features.{i}.conv``), which
pemp_tpu.train.convert.convert_hourglass_state_dict maps onto the JAX model.

Kept from the reference: its ``Conv`` is conv -> ReLU -> BatchNorm, and the
model is built with ``bn=False`` throughout, so every layer here is a
biased convolution with or without a ReLU; every hourglass level widens by
the default ``increase`` of 128, which nested blocks take whatever the
outer value (Layers.py:75); the 2x2 max-pool is VALID and the upsampling
nearest.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from pemp_tpu_torch.models.hrnet import Conv2d


class Conv(nn.Module):
    """reference Layers.py Conv with ``bn=False``: a biased conv, then a
    ReLU unless ``relu=False``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 relu: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, padding=(kernel - 1) // 2, bias=True)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        return F.relu(x) if self.relu else x


class Merge(nn.Module):
    """reference Hourglass.py Merge: a 1x1 conv without ReLU, under ``conv``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv(cin, cout, 1, relu=False)

    def forward(self, x):
        return self.conv(x)


class Hourglass(nn.Module):
    """Recursive hourglass. reference: Layers.py:66-88. Each level widens
    by 128: the reference's default ``increase``, which PoseNet is built
    with and the nested blocks take whatever the outer value (Layers.py:75)."""

    def __init__(self, n: int, f: int):
        super().__init__()
        nf = f + 128
        self.up1 = Conv(f, f)
        self.low1 = Conv(f, nf)
        self.low2 = Hourglass(n - 1, nf) if n > 1 else Conv(nf, nf)
        self.low3 = Conv(nf, f)

    def forward(self, x):
        up1 = self.up1(x)
        low = self.low3(self.low2(self.low1(F.max_pool2d(x, 2, 2))))
        return up1 + F.interpolate(low, scale_factor=2, mode="nearest")


class PoseNet(nn.Module):
    """reference: Hourglass.py:39-76. forward(x NCHW) -> (per-stack
    predictions, the last stack's feature map), NCHW at input / 4."""

    def __init__(self, nstack: int = 4, inp_dim: int = 256, oup_dim: int = 68):
        super().__init__()
        self.nstack = nstack
        self.pre = nn.Sequential(
            Conv(3, 64, 7, 2), Conv(64, 128), nn.MaxPool2d(2, 2), Conv(128, 128),
            Conv(128, inp_dim),
        )
        self.features = nn.ModuleList([
            nn.Sequential(Hourglass(4, inp_dim), Conv(inp_dim, inp_dim),
                          Conv(inp_dim, inp_dim))
            for _ in range(nstack)
        ])
        self.outs = nn.ModuleList([Conv(inp_dim, oup_dim, 1, relu=False)
                                   for _ in range(nstack)])
        self.merge_features = nn.ModuleList([Merge(inp_dim, inp_dim)
                                             for _ in range(nstack - 1)])
        self.merge_preds = nn.ModuleList([Merge(oup_dim, inp_dim) for _ in range(nstack - 1)])

    def forward(self, x):
        x = self.pre(x)
        preds = []
        feature = None
        for i in range(self.nstack):
            feature = self.features[i](x)
            pred = self.outs[i](feature)
            preds.append(pred)
            if i < self.nstack - 1:
                x = x + self.merge_preds[i](pred) + self.merge_features[i](feature)
        return preds, feature


def hg_process_output(preds, feature, num_joints: int = 17):
    """The last stack's heatmaps and tags, and the feature map, NHWC.

    reference: Hourglass.py:86-91 (it takes no scoremap mode: the JAX
    package's ``mode`` argument is unused). Returns (scoremaps, features,
    tags)."""
    last = preds[-1]
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    return (nhwc(last[:, :num_joints]), nhwc(feature),
            nhwc(last[:, num_joints:2 * num_joints]))


def hg_spec(config) -> tuple:
    """(NSTACK, INPUT_DIM, OUTPUT_DIM) from the config tree."""
    hg = config.MODEL.HG
    return hg.NSTACK, hg.INPUT_DIM, hg.OUTPUT_DIM

