"""HigherHRNet backbone in PyTorch (counterpart of pemp_tpu.models.hrnet).

Module and parameter names follow the original reference implementation
(reference: src/Models/HigherHRNet/hrnet.py:248-544), so a released ``.pth``
loads with ``load_state_dict`` and ``pemp_tpu.train.convert`` maps these
weights onto the JAX model one to one.

Tensors are NCHW inside the network; :func:`hr_process_output` and the
composite model hand NHWC maps to the rest of the pipeline, as the JAX
package does. Each layer computes in the dtype of its input (weights are
cast at use, BatchNorm runs in float32 and casts back), which mirrors the
JAX package's ``dtype`` attribute with float32 parameters. Only the
standard deconv branch is ported; the JAX package's space-to-depth rewrite
of it is an exact TPU layout change.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """Conv2d that computes in its input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d that computes in its input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), b, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation,
        )


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm in float32 (float64 for a float64 input), cast back to the
    input's dtype (flax BatchNorm with a low-precision ``dtype``, whose
    statistics are at least float32). In eval mode it reads the running
    statistics. In training mode (the backbone under ``TRAIN.FREEZE_BN:
    false``) it normalises by the batch's mean and biased variance and
    moves the running statistics towards them as flax does: ``r = 0.9 r +
    0.1 s`` with the *biased* variance, where torch's own update takes the
    unbiased one."""

    def forward(self, x):
        xf = x if x.dtype == torch.float64 else x.float()
        if not self.training:
            y = F.batch_norm(xf, self.running_mean.to(xf.dtype), self.running_var.to(xf.dtype),
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(x.dtype)
        # two-pass statistics, differentiated through: torch's CPU
        # batch_norm in training mode loses precision to cancellation on one
        # thread (and flax's E[x^2] - E[x]^2 does in float32)
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean.to(torch.float32))
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var.to(torch.float32))
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = xf * scale[:, None, None] + (self.bias - mean * scale)[:, None, None]
        return y.to(x.dtype)


def _conv(cin, cout, kernel, stride=1, bias=False):
    return Conv2d(cin, cout, kernel, stride, padding=kernel // 2, bias=bias)


def _bn(c):
    return BatchNorm2d(c, momentum=0.1)


class BasicBlock(nn.Module):
    """reference: hrnet.py:32-61"""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _bn(planes)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """reference: hrnet.py:64-102 (expansion 4)"""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = _bn(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


def _downsample(cin, cout, stride=1):
    return nn.Sequential(_conv(cin, cout, 1, stride), _bn(cout))


def _resize_bilinear(x, out_hw):
    """NCHW bilinear resize with half-pixel centres (jax.image.resize)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False, antialias=False)


class HighResolutionModule(nn.Module):
    """Parallel branches + exchange/fuse unit. reference: hrnet.py:105-239"""

    def __init__(self, num_branches, num_blocks, in_channels, num_channels,
                 multi_scale_output=True):
        super().__init__()
        self.num_branches = num_branches
        self.multi_scale_output = multi_scale_output
        self.branches = nn.ModuleList()
        for i in range(num_branches):
            blocks = []
            cin = in_channels[i]
            for k in range(num_blocks[i]):
                ds = (
                    _downsample(cin, num_channels[i])
                    if k == 0 and cin != num_channels[i] else None
                )
                blocks.append(BasicBlock(cin, num_channels[i], downsample=ds))
                cin = num_channels[i]
            self.branches.append(nn.Sequential(*blocks))
        self.fuse_layers = None
        if num_branches > 1:
            num_out = num_branches if multi_scale_output else 1
            self.fuse_layers = nn.ModuleList()
            for i in range(num_out):
                row = nn.ModuleList()
                for j in range(num_branches):
                    if j == i:
                        row.append(None)
                    elif j > i:
                        # 1x1 conv + BN + nearest upsample 2^(j-i)
                        row.append(nn.Sequential(
                            _conv(num_channels[j], num_channels[i], 1),
                            _bn(num_channels[i]),
                            nn.Upsample(scale_factor=2 ** (j - i), mode="nearest"),
                        ))
                    else:
                        # (i-j) strided 3x3 convs
                        steps = []
                        for k in range(i - j):
                            last = k == i - j - 1
                            ch = num_channels[i] if last else num_channels[j]
                            mods = [_conv(num_channels[j], ch, 3, 2), _bn(ch)]
                            if not last:
                                mods.append(nn.ReLU())
                            steps.append(nn.Sequential(*mods))
                        row.append(nn.Sequential(*steps))
                self.fuse_layers.append(row)

    def forward(self, xs):
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.num_branches == 1:
            return ys
        fused = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j in range(self.num_branches):
                t = ys[j] if j == i else row[j](ys[j])
                y = t if y is None else y + t
            fused.append(F.relu(y))
        return fused


@dataclasses.dataclass(frozen=True)
class HRNetSpec:
    """Static architecture spec extracted from the config tree."""

    num_joints: int = 17
    tag_per_joint: bool = True
    stem_inplanes: int = 64
    final_conv_kernel: int = 1
    stages: tuple = (
        # (num_modules, num_branches, num_blocks, num_channels)
        (1, 2, (4, 4), (32, 64)),
        (4, 3, (4, 4, 4), (32, 64, 128)),
        (3, 4, (4, 4, 4, 4), (32, 64, 128, 256)),
    )
    num_deconvs: int = 1
    deconv_channels: tuple = (32,)
    deconv_kernel: tuple = (4,)
    deconv_num_basic_blocks: int = 4
    deconv_cat_output: tuple = (True,)
    with_ae_loss: tuple = (True, False)
    feature_fusion: str = "avg"

    @classmethod
    def from_config(cls, config) -> "HRNetSpec":
        e = config.MODEL.HRNET.EXTRA
        stages = tuple(
            (s.NUM_MODULES, s.NUM_BRANCHES, tuple(s.NUM_BLOCKS), tuple(s.NUM_CHANNELS))
            for s in (e.STAGE2, e.STAGE3, e.STAGE4)
        )
        return cls(
            num_joints=config.MODEL.HRNET.NUM_JOINTS,
            tag_per_joint=config.MODEL.HRNET.TAG_PER_JOINT,
            stem_inplanes=e.STEM_INPLANES,
            final_conv_kernel=e.FINAL_CONV_KERNEL,
            stages=stages,
            num_deconvs=e.DECONV.NUM_DECONVS,
            deconv_channels=tuple(e.DECONV.NUM_CHANNELS),
            deconv_kernel=tuple(e.DECONV.KERNEL_SIZE),
            deconv_num_basic_blocks=e.DECONV.NUM_BASIC_BLOCKS,
            deconv_cat_output=tuple(e.DECONV.CAT_OUTPUT),
            with_ae_loss=tuple(config.MODEL.HRNET.LOSS.WITH_AE_LOSS),
            feature_fusion=config.MODEL.HRNET.FEATURE_FUSION,
        )

    def feature_channels(self) -> int:
        """Channels of the MPN feature map for ``feature_fusion``."""
        small = self.stages[-1][3][0]
        if self.feature_fusion in ("small", "avg", "pool"):
            return small
        if self.feature_fusion == "large":
            return self.deconv_channels[-1]
        if self.feature_fusion == "cat_multi":
            return 256 + self.stages[0][3][0] + self.stages[1][3][0] + small
        raise NotImplementedError(self.feature_fusion)


class PoseHigherResolutionNet(nn.Module):
    """reference: hrnet.py:248-544. forward(x NCHW) -> (final_outputs, features),
    both NCHW."""

    def __init__(self, spec: HRNetSpec):
        super().__init__()
        self.spec = spec
        if any(k != 4 for k in spec.deconv_kernel):
            raise NotImplementedError("deconv kernel must be 4 (k4 s2 p1)")
        # stem: 2x stride-2 conv + 4 Bottlenecks (hrnet.py:471-478)
        self.conv1 = _conv(3, 64, 3, 2)
        self.bn1 = _bn(64)
        self.conv2 = _conv(64, 64, 3, 2)
        self.bn2 = _bn(64)
        self.layer1 = nn.Sequential(
            Bottleneck(64, 64, downsample=_downsample(64, 256)),
            *[Bottleneck(256, 64) for _ in range(3)],
        )

        prev = [256]
        for si, (num_modules, num_branches, num_blocks, num_channels) in enumerate(spec.stages):
            # transition (hrnet.py:388-421); None keeps the branch as it is
            trans = nn.ModuleList()
            for i in range(num_branches):
                if i < len(prev):
                    if prev[i] != num_channels[i]:
                        trans.append(nn.Sequential(
                            _conv(prev[i], num_channels[i], 3), _bn(num_channels[i]),
                            nn.ReLU(),
                        ))
                    else:
                        trans.append(None)
                else:
                    steps = []
                    for j in range(i + 1 - len(prev)):
                        ch = num_channels[i] if j == i - len(prev) else prev[-1]
                        steps.append(nn.Sequential(
                            _conv(prev[-1], ch, 3, 2), _bn(ch), nn.ReLU(),
                        ))
                    trans.append(nn.Sequential(*steps))
            setattr(self, f"transition{si + 1}", trans)
            mods = []
            for m in range(num_modules):
                multi = not (si == len(spec.stages) - 1 and m == num_modules - 1)
                mods.append(HighResolutionModule(
                    num_branches, num_blocks,
                    list(num_channels), list(num_channels), multi,
                ))
            setattr(self, f"stage{si + 2}", nn.Sequential(*mods))
            prev = list(num_channels)

        dim_tag = spec.num_joints if spec.tag_per_joint else 1
        k = spec.final_conv_kernel
        cin = spec.stages[-1][3][0]
        final = []
        out_ch = spec.num_joints + dim_tag if spec.with_ae_loss[0] else spec.num_joints
        final.append(Conv2d(cin, out_ch, k, padding=k // 2 if k == 3 else 0, bias=True))
        deconvs = []
        for i in range(spec.num_deconvs):
            dcin = cin + (out_ch if spec.deconv_cat_output[i] else 0)
            c = spec.deconv_channels[i]
            layers = [nn.Sequential(
                ConvTranspose2d(dcin, c, 4, stride=2, padding=1, bias=False),
                _bn(c), nn.ReLU(),
            )]
            for _ in range(spec.deconv_num_basic_blocks):
                layers.append(nn.Sequential(BasicBlock(c, c)))
            deconvs.append(nn.Sequential(*layers))
            cin = c
            out_ch = (
                spec.num_joints + dim_tag if spec.with_ae_loss[i + 1] else spec.num_joints
            )
            final.append(Conv2d(cin, out_ch, k, padding=k // 2 if k == 3 else 0, bias=True))
        self.final_layers = nn.ModuleList(final)
        self.deconv_layers = nn.ModuleList(deconvs)

    def forward(self, x):
        spec = self.spec
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        features_stem = x

        xs = [x]
        features_stage = []
        for si in range(len(spec.stages)):
            trans = getattr(self, f"transition{si + 1}")
            new_xs = []
            for i, t in enumerate(trans):
                src = xs[i] if i < len(xs) else xs[-1]
                new_xs.append(src if t is None else t(src))
            xs = getattr(self, f"stage{si + 2}")(new_xs)
            features_stage.append(xs[0])

        x = xs[0]
        features_small = x
        y = self.final_layers[0](x)
        final_outputs = [y]
        for i in range(spec.num_deconvs):
            if spec.deconv_cat_output[i]:
                x = torch.cat([x, y], dim=1)
            x = self.deconv_layers[i](x)
            y = self.final_layers[i + 1](x)
            final_outputs.append(y)

        features_big = x
        big_hw = features_big.shape[2:4]
        features_small = _resize_bilinear(features_small, big_hw)
        fusion = spec.feature_fusion
        if fusion == "pool":
            features = torch.maximum(features_small, features_big)
        elif fusion == "avg":
            features = (features_big + features_small) / 2
        elif fusion == "small":
            features = features_small
        elif fusion == "large":
            features = features_big
        elif fusion == "cat_multi":
            features = torch.cat([features_stem, features_stage[0], features_stage[1]], dim=1)
            features = _resize_bilinear(features, big_hw)
            features = torch.cat([features, features_small], dim=1)
        else:
            raise NotImplementedError(fusion)
        return final_outputs, features


def hr_process_output(final_outputs, features, num_joints: int, mode: str):
    """Resize+average the two heatmap heads and slice the tags.

    reference: hrnet.py:587-611. Takes the NCHW network outputs and returns
    (scoremaps, features, tags) as NHWC, the JAX package's layout.
    """
    scoremap_1, scoremap_2 = final_outputs
    if mode in ("avg", "small"):
        scoremap_1 = _resize_bilinear(scoremap_1, scoremap_2.shape[2:4])
    tags = scoremap_1[:, num_joints:]
    if mode == "avg":
        scoremaps = (scoremap_2 + scoremap_1[:, :num_joints]) / 2
    elif mode == "small":
        scoremaps = scoremap_1[:, :num_joints]
    elif mode == "large":
        scoremaps = scoremap_2
    else:
        raise NotImplementedError(mode)
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    return nhwc(scoremaps), nhwc(features), nhwc(tags)
