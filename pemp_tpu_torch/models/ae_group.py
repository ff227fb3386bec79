"""Backbone-only model of the AE-grouping entry point (counterpart of
pemp_tpu.models.ae_group).

reference: src/Models/PoseEstimation/PoseEstimationAeGroup.py:8-249 and
PoseEstimationHourglass.py:15-202: heatmaps and tags from the backbone
alone (HigherHRNet or the Hourglass); the grouping runs on the host
(decode.ae_grouping, decode.group_hg).
"""

from __future__ import annotations

import torch
from torch import nn

from pemp_tpu_torch.config import check_path
from pemp_tpu_torch.models.pose_estimation import (
    backbone_from_config,
    process_output,
    resolve_device,
    to_nchw,
)


class PoseEstimationAeGroup(nn.Module):
    """``backbone`` alone; its ``state_dict`` is the composite's
    ``backbone.*`` part."""

    def __init__(self, backbone_name: str, backbone: nn.Module, num_joints: int = 17,
                 scoremap_mode: str = "avg", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone_name = backbone_name
        self.backbone = backbone
        self.num_joints = num_joints
        self.scoremap_mode = scoremap_mode
        self.dtype = dtype

    def backbone_forward(self, imgs):
        """TTAPipeline's signature: (per-stage outputs NHWC, scoremaps,
        None, tags), the maps NHWC float32. There is no learned feature
        gather, so no features (the JAX package returns zeros)."""
        stages, scoremaps, tags = self(imgs)
        return stages, scoremaps, None, tags

    def forward(self, imgs):
        """imgs (B, H, W, 3) -> (per-stage outputs NHWC, scoremaps, tags)."""
        final_outputs, feat = self.backbone(to_nchw(imgs, self.dtype))
        scoremaps, _, tags = process_output(self.backbone_name, final_outputs, feat,
                                            self.num_joints, self.scoremap_mode)
        stages = [y.permute(0, 2, 3, 1) for y in final_outputs]
        return stages, scoremaps.float(), tags.float()


def build_ae_group_model(config, dtype=torch.float32, device="cuda") -> PoseEstimationAeGroup:
    """reference get_hr_model / get_hg_model (PoseEstimationAeGroup.py:8-26,
    PoseEstimationHourglass.py:15-31), checked for the AE-grouping entry
    point (config.check_path ``"valid_hr"``). Returned in eval mode on
    ``device`` (CUDA unless the caller asks for the CPU) with PyTorch's
    default initialisation."""
    device = resolve_device(device)
    check_path(config, "valid_hr")
    name, backbone, _ = backbone_from_config(config)
    model = PoseEstimationAeGroup(name, backbone, num_joints=config.DATASET.NUM_JOINTS,
                                  scoremap_mode=config.MODEL.HRNET.SCOREMAP_MODE, dtype=dtype)
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
