"""The upper-bound model (counterpart of pemp_tpu.models.upper_bound): the
GT labels passed through as the predictions.

It measures the AP ceiling of the detection, graph and label stack apart
from any learned MPN (reference: src/Models/PoseEstimation/UpperBound.py:
72-137). The backbone is ``UB.KP``'s, with its output step; the node
features are a 3x3 average pool of its feature map (``SAME`` padding
divided by 9: zeros count at the border) instead of a learned
convolution; the edge and node predictions are the constructed labels,
the class prediction their one-hot classes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pemp_tpu_torch.config import check_path
from pemp_tpu_torch.graph.constructor import GCConfig, construct_graph_batch
from pemp_tpu_torch.models.pose_estimation import (
    backbone_from_config,
    process_output,
    resolve_device,
    to_nchw,
)


def pooled_features(features):
    """features (B, H, W, C) -> their 3x3 mean, zero-padded ``SAME`` and
    divided by 9 everywhere (``jax.lax.reduce_window`` of the JAX package,
    UpperBound.py:78)."""
    x = features.permute(0, 3, 1, 2)
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True).permute(0, 2, 3, 1)


class UpperBoundModel(nn.Module):
    """The backbone of ``UB.KP``; its ``state_dict`` is the composite's
    ``backbone.*`` part."""

    def __init__(self, backbone_name: str, backbone: nn.Module, gc: GCConfig,
                 num_joints: int = 17, scoremap_mode: str = "avg",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone_name = backbone_name
        self.backbone = backbone
        self.gc = gc
        self.num_joints = num_joints
        self.scoremap_mode = scoremap_mode
        self.dtype = dtype

    def forward(self, imgs, keypoints_gt, masks=None, factors=None):
        """imgs (B, H, W, 3), keypoints_gt (B, P, J, 3) in map coordinates,
        masks (B, H, W), factors (B, P, J). Returns (scoremaps, output) as
        pemp_tpu/models/upper_bound.py:38-85: labels, masks (the label
        masks, not cut by validity), preds (the labels; the heatmap the
        first stage's output, NHWC) and the graph. The graph is built in
        the JAX package's eval mode (``testing``)."""
        final_outputs, feat = self.backbone(to_nchw(imgs, self.dtype))
        scoremaps, features, tags = process_output(self.backbone_name, final_outputs, feat,
                                                   self.num_joints, self.scoremap_mode)
        features = pooled_features(features.float())
        scoremaps, tags = scoremaps.float(), tags.float()
        gb = construct_graph_batch(self.gc, scoremaps, features, tags, masks=masks,
                                   joints_gt=keypoints_gt, factors=factors, testing=True)
        classes = F.one_hot(gb.node_classes.long(), self.num_joints).float()
        output = {
            "labels": {"edge": gb.edge_labels, "node": gb.node_labels,
                       "class": gb.node_classes, "refine": gb.node_persons},
            "masks": {"edge": gb.label_mask, "node": gb.label_mask_node},
            "preds": {"edge": gb.edge_labels, "node": gb.node_labels, "class": classes,
                      "heatmap": final_outputs[0].permute(0, 2, 3, 1)},
            "graph": {"nodes": gb.joint_det, "detector_scores": gb.joint_scores,
                      "edge_index": gb.edge_index, "tags": tags,
                      "node_valid": gb.node_valid, "edge_valid": gb.edge_valid},
        }
        return scoremaps, output


def build_upper_bound_model(config, dtype=torch.float32, device="cuda") -> UpperBoundModel:
    """reference get_upper_bound_model (UpperBound.py:38-70): the backbone
    of ``UB.KP`` with the graph settings of ``MODEL.GC``, checked for the
    upper-bound path (config.check_path ``"upper_bound"``). Returned in
    eval mode on ``device`` (CUDA unless the caller asks for the CPU) with
    PyTorch's default initialisation; load a backbone with
    :func:`pemp_tpu_torch.weights.from_jax_variables` (``backbone=UB.KP``)
    or a composite checkpoint's ``backbone.*`` part."""
    device = resolve_device(device)
    check_path(config, "upper_bound")
    name, backbone, _ = backbone_from_config(config, config.UB.KP)
    model = UpperBoundModel(name, backbone, GCConfig.from_config(config),
                            num_joints=config.DATASET.NUM_JOINTS,
                            scoremap_mode=config.MODEL.HRNET.SCOREMAP_MODE, dtype=dtype)
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
