"""Composite model: backbone -> graph constructor -> MPN (counterpart of
pemp_tpu.models.pose_estimation, eval with the hrnet backbone).

reference: src/Models/PoseEstimation/PoseEstimation.py:53-111. Submodule
names (``backbone``, ``feature_gather``, ``mpn``) follow the reference, so
its composite ``state_dict`` loads unchanged.

Routing is by device: on CUDA tensors the MPN step runs the hand-written
kernel, on CPU tensors its plain PyTorch version (see ops.fused_step).
"""

from __future__ import annotations

import torch
from torch import nn

from pemp_tpu_torch.graph.constructor import GCConfig, construct_graph_batch
from pemp_tpu_torch.models.hrnet import (
    Conv2d,
    HRNetSpec,
    PoseHigherResolutionNet,
    hr_process_output,
)
from pemp_tpu_torch.models.mpn.models import NodeClassificationMPN, mpn_cfg_from_config


class PoseEstimationBaseline(nn.Module):
    """backbone + feature_gather conv + graph constructor + MPN."""

    def __init__(self, hrnet_spec: HRNetSpec, gc: GCConfig, mpn_cfg: dict,
                 num_joints: int = 17, feature_gather_kernel: int = 3,
                 node_input_dim: int = 128, scoremap_mode: str = "avg",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gc = gc
        self.num_joints = num_joints
        self.scoremap_mode = scoremap_mode
        self.dtype = dtype
        self.backbone = PoseHigherResolutionNet(hrnet_spec)
        # reference: PoseEstimation.py:63-66
        self.feature_gather = Conv2d(
            hrnet_spec.feature_channels(), node_input_dim, feature_gather_kernel,
            padding=feature_gather_kernel // 2, bias=True,
        )
        self.mpn = NodeClassificationMPN(mpn_cfg)

    def backbone_forward(self, imgs):
        """imgs (B, H, W, 3) -> (scoremaps, features, tags), NHWC float32."""
        x = imgs.to(self.dtype).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        final_outputs, feat = self.backbone(x)
        feat = self.feature_gather(feat)
        scoremaps, features, tags = hr_process_output(
            final_outputs, feat, self.num_joints, self.scoremap_mode
        )
        return scoremaps.float(), features.float(), tags.float()

    def forward(self, imgs):
        """reference forward: PoseEstimation.py:71-111, eval only.

        Returns (scoremaps (B, H, W, J), output) with output["preds"] (MPN
        logits) and output["graph"] (the flattened eval graph and tags).
        """
        scoremaps, features, tags = self.backbone_forward(imgs)
        gb = construct_graph_batch(self.gc, scoremaps, features, tags)
        preds = self.mpn(
            gb.x, gb.edge_attr, gb.edge_index, gb.edge_valid, gb.edge_src_local,
            self.dtype,
        )
        output = {
            "preds": preds,
            "graph": {
                "nodes": gb.joint_det,
                "detector_scores": gb.joint_scores,
                "edge_index": gb.edge_index,
                "edge_src_local": gb.edge_src_local,
                "tags": tags,
                "node_valid": gb.node_valid,
                "edge_valid": gb.edge_valid,
                "batch_index": gb.batch_index,
                "x": gb.x,
                "edge_attr": gb.edge_attr,
            },
        }
        return scoremaps, output


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU.
    Raises when CUDA is asked for and absent; nothing falls back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def build_pose_model(config, dtype=torch.float32, device="cuda") -> PoseEstimationBaseline:
    """Factory from the config tree (reference get_pose_model:
    PoseEstimation.py:14-38). The weights are PyTorch's default
    initialisation; load real ones with ``load_state_dict`` or
    :func:`pemp_tpu_torch.weights.from_jax_variables`."""
    device = resolve_device(device)
    gc = GCConfig.from_config(config)
    mpn_cfg = mpn_cfg_from_config(config.MODEL.MPN)
    # edges arrive in target-major blocks of C slots and nodes are
    # type-blocked, as the JAX package's build_pose_model records them
    mpn_cfg["_BLOCKED_C"] = gc.slots
    mpn_cfg["_NODES_PER_TYPE"] = gc.nodes_per_type
    model = PoseEstimationBaseline(
        HRNetSpec.from_config(config), gc, mpn_cfg,
        num_joints=config.DATASET.NUM_JOINTS,
        feature_gather_kernel=config.MODEL.FEATURE_GATHER_KERNEL,
        node_input_dim=config.MODEL.MPN.NODE_INPUT_DIM,
        scoremap_mode=config.MODEL.HRNET.SCOREMAP_MODE,
        dtype=dtype,
    )
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
