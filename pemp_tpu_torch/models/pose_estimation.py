"""Composite model: backbone -> graph constructor -> MPN (counterpart of
pemp_tpu.models.pose_estimation), for eval and for training.

reference: src/Models/PoseEstimation/PoseEstimation.py:53-111. Submodule
names (``backbone``, ``feature_gather``, ``mpn``) follow the reference, so
its composite ``state_dict`` loads unchanged. The backbone is
``MODEL.KP``'s: HigherHRNet (``hrnet``, and ``mmpose_hrnet``, the same
network whose checkpoints carry mmpose's names; train.checkpoint renames
them) or the 4-stack Hourglass (``hourglass``).

``TPU.MSG_PASS`` picks the MPN's route (models.mpn.models) and, for
``hybrid`` and ``einsum``, the symmetric kNN layout (graph.constructor).
``MODEL.MPN.NAME`` picks the MPN (models.mpn.models.registry).
Routing to a kernel is by device: on CUDA tensors each kernel of the route
runs as a hand-written CUDA kernel, on CPU tensors as its plain PyTorch
version (see ops/).
"""

from __future__ import annotations

import torch
from torch import nn

from pemp_tpu_torch.config import check_path
from pemp_tpu_torch.config.defaults import plain_route
from pemp_tpu_torch.graph.constructor import GCConfig, construct_graph_batch
from pemp_tpu_torch.models.hourglass import PoseNet, hg_process_output, hg_spec
from pemp_tpu_torch.models.hrnet import (
    Conv2d,
    HRNetSpec,
    PoseHigherResolutionNet,
    hr_process_output,
)
from pemp_tpu_torch.models.mpn.models import get_mpn_model, mpn_cfg_from_config

BACKBONES = ("hrnet", "mmpose_hrnet", "hourglass")


def backbone_from_config(config, name=None):
    """(``MODEL.KP`` or ``name``, its backbone module, the channels of its
    feature map): HigherHRNet's fused map for ``hrnet`` and
    ``mmpose_hrnet``, the last stack's ``INPUT_DIM``-wide feature for
    ``hourglass`` (pemp_tpu/models/pose_estimation.py:41-47, 186-196)."""
    name = name or config.MODEL.KP
    if name in ("hrnet", "mmpose_hrnet"):
        spec = HRNetSpec.from_config(config)
        return name, PoseHigherResolutionNet(spec), spec.feature_channels()
    if name == "hourglass":
        nstack, inp_dim, oup_dim = hg_spec(config)
        return name, PoseNet(nstack, inp_dim, oup_dim), inp_dim
    raise NotImplementedError(f"MODEL.KP={name!r}: one of {BACKBONES}")


def process_output(backbone_name, final_outputs, feat, num_joints, scoremap_mode):
    """The backbone's NCHW outputs as NHWC (scoremaps, features, tags):
    HigherHRNet's two heads resized and averaged by ``scoremap_mode``, or
    the Hourglass's last stack (which takes no mode)."""
    if backbone_name == "hourglass":
        return hg_process_output(final_outputs, feat, num_joints)
    return hr_process_output(final_outputs, feat, num_joints, scoremap_mode)


def to_nchw(imgs, dtype):
    """(B, H, W, 3) images as the backbone's NCHW input in ``dtype``,
    channels-last in memory on the card."""
    x = imgs.to(dtype).permute(0, 3, 1, 2)
    if x.is_cuda:
        x = x.contiguous(memory_format=torch.channels_last)
    return x


class PoseEstimationBaseline(nn.Module):
    """backbone + feature_gather conv + graph constructor + MPN."""

    def __init__(self, backbone_name: str, backbone: nn.Module, feature_channels: int,
                 gc: GCConfig, mpn_cfg: dict, num_joints: int = 17,
                 feature_gather_kernel: int = 3, node_input_dim: int = 128,
                 scoremap_mode: str = "avg", dtype: torch.dtype = torch.float32,
                 backbone_train: bool = False):
        super().__init__()
        self.gc = gc
        self.backbone_train = backbone_train
        self.backbone_name = backbone_name
        self.num_joints = num_joints
        self.scoremap_mode = scoremap_mode
        self.dtype = dtype
        self.backbone = backbone
        # reference: PoseEstimation.py:63-66
        self.feature_gather = Conv2d(
            feature_channels, node_input_dim, feature_gather_kernel,
            padding=feature_gather_kernel // 2, bias=True,
        )
        self.mpn = get_mpn_model(mpn_cfg)

    def train(self, mode: bool = True):
        """Training mode for the graph and MPN; the backbone's BatchNorm
        takes batch statistics only with ``backbone_train`` (``TRAIN.FREEZE_BN:
        false``) and reads its running statistics otherwise."""
        super().train(mode)
        self.backbone.train(mode and self.backbone_train)
        return self

    def backbone_forward(self, imgs):
        """imgs (B, H, W, 3) -> (per-stage outputs NHWC, scoremaps,
        features, tags), the last three NHWC float32 (the features float64
        in a float64 model). Gradients flow
        through the backbone whatever its BatchNorm mode. The output is
        processed first, then the features gathered, as in the JAX package
        (both process functions pass the feature map through)."""
        final_outputs, feat = self.backbone(to_nchw(imgs, self.dtype))
        scoremaps, features, tags = process_output(
            self.backbone_name, final_outputs, feat, self.num_joints, self.scoremap_mode)
        features = self.feature_gather(features.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        stages = [y.permute(0, 2, 3, 1) for y in final_outputs]
        features = features if features.dtype == torch.float64 else features.float()
        return stages, scoremaps.float(), features, tags.float()

    def mpn_forward(self, gb, route=None, feature_maps=None):
        """The MPN's per-step logits on the graph batch ``gb``
        (pemp_tpu/models/pose_estimation.py:80-98); ``route`` overrides the
        message-passing route the module's mode resolves. The MPN also gets
        the node labels (None without ground truth), the batch index and
        ``feature_maps``, the (B, H, W, NODE_INPUT_DIM) float32 map the
        graph's node features were read from, which the zoo's
        SelfAttention reads."""
        return self.mpn(gb.x, gb.edge_attr, gb.edge_index, gb.edge_valid, gb.edge_src_local,
                        self.dtype, node_valid=gb.node_valid, route=route,
                        node_types=gb.joint_det[:, 2], joint_tags=gb.joint_tags,
                        node_labels=gb.node_labels, feature_maps=feature_maps,
                        batch_index=gb.batch_index)

    def forward(self, imgs, keypoints_gt=None, masks=None, factors=None, route=None,
                heatmaps=None):
        """reference forward: PoseEstimation.py:71-111.

        Returns (scoremaps (B, H, W, J), output) with output["preds"] (MPN
        logits) and output["graph"] (the flattened graph and tags). Given
        the GT joints (B, P, J, 3) in map coordinates, their OKS factors
        (B, P, J) and the crowd masks (B, H, W) of the last scale (always
        in training mode; at eval for the validation loss), it adds
        output["labels"] and output["masks"], with output["preds"]["heatmap"]
        the backbone's per-stage outputs
        (pemp_tpu/models/pose_estimation.py:109-171). The module's mode
        picks the MPN's route unless ``route`` names one, and eval mode is
        the graph's ``testing``. ``heatmaps`` [per scale (B, h, w, J)], the
        GT heatmaps, weight the class loss by the last scale's under
        ``WEIGHT_CLASS_LOSS``. The graph draws nothing at random, as the
        JAX package without ``gc_rng``, which its trainer never passes.
        """
        stages, scoremaps, features, tags = self.backbone_forward(imgs)
        gt_heatmaps = heatmaps[-1] if heatmaps is not None and self.gc.weight_class_loss else None
        gb = construct_graph_batch(self.gc, scoremaps.detach(), features, tags.detach(),
                                   masks=masks, joints_gt=keypoints_gt, factors=factors,
                                   testing=not self.training, gt_heatmaps=gt_heatmaps)
        preds = self.mpn_forward(gb, route, features)
        graph = {
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
        }
        if keypoints_gt is None:
            return scoremaps, {"preds": preds, "graph": graph}
        nv, ev = gb.node_valid.float(), gb.edge_valid.float()
        output = {
            "labels": {
                "edge": gb.edge_labels,
                "node": gb.node_labels,
                "class": gb.node_classes,
                "person": gb.node_persons,
                "batch_index": gb.batch_index,
            },
            "masks": {
                "edge": gb.label_mask * ev,
                "node": gb.label_mask_node * nv,
                "class": gb.class_mask * nv,
                "node_valid": gb.node_valid,
                "edge_valid": gb.edge_valid,
            },
            "preds": {**preds, "heatmap": stages},
            "graph": graph,
        }
        return scoremaps, output


def head_probs(preds, detector_scores, edge_valid):
    """(edge_pred, node_pred, class_prob) of the final heads, float32: the
    sigmoids and the class softmax; an MPN without an edge head (the tag
    and class models) gives edge_pred 0 on every slot of ``edge_valid``'s
    shape, without a node head (VanillaMPN, MPNTag) takes the detector
    scores as node scores, and without a class head gives class_prob None,
    so the decode takes the detections' types
    (pemp_tpu/tta/multi_scale.py:43-63)."""
    edge_logit = preds["edge"][-1] if preds["edge"] else None
    edge_pred = (torch.zeros(edge_valid.shape, dtype=torch.float32, device=edge_valid.device)
                 if edge_logit is None else torch.sigmoid(edge_logit.float()))
    node_logit = preds["node"][-1] if preds["node"] else None
    node_pred = (detector_scores.float() if node_logit is None
                 else torch.sigmoid(node_logit.float()))
    class_prob = None
    if preds.get("class"):
        class_prob = torch.softmax(preds["class"][-1].float(), dim=-1)
    return edge_pred, node_pred, class_prob


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU.
    Raises when CUDA is asked for and absent; nothing falls back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def mpn_config(config, gc: GCConfig) -> dict:
    """The MPN's plain-dict config with the layout and route keys the JAX
    package's build_pose_model records (pemp_tpu/models/pose_estimation.py:
    205-214): on the target-major kNN layout, edges in blocks of C slots
    (``_BLOCKED_C``) and type-blocked nodes (``_NODES_PER_TYPE``); on an
    edge list neither; under ``USE_GT`` the nodes are the GT joints,
    person-major (``_GT_NODES``), where the JAX package drops
    ``_NODES_PER_TYPE`` (:212-218) and the port keeps it for the nodes an
    image. ``_MSG_PASS`` is ``TPU.MSG_PASS``, ``_PLAIN_ROUTE`` the
    kernel-free route (config.defaults.plain_route) or None."""
    mpn_cfg = mpn_cfg_from_config(config.MODEL.MPN)
    if gc.blocked:
        mpn_cfg["_BLOCKED_C"] = gc.slots
        mpn_cfg["_NODES_PER_TYPE"] = gc.nodes_per_type
    if gc.use_gt:
        mpn_cfg["_GT_NODES"] = True
    mpn_cfg["_MSG_PASS"] = config.TPU.MSG_PASS
    mpn_cfg["_PLAIN_ROUTE"] = plain_route(config)
    return mpn_cfg


def build_pose_model(config, dtype=torch.float32, device="cuda",
                     path: str = "eval") -> PoseEstimationBaseline:
    """Factory from the config tree (reference get_pose_model:
    PoseEstimation.py:14-38), for the bench's eval path, the eval entry
    point (``"valid"``) or the training path (``"train"``); raises on
    settings that path does not implement (config.check_path) and on an MPN
    the port does not have (``MODEL.MPN.NAME``, models.mpn.models). Returned in
    eval mode; ``.train()`` switches the
    forward to the training path. The weights are PyTorch's
    default initialisation; load real ones with ``load_state_dict`` or
    :func:`pemp_tpu_torch.weights.from_jax_variables`."""
    device = resolve_device(device)
    check_path(config, path)
    gc = GCConfig.from_config(config)
    backbone_name, backbone, feature_channels = backbone_from_config(config)
    mpn_cfg = mpn_config(config, gc)
    model = PoseEstimationBaseline(
        backbone_name, backbone, feature_channels, gc, mpn_cfg,
        num_joints=config.DATASET.NUM_JOINTS,
        feature_gather_kernel=config.MODEL.FEATURE_GATHER_KERNEL,
        node_input_dim=config.MODEL.MPN.NODE_INPUT_DIM,
        scoremap_mode=config.MODEL.HRNET.SCOREMAP_MODE,
        dtype=dtype,
        backbone_train=not config.TRAIN.FREEZE_BN,
    )
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
