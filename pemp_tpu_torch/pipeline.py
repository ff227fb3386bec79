"""The flagship eval pipeline: HigherHRNet -> NMS/top-K detection -> kNN
graph -> 10-step MPN -> threshold grouping + refine + quarter adjust.

Counterpart of ``bench.py``'s ``build_pipeline`` (its ``forward`` and
``decode_one``): sigmoid on edge and node logits, softmax on classes, the
blocked clustering path and NHWC maps throughout.
"""

from __future__ import annotations

import torch

from pemp_tpu_torch.config import w48_640
from pemp_tpu_torch.decode.assembly import decode_poses
from pemp_tpu_torch.models.pose_estimation import build_pose_model, head_probs, resolve_device

# the main path's shape: bench.py's batch and input size
BATCH = 8
INPUT_SIZE = 640


def init_random_weights(model: torch.nn.Module, seed: int) -> None:
    """Seeded random weights: LeCun-normal kernels (the JAX package's
    initialiser), zero biases, BatchNorm at identity statistics."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:        # BatchNorm scale
                p.fill_(1.0)
            else:
                w = torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5
                p.copy_(w.to(p.device))


class Pipeline:
    """images (B, H, W, 3) float -> (persons (B, 30, J, 3), person_valid (B, 30))."""

    def __init__(self, model, node_threshold: float, num_joints: int):
        self.model = model
        self.node_threshold = node_threshold
        self.num_joints = num_joints

    @torch.no_grad()
    def forward(self, images):
        """Model outputs plus the decode; returns (persons, valid, scoremaps, output)."""
        scoremaps, output = self.model(images)
        g = output["graph"]
        b = images.shape[0]
        n = self.num_joints * self.model.gc.nodes_per_type
        e = g["edge_index"].shape[1] // b
        edge_pred, node_pred, class_prob = head_probs(output["preds"], g["detector_scores"],
                                                    g["edge_valid"])
        per_img = lambda t: t.reshape(b, n, *t.shape[1:])  # noqa: E731
        offsets = torch.arange(b, device=images.device)[:, None, None] * n
        local_index = g["edge_index"].reshape(2, b, e).transpose(0, 1) - offsets
        persons, valid = decode_poses(
            scoremaps, g["tags"], per_img(g["nodes"]), per_img(node_pred), local_index,
            g["edge_valid"].reshape(b, e), edge_pred.reshape(b, e),
            per_img(g["node_valid"]),
            node_threshold=self.node_threshold, num_joints=self.num_joints,
            blocked_c=self.model.gc.blocked_c,
            class_probs=None if class_prob is None else per_img(class_prob),
        )
        return persons, valid, scoremaps, output

    def __call__(self, images):
        persons, valid, _, _ = self.forward(images)
        return persons, valid


def build_pipeline(batch: int, input_size: int = INPUT_SIZE, dtype=torch.bfloat16,
                   device="cuda", cfg=None, seed: int = 0) -> Pipeline:
    """The w48/640 eval pipeline (or ``cfg``'s) with seeded random weights.

    ``batch`` and ``input_size`` are the sizes the caller will send; the
    network is fully convolutional, so they size nothing here and are kept
    for the bench's signature. Runs on CUDA unless ``device="cpu"``.
    """
    del batch, input_size
    device = resolve_device(device)
    cfg = w48_640() if cfg is None else cfg
    model = build_pose_model(cfg, dtype=dtype, device=device)
    init_random_weights(model, seed)
    return Pipeline(model, cfg.MODEL.MPN.NODE_THRESHOLD, cfg.DATASET.NUM_JOINTS)
