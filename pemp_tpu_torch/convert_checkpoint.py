"""Converts a published HigherHRNet ``.pth`` into a checkpoint of the port.

    python -m pemp_tpu_torch.convert_checkpoint --config hrnet/w48_640 \
        --pth pose_higher_hrnet_w48_640.pth --out pretrained/w48_640.ckpt \
        [--scheme plain|strip1|strip2|strip_prefix2char] [--mmpose] \
        [--device cpu] [KEY VALUE ...]

The counterpart of ``tools/convert_checkpoint.py``. The ``.pth``'s keys
pass through one of the reference's provenance renames
(``train.checkpoint.RENAME_SCHEMES``; reference: PoseEstimation.py:14-38,
UpperBound.py:40-66), mmpose's names (``--mmpose``, or ``MODEL.KP
mmpose_hrnet``) map to the reference's, and the backbone's weights are
grafted onto the composite model of ``--config`` with seeded random
weights (seed 0): ``feature_gather`` and the MPN stay at that
initialisation. The result is a checkpoint of epoch 0 that ``valid`` reads
through ``MODEL.PRETRAINED`` and ``train`` through ``TRAIN.CONTINUE <out>
TRAIN.FINETUNE True``.

The model is built on ``--device`` (CUDA unless ``--device cpu``); the
file written is the same either way.
"""

from __future__ import annotations

import argparse

import torch

from pemp_tpu_torch.config import load_config, update_config_command
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.pipeline import init_random_weights
from pemp_tpu_torch.train.checkpoint import graft_backbone, load_torch_state_dict, save_checkpoint


def convert(config, pth, out, scheme="plain", mmpose=False, device="cuda"):
    """Writes ``out`` from ``pth``; returns the model with its weights."""
    sd = load_torch_state_dict(pth, scheme)
    model = build_pose_model(config, dtype=torch.float32, device=device, path="valid")
    init_random_weights(model, 0)
    n = graft_backbone(model, sd, mmpose or config.MODEL.KP == "mmpose_hrnet")
    save_checkpoint(out, model, epoch=0)
    print(f"converted {n / 1e6:.1f}M backbone params -> {out}")
    return model


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert a HigherHRNet .pth")
    p.add_argument("--config", required=True)
    p.add_argument("--pth", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--scheme", default="plain")
    p.add_argument("--mmpose", action="store_true")
    p.add_argument("--device", default="cuda")
    args, options = p.parse_known_args(argv)
    config = update_config_command(load_config(args.config), options)
    return convert(config, args.pth, args.out, args.scheme, args.mmpose, args.device)


if __name__ == "__main__":
    main()
