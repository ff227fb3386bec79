"""Checkpoints with ``torch.save`` and ``torch.load`` (counterpart of
pemp_tpu.train.checkpoint, which writes flax msgpack), and the reading of
published ``.pth`` files (the ``.pth`` half of pemp_tpu.train.convert).

One file holds the epoch, the model's ``state_dict`` under the original
reference's key names (so the reference's own ``.pth`` files and the port's
are read alike), the optimizer's state and the step
(reference: src/train.py:497-508, resume at :256-263).
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path, model: torch.nn.Module, optimizer=None, epoch: int = 0,
                    step: int = 0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({
        "epoch": epoch,
        "model_state_dict": model.state_dict(),
        "optimizer_state_dict": optimizer.state_dict() if optimizer is not None else None,
        "step": step,
    }, path)


def _read(path) -> dict:
    with open(path, "rb") as f:
        head = f.read(1)
    # a flax msgpack file starts with a map of its entries (0x81-0x8f);
    # torch.save writes a zip archive, or a pickle (0x80) in its old format
    if head and 0x81 <= head[0] <= 0x8f:
        raise ValueError(f"{path}: a flax msgpack checkpoint of the JAX package, which the "
                         f"port cannot read")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(path, model: torch.nn.Module, optimizer=None):
    """Restores the model's weights and, when given, the optimizer's state;
    returns (epoch, step)."""
    payload = _read(path)
    model.load_state_dict(payload["model_state_dict"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer_state_dict"])
    return int(payload["epoch"]), int(payload["step"])


def from_mmpose_names(sd: dict) -> dict:
    """A ``state_dict`` in mmpose's names in the port's: mmpose's
    BottomUp HigherHRNet keeps the network under ``backbone.*`` and its
    heads (``final_layers``, ``deconv_layers``) under ``keypoint_head.*``,
    and the reference's composite holds that model as its ``backbone``
    (``backbone.backbone.*``, ``backbone.keypoint_head.*``); the port's
    HigherHRNet holds both under ``backbone.*``. The network is the same
    (pemp_tpu/train/convert.py:168-188 strips the same prefixes)."""
    out = {}
    for k, v in sd.items():
        for prefix in ("backbone.backbone.", "backbone.keypoint_head.", "keypoint_head."):
            if k.startswith(prefix):
                k = "backbone." + k[len(prefix):]
                break
        out[k] = v
    return out


def load_params_only(path, model: torch.nn.Module) -> None:
    """Model weights only, from a checkpoint of this module, a file with a
    ``state_dict`` entry or a plain ``state_dict`` (the reference's ``.pth``
    files, read with keys unchanged as pemp_tpu/train/convert.py:155-166's
    ``plain`` scheme reads them, and mmpose's, whose names
    :func:`from_mmpose_names` maps). Only the entries under the model's own
    submodules are read, so the backbone-only model of the AE-grouping
    entry point takes a composite checkpoint's ``backbone.*``; every weight
    of the model must be there."""
    sd = _read(path)
    for key in ("state_dict", "model_state_dict"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    if any(".keypoint_head." in f".{k}" for k in sd):
        sd = from_mmpose_names(sd)
    children = {name for name, _ in model.named_children()}
    model.load_state_dict({k: v for k, v in sd.items() if k.split(".")[0] in children})


# the reference's provenance renames of a .pth's keys
# (reference: PoseEstimation.py:15-27, UpperBound.py:40-48)
RENAME_SCHEMES = {
    "plain": lambda k: k,
    "strip2": lambda k: ".".join(k.split(".")[2:]),   # "model.module.X" -> "X"
    "strip_prefix2char": lambda k: k[2:],              # "1." style prefixes
    "strip1": lambda k: ".".join(k.split(".")[1:]),
}


def load_torch_state_dict(path, scheme: str = "plain") -> dict:
    """A ``.pth`` file's ``state_dict`` (its ``state_dict`` or
    ``model_state_dict`` entry where it has one) with ``scheme``'s rename
    of every key (pemp_tpu/train/convert.py:155-166)."""
    if scheme not in RENAME_SCHEMES:
        raise ValueError(f"rename scheme {scheme!r}: one of {sorted(RENAME_SCHEMES)}")
    sd = _read(path)
    for key in ("state_dict", "model_state_dict"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    rename = RENAME_SCHEMES[scheme]
    return {rename(k): v for k, v in sd.items()}


def graft_backbone(model: torch.nn.Module, sd: dict, mmpose: bool = False) -> int:
    """Loads a HigherHRNet ``state_dict`` (the reference's names, or
    mmpose's with ``mmpose``) into ``model.backbone``; the rest of the
    model keeps its weights. Every backbone weight must be in ``sd``
    (``num_batches_tracked``, which no forward reads, may be absent); a
    missing one raises KeyError by name, entries the backbone does not
    read are ignored. Returns the number of backbone parameters."""
    if mmpose:
        sd = {k: v for k, v in from_mmpose_names(sd).items() if k.startswith("backbone.")}
    else:
        sd = {f"backbone.{k}": v for k, v in sd.items()}
    want = [f"backbone.{k}" for k in model.backbone.state_dict()]
    missing = [k for k in want if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"the .pth lacks {len(missing)} backbone weights: {missing[:8]}")
    model.load_state_dict({k: sd[k] for k in want if k in sd}, strict=False)
    return sum(p.numel() for p in model.backbone.parameters())
