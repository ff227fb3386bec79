"""Optimizer: split-LR AdamW with backbone freezing and a MultiStepLR
schedule counted in steps (counterpart of pemp_tpu.train.optim; reference:
src/train.py:229-253, freeze modes PoseEstimation.py:113-139).

The JAX package labels each parameter ``mpn`` (everything outside the
backbone, at ``TRAIN.LR`` with ``TRAIN.W_DECAY``), ``backbone`` (at
``TRAIN.KP_LR`` with ``TRAIN.KP_W_DECAY``) or ``frozen`` (never updated),
and runs ``optax.adamw`` with decoupled decay (``optax.adam`` where the
decay is 0). ``torch.optim.AdamW`` is the same update; its decay is given
explicitly here, never left at torch's 0.01 default. optax updates every
parameter of a group, with a zero gradient where the loss does not reach
it (the decay, and Adam's moments decaying); torch skips a parameter whose
``grad`` is None, so ``step()`` gives such a parameter zeros first.
"""

from __future__ import annotations

import bisect

import torch

_STEM_PREFIXES = ("conv1", "bn1", "conv2", "bn2", "layer1")


def param_label(name: str, freeze_mode: str, end_to_end: bool) -> str:
    """'mpn', 'backbone' or 'frozen' for the parameter ``name`` of the
    composite model (pemp_tpu.train.optim.param_partition)."""
    parts = name.split(".")
    if parts[0] != "backbone":
        return "mpn"
    if freeze_mode == "complete" or not end_to_end:
        return "frozen"
    if freeze_mode == "stem":
        return "frozen" if parts[1] in _STEM_PREFIXES else "backbone"
    # "nothing" / "from_scratch": everything trains
    return "backbone"


def param_partition(model: torch.nn.Module, freeze_mode: str, end_to_end: bool) -> dict:
    """{label: [(name, parameter), ...]} over the model's parameters."""
    groups = {"mpn": [], "backbone": [], "frozen": []}
    for name, p in model.named_parameters():
        groups[param_label(name, freeze_mode, end_to_end)].append((name, p))
    return groups


def multistep_lr(base_lr: float, lr_steps, lr_factor: float, steps_per_epoch: int,
                 step: int) -> float:
    """MultiStepLR in steps: ``base_lr`` times ``lr_factor`` for each epoch
    boundary of ``lr_steps`` that ``step`` (updates done so far) has
    reached (optax.piecewise_constant_schedule over the boundaries
    ``{epoch * steps_per_epoch: lr_factor}``: a boundary given twice counts
    once, as a dict key)."""
    bounds = sorted({int(e) * steps_per_epoch for e in lr_steps})
    return base_lr * lr_factor ** bisect.bisect_right(bounds, step)


class SplitAdamW:
    """AdamW over the ``mpn`` and ``backbone`` groups with their own
    learning rates, decays and schedules; ``frozen`` parameters are left
    out. ``step()`` sets each group's rate for the update about to be made,
    then updates."""

    def __init__(self, config, model: torch.nn.Module, steps_per_epoch: int = 1000):
        t = config.TRAIN
        groups = param_partition(model, t.KP_FREEZE_MODE, t.END_TO_END)
        self.schedule = {"mpn": t.LR, "backbone": t.KP_LR}
        self.lr_steps, self.lr_factor = list(t.LR_STEP), t.LR_FACTOR
        self.steps_per_epoch = steps_per_epoch
        decay = {"mpn": t.W_DECAY, "backbone": t.KP_W_DECAY}
        param_groups = [
            {"params": [p for _, p in groups[k]], "name": k, "lr": self.schedule[k],
             "weight_decay": decay[k]}
            for k in ("mpn", "backbone") if groups[k]
        ]
        self.frozen = [p for _, p in groups["frozen"]]
        self.opt = torch.optim.AdamW(param_groups, betas=(0.9, 0.999), eps=1e-8)
        self.count = 0     # updates made, as optax's schedule count

    def step(self) -> None:
        for group in self.opt.param_groups:
            group["lr"] = multistep_lr(self.schedule[group["name"]], self.lr_steps,
                                       self.lr_factor, self.steps_per_epoch, self.count)
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.opt.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)
        for p in self.frozen:
            p.grad = None

    def state_dict(self) -> dict:
        """AdamW's moments and the schedule's count (optax's opt_state)."""
        return {"adamw": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["adamw"])
        self.count = int(state["count"])
