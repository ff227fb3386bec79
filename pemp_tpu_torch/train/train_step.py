"""The training step and the validation step (counterpart of
pemp_tpu.train.train_step's ``make_train_step`` and ``make_eval_step``;
reference: src/train.py:115-184, 351-495): forward in training mode,
graph-reduction edge masks, the multi-loss, backward, the optimizer update,
and the skip of a step whose loss or any gradient is not finite; the
validation step is the same forward and loss in eval mode, without
gradients.

The JAX step is a pure function that selects the old parameters, optimizer
state and BatchNorm statistics on a skipped step. Here the forward updates
the MPN's running statistics in place, so the step snapshots them first
and puts them back on a skip; parameters and optimizer state are left
alone, because the finiteness test comes before the update.

Under data parallelism (parallel.distributed; the JAX package's
``shard_train_step``) each rank steps on its rows of the global batch: the
BatchNorm moments and the loss normalisers are global in the forward, and
after the backward one all-reduce sums the updated parameters' gradients,
the loss and its parts and the ranks' non-finite flags. Every rank then
holds the global batch's gradient and loss, and all take the same update
or all skip it, so the parameters stay the same on every rank.
"""

from __future__ import annotations

import torch

from pemp_tpu_torch.config.defaults import msg_pass_route, plain_route, unblocked_by
from pemp_tpu_torch.losses.factories import mask_node_connections
from pemp_tpu_torch.parallel import distributed


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A loss part as a tensor on ``like``'s device (a Python number is
    filled there, not copied from the host)."""
    return v.detach() if torch.is_tensor(v) else like.new_full((), float(v))


def _running_stats(model: torch.nn.Module) -> dict:
    return {name: buf for name, buf in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))}


class TrainStep:
    """``step(batch) -> (loss, logging)``; ``fail_count`` counts skipped
    steps (the reference's oom_counter abort guard, src/train.py:276-299).

    ``batch`` holds torch tensors on the model's device: imgs (B, H, W, 3),
    heatmaps [per scale (B, h, w, J)], masks [per scale (B, h, w)],
    keypoints (B, P, J, 3) in the last scale's coordinates, factors
    (B, P, J), and for the tag-map loss ae_targets [per scale (B, P, J, 2)].
    ``steps`` counts the calls of ``step``, skipped ones too (the JAX
    state's ``step``).
    """

    def __init__(self, model, loss_factory, optimizer, config):
        self.model = model
        self.loss_factory = loss_factory
        self.optimizer = optimizer
        self.node_threshold = config.MODEL.MPN.NODE_THRESHOLD
        self.include_bordering = config.MODEL.LOSS.INCLUDE_BORDERING_NODES
        # validation runs the training route (msg_pass_route's train path)
        self.train_route = msg_pass_route(config.TPU.MSG_PASS, True, plain_route(config),
                                          unblocked_by(config))
        self.fail_count = 0
        self.steps = 0
        self.last_output = None   # labels and validity of the last step
        # a list to gather the CUDA events of each step's gradient
        # all-reduce in (before and after its packing, after the
        # all-reduce; train() sets it); None records nothing
        self.reduce_events = None

    def loss(self, batch, train: bool = True):
        """Forward and loss (pemp_tpu/train/train_step.py:56-96); returns
        (loss, logging, output). Puts the model in training mode, or with
        ``train=False`` in eval mode on the training route, as
        make_eval_step (:134-175) does. The GT heatmaps go to the model (for
        ``WEIGHT_CLASS_LOSS``); no graph draws, as make_train_step passes
        the model no key: method 7 injects the GT joints without jitter."""
        self.model.train(train)
        _, output = self.model(batch["imgs"], keypoints_gt=batch["keypoints"],
                               masks=batch["masks"][-1], factors=batch["factors"],
                               route=self.train_route, heatmaps=batch["heatmaps"])
        labels, masks, preds = output["labels"], output["masks"], output["preds"]
        masks["heatmap"] = batch["masks"]
        labels["heatmap"] = batch["heatmaps"]
        labels["tag"] = batch.get("ae_targets")
        labels["num_images"] = batch["imgs"].shape[0]
        # graph reduction: the edge loss only between predicted or labelled
        # positive nodes (reference: train.py:140-154); an MPN without a
        # node head (VanillaMPN: node [None]) keeps every labelled edge
        edge_masks, edge_labels = [], []
        for pred_node in preds["node"]:
            edge_labels.append(labels["edge"])
            if pred_node is None:
                edge_masks.append(masks["edge"])
                continue
            m = mask_node_connections(
                torch.sigmoid(pred_node.detach()), output["graph"]["edge_index"],
                self.node_threshold, labels["node"],
                include_bordering_nodes=self.include_bordering)
            edge_masks.append(masks["edge"] * m.float())
        labels["edge"] = edge_labels
        masks["edge"] = edge_masks
        loss, logging = self.loss_factory(preds, labels, masks, output["graph"])
        return loss, logging, output

    def step(self, batch):
        """One update; returns (loss, logging) with ``logging["skipped"]``
        1.0 where the step was skipped."""
        saved = {k: v.clone() for k, v in _running_stats(self.model).items()}
        self.steps += 1
        self.optimizer.zero_grad()
        loss, logging, output = self.loss(batch)
        loss.backward()
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        finite = torch.isfinite(loss)
        if grads:
            finite = finite & torch.stack([torch.isfinite(g).all() for g in grads]).all()
        if distributed.active():
            loss, logging, finite = self._all_reduce(loss, logging, finite)
        if bool(finite):
            self.optimizer.step()
        else:
            # the JAX step keeps the old state: put back the statistics the
            # forward updated; the update was never made
            with torch.no_grad():
                for name, buf in _running_stats(self.model).items():
                    buf.copy_(saved[name])
            self.fail_count += 1
        # what a caller may count (labels, masks, the detached predictions,
        # validity), without the graph
        self.last_output = {
            "labels": output["labels"], "masks": output["masks"],
            "preds": {k: [p if p is None else p.detach() for p in v] if isinstance(v, list)
                      else v for k, v in output["preds"].items()},
            "graph": {k: output["graph"][k] for k in ("node_valid", "edge_valid")}}
        logging = {k: (v.detach() if torch.is_tensor(v) else torch.tensor(v))
                   for k, v in logging.items()}
        logging["skipped"] = torch.tensor(0.0 if bool(finite) else 1.0)
        return loss.detach(), logging

    def _all_reduce(self, loss, logging, finite):
        """One all-reduce of the updated parameters' gradients (zeros where
        a rank has none, as SplitAdamW's step fills them), the loss, its
        parts and the non-finite flags. Sets each gradient to its sum and
        returns the summed (loss, logging, finite)."""
        params = [p for group in self.optimizer.opt.param_groups for p in group["params"]]
        keys = list(logging)
        dev = loss.device
        parts = [_scalar(logging[k], loss) for k in keys]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        marks = None
        if self.reduce_events is not None and dev.type == "cuda":
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            self.reduce_events.append(marks)
        sums = distributed.all_sum_flat([loss.detach(), (~finite).to(loss.dtype), *parts,
                                         *grads], marks)
        loss, flags, parts, grads = sums[0], sums[1], sums[2: 2 + len(keys)], sums[2 + len(keys):]
        for p, g in zip(params, grads):
            p.grad = g
        # a rank whose loss or any gradient is not finite makes every rank skip
        return loss, dict(zip(keys, parts)), (flags == 0) & torch.isfinite(loss)

    @torch.no_grad()
    def eval_step(self, batch, with_output: bool = False):
        """The validation loss of ``batch``: (loss, logging), no update;
        under data parallelism summed over the ranks. ``with_output``
        appends the forward's output (preds, labels, masks with the graph
        reduction's edge masks, graph), as make_eval_step returns it."""
        loss, logging, output = self.loss(batch, train=False)
        keys = list(logging)
        sums = distributed.all_sum_flat([loss, *(_scalar(logging[k], loss) for k in keys)])
        if with_output:
            return sums[0], dict(zip(keys, sums[1:])), output
        return sums[0], dict(zip(keys, sums[1:]))


def batch_to_torch(batch: dict, device) -> dict:
    """A numpy batch (``data.synthetic.make_batch``,
    ``data.datasets.default_collate``) as torch tensors."""
    def conv(x):
        if isinstance(x, list):
            return [conv(v) for v in x]
        return torch.from_numpy(x).to(device)
    return {k: conv(v) for k, v in batch.items()}


def build_trainer(config, device="cuda", seed: int = 0, steps_per_epoch: int = 1000,
                  model=None):
    """The training path for ``config`` (float32, as tools/train.py builds
    it): ``model`` (a build_pose_model on the training path, with its
    weights) or one with seeded random weights; runs on CUDA unless
    ``device="cpu"``. ``steps_per_epoch`` places the learning-rate steps
    (SplitAdamW). Raises on settings the training path does not implement.

    On CUDA it turns TF32 off for matmuls and cuDNN convolutions (PyTorch
    leaves it on for cuDNN by default), so the step computes in the float32
    that tools/train.py builds it in; the card's checks and timings run in
    this state."""
    from pemp_tpu_torch.losses.factories import dispatch_loss_func
    from pemp_tpu_torch.models.pose_estimation import build_pose_model, resolve_device
    from pemp_tpu_torch.pipeline import init_random_weights
    from pemp_tpu_torch.train.optim import SplitAdamW

    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if model is None:
        model = build_pose_model(config, dtype=torch.float32, device=device, path="train")
        init_random_weights(model, seed)
    return TrainStep(model, dispatch_loss_func(config),
                     SplitAdamW(config, model, steps_per_epoch), config)
