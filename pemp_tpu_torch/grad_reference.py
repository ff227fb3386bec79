"""Gradients of one small training step, on the card and on the CPU in
float32, against a float64 evaluation of the same step on the CPU.

    python -m pemp_tpu_torch.grad_reference [--routes hybrid einsum ...]
        [--ablations NAME ...] [--zoo NAME ...] [--options KEY VALUE ...]
        [--seeds 3 ...] [--edge-first] [--perturb EPS --noise-seeds 0 1 ...]
        [--device cpu]

The small cut (``config.small_train``, or an ablation of
``config.ABLATIONS`` or a delta of ``config.ZOO`` / ``config.ZOO_CUTS``
merged over it, on ``auto``; ``--options`` merged over every one) takes
one training step
from the same seeded weights and batch on each side: the CPU in float64
(the plain versions compute float64 inputs in float64) and in float32, and
the card in float32 twice, with the route's kernels and with their plain
versions in their place (the wrappers' CPU branch run on the card's
tensors). A tensor's error is its largest absolute difference from the
float64 gradient over that gradient's largest. A kernel fault shows as a
kernel run far from float64 where the plain run on the same card is not;
float32 rounding as the float32 runs at like distances.

``--edge-first`` draws the MPN's edge embedding before its node embedding
(the order of the draw, not the model). ``--perturb EPS`` adds CPU float32
sides whose backbone features are scaled by (1 + EPS * noise), one for
each of ``--noise-seeds``: how far an input difference of the size that
separates two float32 backbones moves the gradients. ``--device cpu``
leaves out the card's sides; otherwise it needs a card.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch


def draw_weights(model, seed: int, edge_first: bool = False) -> None:
    """pipeline.init_random_weights, with the MPN's edge embedding drawn
    before its node embedding when ``edge_first``."""
    params = dict(model.named_parameters())
    names = list(params)
    if edge_first:
        node = [n for n in names if n.startswith("mpn.node_embedding.")]
        edge = [n for n in names if n.startswith("mpn.edge_embedding.")]
        at = names.index(node[0])
        names = (names[:at] + edge + node
                 + [n for n in names[at:] if n not in node and n not in edge])
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name in names:
            p = params[name]
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.copy_((torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5).to(p.device))


@contextlib.contextmanager
def plain_versions():
    """The MPN layers' kernel wrappers replaced by their plain versions."""
    from pemp_tpu_torch.models.mpn import layers
    from pemp_tpu_torch.ops.attn_aggregate import fused_attn_aggregate_plain
    from pemp_tpu_torch.ops.fused_step import fused_mpn_step_plain
    from pemp_tpu_torch.ops.segment import blocked_per_type_attention_aggregate
    from pemp_tpu_torch.ops.typed_message import fused_typed_message_plain

    swap = {"fused_mpn_step": lambda *args, plan=None: fused_mpn_step_plain(*args),
            "fused_attn_aggregate": fused_attn_aggregate_plain,
            "blocked_attn_aggregate": blocked_per_type_attention_aggregate,
            "fused_typed_message_aggregate": fused_typed_message_plain,
            "gather_rows_mm_or_plain": lambda x, j, n_img, plan=None: x[j]}
    real = {name: getattr(layers, name) for name in swap}
    for name, fn in swap.items():
        setattr(layers, name, fn)
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(layers, name, fn)


def step_grads(cfg, device: str, dtype, seed: int, edge_first: bool, batch,
               perturb=None) -> dict:
    """Each parameter's gradient (float64, on the CPU) of one training step
    of ``cfg`` on ``device`` in ``dtype``; ``perturb`` (eps, noise seed)
    scales the backbone's gathered features by (1 + eps * noise)."""
    from pemp_tpu_torch.models.mpn.layers import MPLayer
    from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer

    trainer = build_trainer(cfg, device=device, seed=seed)
    draw_weights(trainer.model, seed, edge_first)
    layer = trainer.model.mpn.mpn_node_cls
    if isinstance(layer, MPLayer):
        # an MPLayer sums up to C messages unnormalised: its message
        # weights are scaled to keep the features in range, as the tests do
        with torch.no_grad():
            layer.mlp_node[0].weight.mul_(0.01)
    if perturb is not None:
        eps, noise_seed = perturb
        gen = torch.Generator(device="cpu").manual_seed(noise_seed)

        def scaled(module, inputs, out):
            return out * (1 + eps * torch.randn(out.shape, generator=gen).to(out))

        trainer.model.feature_gather.register_forward_hook(scaled)
    tbatch = batch_to_torch(batch, device)
    if dtype == torch.float64:
        trainer.model.double()
        trainer.model.dtype = dtype
        tbatch = {k: [x.double() for x in v] if isinstance(v, list) else
                  (v.double() if v.is_floating_point() else v) for k, v in tbatch.items()}
    loss, _, _ = trainer.loss(tbatch)
    loss.backward()
    return {k: p.grad.double().cpu() for k, p in trainer.model.named_parameters()
            if p.grad is not None}


def compare(cfg, label: str, seed: int, edge_first: bool, card: bool = True,
            eps: float = 0.0, noise_seeds=()) -> dict:
    """The sides of one step; prints each float32 side's worst tensors
    against float64 and returns {side: {tensor: error}}."""
    from pemp_tpu_torch.data.synthetic import make_batch

    batch = make_batch(np.random.RandomState(5), cfg.TRAIN.BATCH_SIZE, 64, (16, 32),
                       cfg.DATASET.NUM_JOINTS, 30, scale_range=(0.4, 0.9))
    g64 = step_grads(cfg, "cpu", torch.float64, seed, edge_first, batch)
    grads = {"cpu f32": step_grads(cfg, "cpu", torch.float32, seed, edge_first, batch)}
    for s in noise_seeds:
        grads[f"cpu f32 features x (1 + {eps:g} noise {s})"] = step_grads(
            cfg, "cpu", torch.float32, seed, edge_first, batch, (eps, s))
    if card:
        grads["card kernels"] = step_grads(cfg, "cuda", torch.float32, seed, edge_first, batch)
        with plain_versions():
            grads["card plain"] = step_grads(cfg, "cuda", torch.float32, seed, edge_first,
                                             batch)
    # a gradient zero but for rounding has no largest to be relative to
    top = max(g.abs().max().item() for g in g64.values())
    errors = {side: {k: ((g[k] - g64[k]).abs().max() / g64[k].abs().max()).item()
                     for k in g64 if g64[k].abs().max() > 1e-12 * top}
              for side, g in grads.items()}
    draw = f"seed {seed}{' edge-first' if edge_first else ''}"
    for side, err in errors.items():
        worst = sorted(err.items(), key=lambda kv: -kv[1])[:5]
        print(f"{label} {draw} {side}: worst against float64 "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst))
    last = list(errors)[-1]
    at = max(errors[last], key=errors[last].get)
    print(f"{label} {draw}: at {last}'s worst tensor {at}: "
          + ", ".join(f"{side} {err[at]:.3e}" for side, err in errors.items()), flush=True)
    return errors


def main(argv=None) -> None:
    from pemp_tpu_torch.config import ablation, small_train, update_config_command, zoo

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--routes", nargs="*", default=["auto", "hybrid", "einsum", "dots"])
    ap.add_argument("--ablations", nargs="*", default=[])
    ap.add_argument("--zoo", nargs="*", default=[])
    ap.add_argument("--options", nargs="*", default=[])
    ap.add_argument("--seeds", nargs="*", type=int, default=[3])
    ap.add_argument("--edge-first", action="store_true")
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--noise-seeds", nargs="*", type=int, default=[])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    card = args.device == "cuda"
    if card and not torch.cuda.is_available():
        raise SystemExit("grad_reference needs a card: torch.cuda.is_available() is false "
                         "(--device cpu leaves out the card's sides)")
    noise = args.noise_seeds if args.perturb else []
    torch.set_num_threads(4)
    def cut():
        return update_config_command(small_train(), args.options)

    for seed in args.seeds:
        for route in args.routes:
            cfg = cut()
            cfg.TPU.MSG_PASS = route
            compare(cfg, f"small_train {route}", seed, args.edge_first, card, args.perturb,
                    noise)
        for name in args.ablations:
            compare(ablation(name, cut()), name, seed, args.edge_first, card,
                    args.perturb, noise)
        for name in args.zoo:
            compare(zoo(name, cut()), name, seed, args.edge_first, card, args.perturb, noise)


if __name__ == "__main__":
    main()
