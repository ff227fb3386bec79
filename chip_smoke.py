"""Drives the PyTorch port's eval and training paths on one NVIDIA card and
checks them.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: a CUDA card is required; prints its name and power limit.
2. build: compiles every kernel of the path from ``pemp_tpu_torch/csrc``
   (one nvcc per source, all started together).
3. K1 (``fused_mpn_step``) against its plain PyTorch version on the card,
   TF32 off: at the flagship eval shapes on seeded random inputs (f32, the
   CUDA-core form, within 1e-4; bf16, the tensor-core form, each output
   within 2e-2 of its largest), at ragged shapes (C = 77, 85 nodes per
   image, no multiple of either form's node tile; bf16 at T = 17, f32 at
   T = 14), and on the inputs the
   w48/640 main path feeds it at MPN steps 0 and 9 (bf16); two calls must
   give the same bits. Logs which form serves each dtype; prints errors,
   kernel and plain ms per launch (CUDA events, median of 25 launches) and
   the bound.
4. small slice: the narrow test configuration with the same seeded weights
   on the CPU (plain versions) and on the card (kernels); MPN outputs and
   persons must agree. Then decode alone on hand-built scenes that form
   persons (random weights form none), CPU against card.
5. main path: HigherHRNet-w48 at 640, batch 8, bf16, seeded random weights:
   backbone -> detection -> kNN graph -> 10-step MPN -> decode. Launch
   counts are zeroed just before and read just after; K1 must launch 10
   times per forward. Prints img/s, peak memory and graph sizes.
6. K2 and K2b through their wrapper ``fused_typed_message_aggregate``
   (forward, and ``torch.autograd.grad`` through it) against their plain
   PyTorch version and autograd through it on the card, TF32 off: on
   seeded random f32 inputs at the model_58_4 shapes and on the inputs the
   model_58_4 training path feeds at MPN steps 0 and 9; out, d_ef, da, dwe
   and dwa each within 1e-4 of its own largest value. Prints errors,
   kernel and plain ms (CUDA events, median of 25; the backward alone on a
   kept graph) and the bounds; at step 0 also the device ms of K2's launch,
   of each of K2b's two launches (main pass, reduction) and of any other
   kernel of the forward or backward, by kernel name from
   ``torch.profiler``, and how the valid slots fall into (node, type)
   groups and the two kernels' blocks.
7. small training step, CPU against card: ``small_train()`` with the same
   seeded weights and synthetic batch; labels exact, loss parts, every
   parameter's gradient and the MPN's running statistics.
8. training at full width: model_58_4 (HigherHRNet-w32 at 512, batch 8,
   f32, synthetic batches, seeded random weights), one warm-up step, then
   3 timed steps with the counts zeroed just before; K2, K2b and G1 (the
   source gather's backward) must launch 10 times each per step, the loss
   must be finite and no step skipped.
   Prints steps/s, img/s, peak memory and the graph and label counts.
9. K3 and K3b (the hybrid path's attention aggregation) through their
   wrapper ``fused_attn_aggregate`` (forward, and ``torch.autograd.grad``
   through it) against their plain version, TF32 off: on seeded random f32
   inputs at the model_58_4 shapes and on the inputs the hybrid model_58_4
   training path feeds at MPN steps 0 and 9 (out, db, da, dlogit each
   within 1e-4 of its own largest value), and forward in bf16 on the hybrid
   w48/640 eval path's step-0 inputs (2e-2 of its largest). Prints errors,
   kernel and plain ms (median of 25; the backward alone on a kept graph)
   and the bounds; at the training path's step 0 also the device ms of
   K3's and K3b's launches and of any other kernel of the forward or
   backward, by kernel name from ``torch.profiler``, and the graph's valid
   rows per node and largest group.
10. K4 (the einsum path's blocked aggregate) against its plain version on
   the einsum w48/640 eval path's step-0 inputs (bf16, 2e-2) and on random
   f32 inputs (1e-4), a second call bit-identical; K4 on relu(a_sel + b)
   against K3 on (b, a) (1e-5 of its largest). Prints errors, kernel and
   plain ms (median of 25) and the bounds; at the eval step 0 also K4's
   device ms by kernel name from ``torch.profiler``, the graph's valid rows
   per node and largest group, and the warps of K4 one SM holds.
11. small slices on the reverse-permutation routes, CPU against card: a
   hybrid small training step as phase 7, and the hybrid and einsum small
   eval slices as phase 4.
12. full width per route, the counts zeroed just before each run and read
   just after: 3 hybrid model_58_4 training steps (K3, K3b and G1 10 times
   each per step, no K2), 5 hybrid w48/640 forwards (K3 10 times per
   forward, no K1), 5 einsum w48/640 forwards (K4 10 times per forward, no
   K1 or K3). Prints steps/s or img/s and peak memory per route.
13. K2's bf16 form (``fused_typed_message_aggregate`` on bf16 inputs, the
   tensor-core kernel) against its plain version on the pallas w48/640
   eval path's step-0 inputs: out within 1e-4 of its largest, one launch,
   a second call bit-identical, empty groups exactly 0 over NaN-filled
   memory, a gradient refused. Logs the form; prints errors, kernel and
   plain ms (median of 25), the bound and K2's device ms from
   ``torch.profiler``.
14. K4b (the blocked aggregate's backward, through K4's autograd Function)
   against its factored plain form and against autograd through the plain
   version, on the einsum model_58_4 training path's step-0 inputs and
   cotangent and on random f32 inputs: dm and dlogit each within 1e-4 of
   its largest, exact zeros on the slots of no group, a second backward
   bit-identical. Prints errors, ms (the backward alone on a kept graph),
   the bound, K4's and K4b's device ms and the graph's rows and groups.
15. G1 (``gather_rows_bwd``) against its plain version on the pallas
   model_58_4 training path's first source gather (its plan and
   cotangent), and on the dots path's two projection selections at step 0:
   within 1e-5 of the largest, a second call bit-identical; prints whether
   it equals the CPU plain version bit for bit, its ms, the plain
   version's, and those of ``index_add_`` and autograd's ``x[j]``
   backward on the same rows (the library calls), and the bound.
16. small slices on pallas and dots (eval) and small training steps on
   einsum and dots, CPU against card, as phases 4 and 7.
17. full width on the new routes, the counts zeroed just before each run
   and read just after: 5 pallas w48/640 forwards (K2's bf16 form 10 times
   per forward, no K2b), 5 dots forwards (K4 10 times), 3 einsum and 3 dots
   model_58_4 training steps (K4 and K4b 10 times each per step, G1 20
   times on einsum and 30 on dots: the source gather and the projection's
   selections).

18. small TTA slice, CPU against card: the narrow configuration at scales
   [1.0, 0.5] with flip on two images of different sizes, the same seeded
   weights on both; aggregated scoremaps, tags and node features within
   1e-4 of each one's largest, graphs exact, persons within 2e-3.
19. the eval entry point at full width (``valid.evaluate``, batches of 8):
   w48/640 with flip at scales [2.0, 1.0, 0.5], bf16, threshold decode on
   the 8 rendered images of 480x640, one batch of 8 (cut from 16 images
   in two shapes for the time limit when phases 40-41 came). The seeded
   weights get BatchNorm statistics measured on the images, so that
   persons form (full_width_model). First the pipeline over the images:
   the card's persons are held against the CPU's decode of the same
   outputs (2e-3), and there must be some. Then a run with the counts
   zeroed just before and read just after (K1 10 times a batch), timed,
   whose results file must hold persons; prints img/s and peak memory.
   Then a run with each stage timed (host warp, backbone, projection,
   graph + MPN, decode, scoring), which synchronises the card at each
   stage's end and so gives the split but not the rate.
20. model_58_4 as its file says (w32/512, one scale, no flip, GAEC on the
   host through the g++ library built at first use) on the same images,
   the node threshold lowered from the file's 1.0 (which no sigmoid score
   passes) to 0.5; the same three runs, the host clustering and its decode
   held against the same clustering decoded on the CPU; prints img/s and
   the host clustering's share.
21. scoring: the ground truth as detections scores AP 1.0 through the
   port's KeypointEval; noisy detections score the stats the CPU tests pin
   against the JAX package.
22. the training entry point on the small cut, CPU against card, through
   ``train.__main__.train``: a COCO-format set of 16 rendered images
   (480x640 and 640x480; two with a crowd RLE, so the ignore mask runs)
   served as training samples with the augmentation, one epoch of 2
   steps plus validation, the same batches and seeded weights on both
   sides, for (a) model_58_4's options and (b) label method 4 with the
   neighbour pass, the greedy matcher, the tag-map loss and the backbone's
   BatchNorm in training mode. Labels exact; the first step's loss parts
   within 5e-3 of their size; its gradients within 5e-3 of each tensor's
   largest ((b) with the backbone in float64 on both sides: its float32
   gradients are ill-conditioned, see f64_backbone_grads); (b)'s backbone
   running statistics after the step within 1e-4 of each tensor's
   largest; validation losses within 1e-3 relative.
23. the training entry point at full width: model_58_4 as its preset
   gives it (w32/512, batch 8, f32, pallas, WORKERS loader threads) on 32
   rendered training and 8 validation images, 2 epochs of 4 steps with
   LR_STEP [1] (one snapshot), the counts zeroed before and read after
   (K2 10 a step and a validation batch, K2b and G1 10 a step); then
   CONTINUE for one more epoch (the saved epoch again, the first rate
   multistep_lr's at the restored count) and FINETUNE from the snapshot
   for one step. Losses finite, no step skipped, metrics.jsonl with the
   loss parts, the checkpoint's epoch and the snapshot. Prints img/s over
   the timed epoch, its loader-wait share, device time a step and peak
   memory.

24. the small Hourglass (2 stacks 16 wide at 512, long-side scaling)
   through TTAPipeline's ``maps_only`` at scales [1.0, 0.5] with flip,
   CPU against card (maps within 1e-4 of each one's largest; HG's parser
   on both sides' maps); and model_81_1_2's small cut (14 joint types) as
   phases 4 (fused-step eval slice, node threshold 0.1) and 7 (pallas
   training step), CPU against card.
25. K1, K2 and K2b at T = 14: K1 on the step-0 inputs of model_81_1_2's
   eval path (bf16, batch 8 at 480x640: N = 4480) within 2e-2 of each
   output's largest, K2 and K2b on its training path's step-0 inputs and
   cotangent (f32, batch 8) within 1e-4 of each output's largest; kernel,
   plain and bound ms as phases 3 and 6.
26. model_81_1_2 through ``valid.evaluate`` at full width (w32/512, bf16,
   one scale, GAEC on the host at node threshold 0.5 as phase 20, CrowdPose
   scoring) on 16 rendered images with 14 joints, as phase 20: K1 10
   times a batch.
27. model_81_1_2 training at full width (w32/512, batch 8, f32, pallas,
   synthetic 14-joint batches): one warm-up step and 3 timed steps, K2,
   K2b and G1 10 times each a step, losses finite; prints the device time
   a step.
28. the AE-grouping entry point at full width (``valid_hr.evaluate``,
   f32, batches of 8) on phase 19's 8 images, one batch (cut from 16 for
   the time limit when phases 40-41 came): hg_512 (4 stacks 256 wide
   at 512, long-side scaling) with the hg and hg2 parsers, and w32/512
   with flip and the hr parser. Seeded weights whose output heads are
   scaled from the images so that persons form (ae_full_width_model). Per
   configuration the card's maps against the CPU's on two images (1e-4);
   per parser the results files (AE grouping and correlation clustering)
   must hold persons and equal the host's parse of the card's maps; prints
   img/s, the stage split, and peak memory.

29. the ablation configurations (config.ABLATIONS: model_58_4 with a
   delta of configs/connectivity, configs/feature_importance or
   configs/train merged) on the small cut, CPU against card, as phases 4
   and 7: eval slices of fully and score_based (edge lists, the segment
   route), model_gostic_position (MPLayer on the kNN layout) and
   model_nothing (one-column edge features into K1); training steps of
   those four's graphs and of model_50_4 (VanillaMPN, the edge loss,
   frozen backbone), model_nothing through K2, K2b and G1. The training
   steps hold the card's gradients against the CPU's float64 step: each
   within 5e-3 of its largest, or 1.5 times the CPU's own float32 error
   where that is larger (ill-conditioned at these random weights), never
   past F64_CAP = 2e-2; the loosened tensors are printed with both
   readings.
30. ``valid.evaluate`` at full width as phase 20 (model_58_4, w32/512,
   bf16, one scale, GAEC at node threshold 0.5) on the 8 rendered images
   of 480x640 (one batch; cut from 16 for the time limit, the first depth
   to go as the smoke grew past 950 s) for fully, score_based, score_based_per_type,
   model_gostic_position and model_nothing: K1 10 times a batch on
   model_nothing and never on the others; each configuration's persons
   equal to the host clustering of the same outputs on the CPU on half of
   the images (even and odd halves in turn, cut from all 8 for the time
   limit); prints img/s, the stage split, peak memory and the valid edges
   a batch.
31. training at full width (model_58_4, batch 8, f32, synthetic batches),
   one warm-up and 3 timed steps, for score_based, model_gostic_position,
   model_50_4 and model_nothing: K2, K2b and G1 10 times a step on
   model_nothing, no kernel on the others; prints the device time a step
   and peak memory.

32. graphs on the GT joints on the small cut, CPU against card, as phase
   29: training steps with label method 7 and the weighted class loss
   (pallas) and with USE_GT and method 2 (pallas, dots).
33. model_58_4 at full width through ``train()`` (w32/512, batch 8, f32,
   pallas, 4 steps on synthetic batches) with method 7 and the weighted
   class loss, then with USE_GT and method 2: K2, K2b and G1 10 times a
   step; prints the device time a step and the peak memory; K2 and K2b
   held against their plain versions on the USE_GT layout at this width
   (MPN steps 0 and 9 of one step).
34. the upper bounds: ``calc_upper_bounds.evaluate`` on the 16 rendered
   images on the card and on the CPU (the same persons and stats; prints
   the AP), and UpperBoundModel at full width for the three upper_bound
   files (graph and labels exact against the CPU's graph on the card's
   maps; no kernel launches).

35. the tag-regression, background-class and group-based configurations
   (config.ZOO; MPNTag and JointTypeClassification from config.ZOO_CUTS)
   on the small cut, CPU against card, as phase 29: eval slices (every
   head, the tags too, within 2e-3) and training steps on ``auto`` of tag
   (NODE_STEPS 0 and 2; fused step at eval, K2/K2b/G1 in training),
   pure_tag (MPNTag, SYNC_TAGS; no kernel), group_based (pallas in both
   modes), background and joint_type; the greedy grouping of the narrow
   configuration's outputs equal on card and CPU.
36. ``valid.evaluate`` at full width as phase 20 (model_58_4, bf16, one
   scale, node threshold 0.5) on phase 30's 8 images of 480x640 (cut from
   16 as the smoke passed 950 s) for tag (grouped by
   its tags on the host) and greedy: K1 10 times a batch; each run's
   persons equal to the host grouping of the same outputs on the CPU, on
   the even images for tag and the odd for greedy (cut from all 8 for the
   time limit); prints img/s, the stage split and the peak memory.
37. model_58_4 at full width through ``train()`` (w32/512, batch 8, f32,
   pallas, 4 steps on synthetic batches) for tag, background and
   group_based: K2, K2b and G1 10 times a step (20 on group_based, two
   masked passes a step); prints the device time a step and the peak
   memory; K2 and K2b held against their plain versions on group_based's
   within-part and cross-part masks at MPN steps 0 and 9.

38. the research zoo (config.ZOO's simple, two_phase and self_attention and
   config.ZOO_CUTS' other seven) on the small cut, CPU against card, as
   phase 35: eval slices (every head within 2e-3) and training steps on
   ``auto`` held to phase 29's float64-bound limits; the counts zeroed just
   before each card run and read just after: on the six on the flagship's
   layer K1 once an MPN pass at eval and K2, K2b and G1 once a pass in
   training (K2b one fewer on Simple and Simple2, whose last pass's nodes
   reach no head), on the four MPLayer or VanillaMPN2 models no kernel.
39. the zoo at full width (model_58_4's w32/512, batch 8): simple through
   ``valid.evaluate`` as phase 36 (bf16, one scale, GAEC at node threshold
   0.5) on phase 19's 8 images, one batch (cut from 16 for the time
   limit when phases 40-41 came) with K1 12 times a batch (STEPS + EDGE_STEPS); simple (K2 and G1
   12 a step, K2b 11), two_phase and self_attention (no kernel) through
   ``train()``, 4 steps in f32; prints img/s, the device time a step and
   the peak memory.

40. data parallelism through the training entry point: ``python -m
   torch.distributed.run --standalone --nproc_per_node=1 -m
   pemp_tpu_torch.train`` (NCCL, a group of one) on model_58_4 at full
   width (w32/512, batch 8, f32, pallas, synthetic batches, 2 epochs of 2
   steps); the child must exit 0, and its summary line must show K2, K2b
   and G1 10 times a step and nothing else, no step skipped and a
   gradient all-reduce; prints its device time a step beside phase 23's
   and the all-reduce's ms a step (CUDA events), and its peak memory.
41. two ranks on the one card under gloo (NCCL refuses two ranks on one
   GPU), fresh processes, against one process on the card: the small cut
   (global batch 4) for 2 steps, loss parts within 1e-4, the first step's
   gradients within phase 29's limits, parameters bit-identical across the
   ranks; ``valid.evaluate`` on phase 19's 8 images (model_58_4, one
   scale, GAEC at 0.5; a rank holds 4, so it runs one batch of 4), rank
   0's merged results equal to those of one process run on the ranks'
   two batches of 4, rank 1 returning None, no part file left.

42. the overfit tool at full width (``overfit.overfit``; model_58_4's
   preset: w32/512, batch 8, f32, pallas) on its fixed batch, 30
   iterations printing every 10: the last loss below the first, K2, K2b
   and G1 10 times a step and K2 10 an eval pass; prints the time an
   iteration and the peak memory.
43. tests/test_overfit.py's learning check on the card at its cut
   (``config.overfit_cut()``) and batch: the training forward's edge and
   node precision and recall and class accuracy must reach 0.9 within 400
   steps (checked every 25); prints the step that reaches it. K2, K2b and
   G1 once a pass.
44. the checkpoint converter at w48/640: a seeded backbone as a
   published-layout .pth under the four rename schemes and in mmpose's
   names, each converted backbone equal to it bit for bit; then the main
   path (bf16, batch 8) on the converted weights through
   ``load_params_only``: one forward, K1 10 times.
45. the drawing tool with ``--detail`` (``draw_images.draw``) at w48/640
   on phase 19's 8 images, one a call: K1 10 times an image, 8 PNGs an
   image whose sizes are checked by decoding them (no PIL on the card's
   machine).
46. ``comp_graph_stats`` (model_58_4's sizes, the training augmentation)
   on the 8 images, its first 2 also on the CPU with the same lines, and
   ``measure_deviations`` at input 512: four rows, AP above 0.5 at the
   shipped capacity; no kernel launches.

47. K1's autograd Function (forward K1's f32 form; backward K2b on the
   typed message and attention tail, K1b on the edge MLP, G1 on the source
   gather) against autograd through K1's plain version on the card, TF32
   off: on seeded random f32 inputs and cotangents at the model_58_4
   training shapes, at a ragged shape (C = 77, T = 14, 85 nodes an image)
   and on the inputs and cotangents the fused_step model_58_4 training
   path feeds at MPN steps 0 and 9. All ten gradients
   (dp, dh_node, dq, dcur, da, dw_cur, dw_e1, db_e1, dwe, dw_attn) each
   within 1e-4 of its own largest value, a second backward with the same
   bits, K1b's outputs within 1e-4 of its plain factored form's largest.
   Prints K1b's and the K1 f32 forward's ms a launch (median of 25) with
   their bounds, the whole backward's ms against the plain autograd's, and
   each launch's device ms by kernel name from ``torch.profiler``.
48. small training steps on ``fused_step``, CPU against card, as phase 7
   (small_train()) and as phase 38 (the ``simple`` zoo cut, whose last
   pass reaches no head, so K2b skips it and K1b takes the edge carry's
   cotangent alone): K1, K1b and G1 once a pass, K2b once a pass whose
   nodes reach a head.
49. model_58_4 training at full width on ``fused_step`` on phase 8's
   batches (w32/512, batch 8, f32, one warm-up and 3 timed steps): K1,
   K2b, K1b and G1 10 times each a step, K2 never, the loss finite, no
   step skipped; prints steps/s, the device time a step beside phase 8's
   ``pallas`` reading from the same call, and the peak memory.

50. the JAX package's MPN and graph variants (config.VARIANTS and
   VARIANT_CUTS) on the small cut, CPU against card, as phase 29: for each,
   the eval slice and one training step on the routes VARIANT_SMALL lists
   (``auto`` for all; ``hybrid``, ``fused_step``, ``dots``, ``einsum`` for
   some), the counts zeroed just before each and read just after: the
   kernels of the form config.layer_route gives the variant there, once an
   MPN pass (variant_launches: the per-type edge MLP on K2 where the route
   names the fused step, the per-type attention on the split linear and
   K4/K4b, the per-type sum by MPN.AGGR on no kernel; the edge lists and
   VanillaMPN on none). The feature kNN graph may swap neighbours whose
   distances tie within float32 rounding (checked in float64), and is then
   not compared further.
51. the variants at model_58_4's full width (w32/512, batch 8): for each of
   edge_mlp_per_type, update_hierarch, attn_per_type, aggr_per_type,
   node_steps, late_fusion, angle and ae_normed one bf16 eval forward on
   ``auto`` and two f32 training steps on ``auto`` (a warm-up and a timed
   one, phase 8's batches); update_hierarch training on ``fused_step``
   (K1, K2b, K1b, G1 10 a step) and edge_mlp_per_type on ``hybrid``; the
   counts zeroed just before each timed run and read just after
   (edge_mlp_per_type's eval: K2 10, K1 0); K2 and K2b against their plain
   versions on edge_mlp_per_type's training inputs at MPN step 0 (phase
   6's limits), K4 on attn_per_type's eval inputs at step 0 (bf16, 2e-2);
   the edge lists (knn_list, feature_knn, topk) one eval forward each.
   Prints each run's img/s or device ms a step and its peak memory;
   edge_mlp_per_type's training peak may pass phase 8's by 8 GiB at most.

Phases 47-51 run after phase 17, on phase 8's batches, next to the other
phases that read kernel times from ``torch.profiler``.

Phases 5, 8, 19, 23, 26, 27, 30, 31, 33, 34, 36, 37, 38, 39, 40, 41,
42-46, 48, 49, 50 and 51 check the counts the same way: every kernel not
named launches 0 times (40 and 41 in their own processes, whose counts
start at 0).

Prints a JSON line of per-kernel numbers, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no sparsity
TIMED_LAUNCHES = 25
F64_CAP = 2e-2                       # the most a float64-bounded gradient check allows
SPIN_CYCLES = 2_000_000              # ~1 ms of the card's clock ahead of each timed run


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """The last name of an Itanium-mangled function name (its kernel's own
    name, without namespaces or arguments); an unmangled name as it is."""
    i = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else len(mangled)
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name = mangled[j:j + int(mangled[i:j])]
        i = j + int(mangled[i:j])
    return name


def median_ms(fn, n=TIMED_LAUNCHES) -> float:
    """Median device time of ``fn`` over ``n`` runs, with CUDA events. A
    spin kernel keeps the card busy while the host enqueues ``fn``, so the
    start event fires when ``fn``'s first kernel can start: the host's time
    to get through a wrapper is not counted (it would be, with the card
    idle at the start event, and it is ~0.1 ms for K1's)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def zero_counts():
    from pemp_tpu_torch.ops import zero_launch_counts

    zero_launch_counts()


def read_counts(label, want):
    """The counts since zero_counts(); raises unless each kernel of ``want``
    launched exactly that often and every other one never."""
    from pemp_tpu_torch.ops import launch_counts

    counts = launch_counts()
    bad = {k: (v, want.get(k, 0)) for k, v in counts.items() if v != want.get(k, 0)}
    if bad:
        raise SystemExit(f"{label}: launches (got, expected) {bad}")
    return counts


def k1_bound_ms(args):
    """Least time for K1's work on these inputs: each input read once and
    each output written once at the memory rate, against the matmul work
    these inputs need at the peak rate of their type; the larger."""
    q, cur, a, valid, w_e1 = args[2], args[3], args[4], args[7], args[9]
    e, dc = cur.shape
    h, de, d = q.shape[1], w_e1.shape[1], a.shape[-1]
    out_bytes = e * de * cur.element_size() + a.numel() * 4
    nbytes = sum(t.numel() * t.element_size() for t in args) + out_bytes
    n_valid = int(valid.sum())
    flops = e * (2 * dc * h + 2 * h * de + 2 * de) + n_valid * 2 * de * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[cur.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def random_k1_inputs(dtype, seed=0, b=8, j=17, k=40, c=80, w=64, t=None):
    """K1's inputs at b images of j * k nodes (k candidates of j joint
    types), C slots a node and t source types (j by default)."""
    t = t or j
    rng = np.random.RandomState(seed)
    n_img = j * k
    n = b * n_img
    e = n * c
    dev = "cuda"
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev, dtype)  # noqa: E731
    i = lambda x: torch.from_numpy(x.astype(np.int32)).to(dev)  # noqa: E731
    args = (f(n, w), f(n, w), f(e, w), f(e, w), f(n, t, w),
            i(rng.randint(0, n_img, e)), i(rng.randint(0, t, e)), i(rng.rand(e) > 0.2),
            f(w, w) * 0.2, f(w, w) * 0.2, f(w) * 0.1, f(w, t * w) * 0.2, f(w, 1) * 0.2)
    return args, (n, t, n_img)


def check_k1(label, args, dims, tol, fused_step):
    """K1 through its wrapper against its plain version on the same inputs,
    and a second call, which must give the same bits. The f32 form must
    agree within ``tol`` absolute. The bf16 form (tensor cores) adds within
    a k16 step in another order than cuBLAS, so an h or ef value may land
    one bf16 step (2^-8 of itself) apart: out and ne must each agree within
    ``tol`` of their own largest plain value. Times both sides; returns
    (max abs error, ms, plain ms, bound, bound by)."""
    got = fused_step.fused_mpn_step(*args, *dims)
    again = fused_step.fused_mpn_step(*args, *dims)
    want = fused_step.fused_mpn_step_plain(*args, *dims)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise SystemExit(f"K1 {label}: two calls on the same inputs differ")
    errs = [(x.float() - y.float()).abs().max().item() for x, y in zip(got, want)]
    scales = [y.float().abs().max().item() for y in want]
    dtype = args[3].dtype
    limits = [tol, tol] if dtype == torch.float32 else [tol * s for s in scales]
    if not all(np.isfinite(e) and e <= lim for e, lim in zip(errs, limits)):
        raise SystemExit(f"K1 {label}: max abs errors (out, ne) {errs} exceed {limits}")
    ms = median_ms(lambda: fused_step.fused_mpn_step(*args, *dims))
    plain_ms = median_ms(lambda: fused_step.fused_mpn_step_plain(*args, *dims))
    bound, bound_by, nbytes, flops = k1_bound_ms(args)
    how = f"tol {tol}" if dtype == torch.float32 else f"tol {tol} of each max"
    log(f"K1 {label}: max abs err out {errs[0]:.3e} of max {scales[0]:.3e}, ne {errs[1]:.3e} "
        f"of max {scales[1]:.3e} ({how}); repeat bit-identical; kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} by {bound_by} "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return max(errs), ms, plain_ms, bound, bound_by


def k2_bound_ms(args, backward: bool):
    """Least time for K2's (or K2b's) work on these inputs: inputs read once
    and outputs written once at the memory rate, against the arithmetic
    the valid slots need at the peak rate of ef's type (K2: the typed
    projection and the logit; K2b: the projection again, d_ef and dwe,
    and the logit terms; the bf16 form's products are of bf16 values, as
    in the TPU branch it ports); the larger. Only the valid slots' ef rows
    are needed (no output depends on the others), and only the a rows (in
    K2b also the cotangent's rows) of the (node, type) groups that hold a
    valid slot (an empty group's output is 0, its gradients 0); every row
    of out and d_ef is an output (the empty and invalid ones are zeros)
    and is written."""
    ef, a, types, valid, we, w_attn = args[:6]
    e, de = ef.shape
    n, t, d = a.shape
    n_valid = int(valid.sum())
    node = torch.arange(e, device=types.device) // (e // n)
    held = int(torch.unique((node * t + types.long())[valid != 0]).numel())
    ins = (n_valid * de * ef.element_size() + held * d * a.element_size()
           + sum(x.numel() * x.element_size() for x in (types, valid, we, w_attn)))
    if backward:
        nbytes = ins + held * d * 4 + (ef.numel() + a.numel() + we.numel() + w_attn.numel()) * 4
        flops = n_valid * (3 * 2 * de * d + 4 * de + 6 * d)
    else:
        nbytes = ins + a.numel() * 4
        flops = n_valid * (2 * de * d + 2 * de + 3 * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[ef.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def random_k2_inputs(seed=1, b=8, j=17, k=40, c=80, w=64):
    rng = np.random.RandomState(seed)
    n = b * j * k
    e = n * c
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()  # noqa: E731
    i = lambda x: torch.from_numpy(x.astype(np.int32)).cuda()  # noqa: E731
    args = (f(e, w), f(n, j, w), i(rng.randint(0, j, e)), i(rng.rand(e) > 0.3),
            f(w, j * w) * 0.2, f(w, 1) * 0.2)
    return args, f(n, j, w), (n, j)


def check_k2(label, args, g, dims, typed_message):
    """K2 and K2b through the wrapper ``fused_typed_message_aggregate`` and
    its autograd Function, against the plain version and autograd through
    it, on the same inputs and cotangent ``g``; out, d_ef, da, dwe and dwa
    are each held to their own largest value. Times the forward, and the
    backward alone on a kept graph, on both sides. Returns
    {"fwd": numbers, "bwd": numbers}."""
    def run(fn):
        leaves = [args[i].clone().requires_grad_() for i in (0, 1, 4, 5)]
        out = fn(leaves[0], leaves[1], args[2], args[3], leaves[2], leaves[3], *dims)
        grads = torch.autograd.grad(out, leaves, g, retain_graph=True)
        return out, leaves, grads

    got, got_leaves, got_grads = run(typed_message.fused_typed_message_aggregate)
    want, want_leaves, want_grads = run(typed_message.fused_typed_message_plain)
    torch.cuda.synchronize()
    numbers = {}
    # f32 on both sides, sums in another order: the JAX package's kernel
    # tolerance (tests/test_fused_kernel.py, 1e-4), relative to each
    # output's own largest value (the training path's gradients can be as
    # small as 1e-9)
    for kind, names, pairs in (
        ("fwd", ("out",), [(got, want)]),
        ("bwd", ("d_ef", "da", "dwe", "dwa"), list(zip(got_grads, want_grads))),
    ):
        parts = []
        for name, (x, y) in zip(names, pairs):
            err, scale = (x - y).abs().max().item(), y.abs().max().item()
            if not (np.isfinite(err) and err <= 1e-4 * scale):
                raise SystemExit(f"K2 {kind} {label}: {name} max abs error {err} exceeds "
                                 f"1e-4 of its max |plain| {scale}")
            parts.append((name, err, scale))
        if kind == "fwd":
            ms = median_ms(lambda: typed_message.fused_typed_message_aggregate(*args, *dims))
            plain_ms = median_ms(lambda: typed_message.fused_typed_message_plain(*args, *dims))
        else:
            ms = median_ms(lambda: torch.autograd.grad(got, got_leaves, g, retain_graph=True))
            plain_ms = median_ms(
                lambda: torch.autograd.grad(want, want_leaves, g, retain_graph=True))
        bound, bound_by, nbytes, flops = k2_bound_ms(args, kind == "bwd")
        errs = ", ".join(f"{n} {e:.3e} of max {s:.3e}" for n, e, s in parts)
        log(f"K2 {kind} {label}: max abs err {errs} (tol 1e-4 of each max) "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f} "
            f"by {bound_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; valid slots "
            f"{int(args[3].sum())}/{args[3].numel()})")
        numbers[kind] = (max(e for _, e, _ in parts), ms, plain_ms, bound, bound_by)
    return numbers


def launch_ms(fn, args, leaf_ids, g, dims, names, n=10):
    """Device ms per call of each kernel launch of the wrapper ``fn`` and of
    the rest (any other kernel its forward or backward runs), by kernel name
    from ``torch.profiler`` over ``n`` forward calls and ``n`` backward
    calls on a kept graph, differentiating ``args[i]`` for i in
    ``leaf_ids`` (forward calls alone where ``g`` is None). ``names`` maps
    each part to a substring of its kernel's name; the first that matches
    wins. Returns the parts and the other kernels' names."""
    leaves = {i: args[i].clone().requires_grad_() for i in leaf_ids}
    out = fn(*(leaves.get(i, x) for i, x in enumerate(args)), *dims)

    def backward():
        if g is not None:
            torch.autograd.grad(out, list(leaves.values()), g, retain_graph=True)

    backward()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args, *dims)
            backward()
        torch.cuda.synchronize()
    parts = dict.fromkeys([*names, "rest"], 0.0)
    rest = []
    for ev in prof.key_averages():
        ms = ev.self_device_time_total / n / 1e3
        if ms <= 0:
            continue
        part = next((k for k, key in names.items() if key in ev.key), "rest")
        parts[part] += ms
        if part == "rest":
            rest.append(ev.key[:60])
    return parts, rest


def k2_group_stats(args, dims, chunk):
    """How the valid slots fall into (node, type) groups and into the
    blocks of K2 and K2b, of one type and up to ``chunk`` nodes, every
    chunks-th node (``csrc/typed_message.cu``, ``Chunk``): the groups that hold a slot,
    their mean and largest size, and the rows per block (mean, largest,
    blocks with any)."""
    types, valid = args[2], args[3]
    n, t = dims
    c = types.numel() // n
    node = torch.arange(types.numel(), device=types.device) // c
    key = (node * t + types.long())[valid != 0]
    groups = torch.bincount(key, minlength=n * t).view(n, t)
    chunks = -(-n // chunk)
    blocks = torch.zeros(chunks, t, dtype=groups.dtype, device=groups.device)
    blocks.index_add_(0, torch.arange(n, device=groups.device) % chunks, groups)
    held = groups[groups > 0].float()
    return (f"{held.numel()} groups of {n * t} hold a slot, {held.mean().item():.2f} rows on "
            f"average, {int(groups.max())} at most; rows per block of {chunk} nodes and one "
            f"type {blocks.float().mean().item():.1f} on average, {int(blocks.max())} at most, "
            f"{int((blocks > 0).sum())} of {blocks.numel()} blocks with any")


def k3_bound_ms(args, backward: bool):
    """Least time for K3's (or K3b's) work on these inputs: the valid slots'
    b rows (no output depends on the others), a and the index and logit
    columns read once, out (K3b: every db row, da and dlogit, after reading
    g) written once at the memory rate, against the elementwise work of the
    valid slots at the f32 rate (K3: add, ReLU, weight, sum; K3b that again
    and the five terms of its gradients); the larger."""
    b, a, types, valid, logits = args
    e, d = b.shape
    n_valid = int(valid.sum())
    ins = (n_valid * d * b.element_size() + a.numel() * a.element_size()
           + (types.numel() + valid.numel() + logits.numel()) * 4)
    if backward:
        nbytes = ins + a.numel() * 4 + (e * d + a.numel() + e) * 4
        flops = n_valid * 9 * d
    else:
        nbytes = ins + a.numel() * 4
        flops = n_valid * 4 * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def random_k3_inputs(seed=6, b=8, j=17, k=40, c=80, w=64):
    rng = np.random.RandomState(seed)
    n = b * j * k
    e = n * c
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()  # noqa: E731
    i = lambda x: torch.from_numpy(x.astype(np.int32)).cuda()  # noqa: E731
    args = (f(e, w), f(n, j, w), i(rng.randint(0, j, e)), i(rng.rand(e) > 0.3), f(e))
    return args, f(n, j, w), (n, j)


def check_k3(label, args, g, dims, tol, attn_aggregate):
    """K3 (and, given a cotangent ``g``, K3b) through the wrapper
    ``fused_attn_aggregate`` and its autograd Function, against the plain
    version and autograd through it, on the same inputs; out, db, da and
    dlogit each held to ``tol`` of its own largest value. Times the
    forward, and the backward alone on a kept graph, on both sides.
    Returns {"fwd": numbers[, "bwd": numbers]}."""
    def run(fn):
        leaves = [args[i].clone().requires_grad_(g is not None) for i in (0, 1, 4)]
        with torch.set_grad_enabled(g is not None):
            out = fn(leaves[0], leaves[1], args[2], args[3], leaves[2], *dims)
        grads = () if g is None else torch.autograd.grad(out, leaves, g, retain_graph=True)
        return out, leaves, grads

    got, got_leaves, got_grads = run(attn_aggregate.fused_attn_aggregate)
    want, want_leaves, want_grads = run(attn_aggregate.fused_attn_aggregate_plain)
    torch.cuda.synchronize()
    numbers = {}
    kinds = [("fwd", ("out",), [(got, want)])]
    if g is not None:
        kinds.append(("bwd", ("db", "da", "dlogit"), list(zip(got_grads, want_grads))))
    for kind, names, pairs in kinds:
        parts = []
        for name, (x, y) in zip(names, pairs):
            err, scale = (x - y).abs().max().item(), y.abs().max().item()
            if not (np.isfinite(err) and err <= tol * scale):
                raise SystemExit(f"K3 {kind} {label}: {name} max abs error {err} exceeds "
                                 f"{tol} of its max |plain| {scale}")
            parts.append((name, err, scale))
        if kind == "fwd":
            ms = median_ms(lambda: attn_aggregate.fused_attn_aggregate(*args, *dims))
            plain_ms = median_ms(lambda: attn_aggregate.fused_attn_aggregate_plain(*args, *dims))
        else:
            ms = median_ms(lambda: torch.autograd.grad(got, got_leaves, g, retain_graph=True))
            plain_ms = median_ms(
                lambda: torch.autograd.grad(want, want_leaves, g, retain_graph=True))
        bound, bound_by, nbytes, flops = k3_bound_ms(args, kind == "bwd")
        errs = ", ".join(f"{n} {e:.3e} of max {s:.3e}" for n, e, s in parts)
        log(f"K3 {kind} {label}: max abs err {errs} (tol {tol} of each max) "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f} "
            f"by {bound_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP; valid slots "
            f"{int(args[3].sum())}/{args[3].numel()})")
        numbers[kind] = (max(e for _, e, _ in parts), ms, plain_ms, bound, bound_by)
    return numbers


def group_stats(types, valid, n, t):
    """The valid rows per node (what a warp of K3, K3b and K4 reads: mean,
    least, most) and the (node, type) groups: how many hold a slot, their
    mean and largest size."""
    c = types.numel() // n
    ok = valid.view(n, c) != 0
    rows = ok.sum(1).float()
    node = torch.arange(types.numel(), device=types.device) // c
    groups = torch.bincount((node * t + types.long())[valid != 0], minlength=n * t)
    held = groups[groups > 0].float()
    return (f"valid rows per node {rows.mean().item():.2f} on average, {int(rows.min())} to "
            f"{int(rows.max())} of C = {c}; {held.numel()} groups of {n * t} hold a slot, "
            f"{held.mean().item():.2f} rows on average, {int(groups.max())} at most")


def k4_bound_ms(m, attn, types, valid, num_nodes, num_types):
    """Least time for K4's work on these inputs: the valid slots' message
    rows and the logit and index columns read once, out written once, at
    the memory rate, against a multiply-add per valid element at the f32
    rate; the larger."""
    e, d = m.shape
    n_valid = int(valid.sum())
    nbytes = (n_valid * d * m.element_size() + (attn.numel() + types.numel() + valid.numel()) * 4
              + num_nodes * num_types * d * m.element_size())
    flops = n_valid * 2 * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def check_k4(label, args, tol, blocked_attn, segment):
    """K4 through its wrapper against the plain version on the same inputs
    (m, attn, types, num_nodes, num_types, valid), held to ``tol`` of the
    plain output's largest value, and against itself: a second call gives
    the same bits. Times both. Returns the numbers."""
    with torch.no_grad():
        got = blocked_attn.blocked_attn_aggregate(*args)
        want = segment.blocked_per_type_attention_aggregate(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if not (got.dtype == args[0].dtype and np.isfinite(err) and err <= tol * scale):
            raise SystemExit(f"K4 {label}: max abs error {err} exceeds {tol} of its max "
                             f"|plain| {scale} (or the output is {got.dtype})")
        if not torch.equal(got, blocked_attn.blocked_attn_aggregate(*args)):
            raise SystemExit(f"K4 {label}: a second call gives other bits")
        ms = median_ms(lambda: blocked_attn.blocked_attn_aggregate(*args))
        plain_ms = median_ms(lambda: segment.blocked_per_type_attention_aggregate(*args))
    m, attn, types, n, t, valid = args
    bound, bound_by, nbytes, flops = k4_bound_ms(m, attn, types, valid, n, t)
    log(f"K4 {label}: max abs err {err:.3e} of max {scale:.3e} (tol {tol} of the max) "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f} by {bound_by} "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP; valid slots "
        f"{int(valid.sum())}/{valid.numel()}; a second call bit-identical)")
    return err, ms, plain_ms, bound, bound_by


def check_k2_bf16(label, args, dims, typed_message):
    """K2's bf16 form (the tensor cores) through the wrapper against the
    plain version on the same bf16 inputs (ef, a, types, valid, we,
    w_attn): both take exact bf16 products and sum them in f32, in another
    order, so out must agree within 1e-4 of its largest plain value. One
    launch a call; a second call gives the same bits; the empty (node,
    type) groups give exactly 0 over memory a freed NaN-filled tensor left;
    a bf16 input that needs a gradient is refused (K2b is f32). Logs the
    form that ran; times both sides. Returns the numbers."""
    types, valid = args[2], args[3]
    n, t = dims
    c = types.numel() // n
    node = torch.arange(types.numel(), device=types.device) // c
    empty = (torch.bincount((node * t + types.long())[valid != 0], minlength=n * t) == 0).view(n, t)
    log(f"K2 bf16 {label}: form {typed_message.FORMS[torch.bfloat16]}")
    with torch.no_grad():
        junk = torch.full((n, t, 64), float("nan"), device=types.device)
        torch.cuda.synchronize()
        del junk  # out (N, T, 64) f32 reuses this memory
        before = typed_message.LAUNCHES_FWD
        got = typed_message.fused_typed_message_aggregate(*args, *dims)
        launches = typed_message.LAUNCHES_FWD - before
        again = typed_message.fused_typed_message_aggregate(*args, *dims)
        want = typed_message.fused_typed_message_plain(*args, *dims)
        torch.cuda.synchronize()
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        if not (np.isfinite(err) and err <= 1e-4 * scale):
            raise SystemExit(f"K2 bf16 {label}: max abs error {err} exceeds 1e-4 of its max "
                             f"|plain| {scale}")
        if launches != 1:
            raise SystemExit(f"K2 bf16 {label}: {launches} launches counted for one call")
        if not torch.equal(got, again):
            raise SystemExit(f"K2 bf16 {label}: a second call gives other bits")
        if not bool((got[empty] == 0).all()):
            raise SystemExit(f"K2 bf16 {label}: an empty group is not exactly 0")
        ms = median_ms(lambda: typed_message.fused_typed_message_aggregate(*args, *dims))
        plain_ms = median_ms(lambda: typed_message.fused_typed_message_plain(*args, *dims))
    try:
        typed_message.fused_typed_message_aggregate(args[0].clone().requires_grad_(), *args[1:],
                                                    *dims)
    except ValueError as e:
        if "forward only" not in str(e):
            raise
    else:
        raise SystemExit(f"K2 bf16 {label}: a bf16 input that needs a gradient was not refused")
    bound, bound_by, nbytes, flops = k2_bound_ms(args, False)
    log(f"K2 bf16 {label}: max abs err {err:.3e} of max {scale:.3e} (tol 1e-4 of the max); "
        f"one launch; repeat bit-identical; {int(empty.sum())} empty groups exactly 0; "
        f"gradient refused; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f} "
        f"by {bound_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; valid slots "
        f"{int(valid.sum())}/{valid.numel()})")
    return err, ms, plain_ms, bound, bound_by


def phase_k2_bf16(images, cfg):
    """Phase 13: K2's bf16 form (``check_k2_bf16``) at the step 0 of the
    eval path ``cfg`` sets (w48/640 on pallas, bf16) on ``images``, and its
    device ms from ``torch.profiler``. Returns check_k2_bf16's numbers."""
    from pemp_tpu_torch.ops import typed_message
    from pemp_tpu_torch.pipeline import build_pipeline

    pipe = build_pipeline(images.shape[0], images.shape[1], dtype=torch.bfloat16, device="cuda",
                          cfg=cfg, seed=0)
    args = capture_eval_inputs(pipe, images, "fused_typed_message_aggregate", steps=(0,))[0]
    if not all(x.dtype == torch.bfloat16 for x in (args[0], args[1], args[4], args[5])):
        raise SystemExit("pallas eval path: K2's inputs are not bf16")
    numbers = check_k2_bf16("pallas eval path step 0", args[:6], args[6:], typed_message)
    parts, rest = launch_ms(typed_message.fused_typed_message_aggregate, args[:6], (), None,
                            args[6:], {"fwd": "typed_message_fwd"})
    if not parts["fwd"] > 0:
        raise SystemExit(f"K2 bf16 launch: the profiler saw no device time ({parts})")
    log(f"K2 bf16 launch, pallas eval path step 0 (torch.profiler, device ms per call): K2 "
        f"{parts['fwd']:.4f}; rest {parts['rest']:.4f} ({'; '.join(rest)})")
    del pipe, args
    torch.cuda.empty_cache()
    return numbers


def k4b_bound_ms(m, attn, types, valid, num_nodes, num_types):
    """Least time for K4b's work on these inputs: the valid slots' message
    rows, g and the logit and index columns read once, every dm row and
    dlogit written once, at the memory rate, against dm, u and dlogit for
    each valid element at the f32 rate; the larger."""
    e, d = m.shape
    n_valid = int(valid.sum())
    nbytes = (n_valid * d * 4 + (attn.numel() + types.numel() + valid.numel()) * 4
              + num_nodes * num_types * d * 4 + (e * d + e) * 4)
    flops = n_valid * 3 * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def check_k4b(label, args, g, blocked_attn, segment):
    """K4b through K4's autograd Function (args m, attn, types, num_nodes,
    num_types, valid; cotangent ``g``) against its factored plain form and
    against autograd through the plain version: dm and dlogit each within
    1e-4 of its largest plain value, exact zeros for the slots of no group,
    a second backward bit-identical. Times the backward alone on a kept
    graph on both sides. Returns the numbers."""
    m, attn, types, n, t, valid = args

    def run(fn):
        leaves = [m.clone().requires_grad_(), attn.clone().requires_grad_()]
        out = fn(leaves[0], leaves[1], types, n, t, valid)
        return out, leaves, torch.autograd.grad(out, leaves, g, retain_graph=True)

    got_out, got_leaves, got = run(blocked_attn.blocked_attn_aggregate)
    again = torch.autograd.grad(got_out, got_leaves, g, retain_graph=True)
    want_out, want_leaves, want = run(segment.blocked_per_type_attention_aggregate)
    factored = blocked_attn.blocked_attn_aggregate_bwd_plain(m, attn, types, valid, g, n, t)
    torch.cuda.synchronize()
    parts = []
    for name, x, y, z, x2 in zip(("dm", "dlogit"), got, want, factored, again):
        for ref in (y, z):
            err, scale = (x - ref).abs().max().item(), ref.abs().max().item()
            if not (np.isfinite(err) and err <= 1e-4 * scale):
                raise SystemExit(f"K4b {label}: {name} max abs error {err} exceeds 1e-4 of its "
                                 f"max |plain| {scale}")
        if not torch.equal(x, x2):
            raise SystemExit(f"K4b {label}: {name} differs on a second backward")
        if not bool((x[valid == 0] == 0).all()):
            raise SystemExit(f"K4b {label}: {name} is not 0 on the slots of no group")
        parts.append((name, (x - y).abs().max().item(), y.abs().max().item()))
    ms = median_ms(lambda: torch.autograd.grad(got_out, got_leaves, g, retain_graph=True))
    plain_ms = median_ms(lambda: torch.autograd.grad(want_out, want_leaves, g, retain_graph=True))
    bound, bound_by, nbytes, flops = k4b_bound_ms(m, attn, types, valid, n, t)
    errs = ", ".join(f"{k} {e:.3e} of max {s:.3e}" for k, e, s in parts)
    log(f"K4b {label}: max abs err {errs} (tol 1e-4 of each max, also against the factored "
        f"form); zeros on the slots of no group; repeat bit-identical; kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} by {bound_by} ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP; valid slots {int(valid.sum())}/{valid.numel()})")
    return max(e for _, e, _ in parts), ms, plain_ms, bound, bound_by


def g1_bound_ms(g, plan, num_rows):
    """Least time for G1's work on these inputs: g and the plan's order,
    piece bounds and row pieces read once, dx written once, at the memory
    rate, against an add per element of g at the f32 rate; the larger."""
    e, d = g.shape
    nbytes = (g.numel() * g.element_size() + sum(
        plan[k].numel() * 4 for k in ("order", "bounds", "row_pieces"))
        + num_rows * d * g.element_size())
    flops = e * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def check_g1(label, x, j, plan, g, gather_mm):
    """G1 through ``gather_rows_bwd`` against its plain version on the card
    (index_add_ by the plan's pieces): within 1e-5 of the largest plain
    value, a second call bit-identical; whether it equals the plain version
    on the CPU bit for bit (the same sums in the same order) is printed.
    Times G1, the plain version and, as the library calls that compute the
    same function, ``index_add_`` of g by j and autograd's backward of
    ``x[j]``. Returns the numbers and the library ms (index_add_)."""
    n, d = x.shape
    got = gather_mm.gather_rows_bwd(g, plan, n, x.dtype)
    again = gather_mm.gather_rows_bwd(g, plan, n, x.dtype)
    want = gather_mm.gather_rows_bwd_plain(g, plan, n, x.dtype)
    cpu = gather_mm.gather_rows_bwd_plain(g.cpu(), {k: v.cpu() for k, v in plan.items()}, n,
                                          x.dtype)
    torch.cuda.synchronize()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    if not (np.isfinite(err) and err <= 1e-5 * scale):
        raise SystemExit(f"G1 {label}: max abs error {err} exceeds 1e-5 of its max |plain| "
                         f"{scale}")
    if not torch.equal(got, again):
        raise SystemExit(f"G1 {label}: a second call gives other bits")
    ms = median_ms(lambda: gather_mm.gather_rows_bwd(g, plan, n, x.dtype))
    plain_ms = median_ms(lambda: gather_mm.gather_rows_bwd_plain(g, plan, n, x.dtype))
    target = torch.zeros_like(want)
    library_ms = median_ms(lambda: target.index_add_(0, j, g))
    leaf = x.detach().clone().requires_grad_()
    out = leaf[j]
    index_bwd_ms = median_ms(lambda: torch.autograd.grad(out, leaf, g, retain_graph=True))
    bound, bound_by, nbytes, flops = g1_bound_ms(g, plan, n)
    pieces = plan["bounds"].numel() - 1
    per_row = plan["row_pieces"][1:] - plan["row_pieces"][:-1]
    log(f"G1 {label}: max abs err {err:.3e} of max {scale:.3e} (tol 1e-5 of the max); repeat "
        f"bit-identical; the CPU plain version's bits {torch.equal(got.cpu(), cpu)}; "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} index_add_ms={library_ms:.4f} "
        f"index_backward_ms={index_bwd_ms:.4f} bound_ms={bound:.4f} by {bound_by} "
        f"({nbytes / 1e6:.1f} MB; {g.shape[0]} slots onto {n} rows in {pieces} pieces, at most "
        f"{int(per_row.max())} a row)")
    return (err, ms, plain_ms, bound, bound_by), library_ms


def drive_eval(label, pipe, images, iters, want, card, model="w48"):
    """The eval path at full width: a warm-up forward, then ``iters``
    forwards with the counts zeroed just before and read just after; each
    kernel of ``want`` must launch that often per forward, every other one
    never. Checks shapes and finiteness; returns the counts."""
    pipe(images)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch, size = images.shape[0], images.shape[1]
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        persons, valid, scoremaps, out = pipe.forward(images)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(label, {k: v * iters for k, v in want.items()})
    n = 17 * pipe.model.gc.nodes_per_type
    if tuple(persons.shape) != (batch, 30, 17, 3) or tuple(scoremaps.shape) != (
        batch, size // 2, size // 2, 17
    ):
        raise SystemExit(f"{label}: unexpected shapes {tuple(persons.shape)}, "
                         f"{tuple(scoremaps.shape)}")
    for name, t in (("persons", persons), ("scoremaps", scoremaps),
                    ("edge logits", out["preds"]["edge"][-1]),
                    ("node logits", out["preds"]["node"][-1])):
        if not bool(torch.isfinite(t.float()).all()):
            raise SystemExit(f"{label}: non-finite {name}")
    g = out["graph"]
    launched = ", ".join(f"{k} {v} ({v // iters} per forward)" for k, v in counts.items() if v)
    log(f"{label}: {model}/{size} batch {batch} bf16, {iters} forwards in {dt:.3f} s: "
        f"{batch * iters / dt:.2f} img/s on {card}; launches {launched}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; valid nodes "
        f"{int(g['node_valid'].sum())}/{batch * n}; valid edges "
        f"{int(g['edge_valid'].sum())}/{g['edge_valid'].numel()}; persons found "
        f"{int(valid.sum())}")
    return counts


def drive_train(label, trainer, batches, want, card, model="model_58_4"):
    """Training at full width: a warm-up step on ``batches[0]``, then one
    step on each of the others with the counts zeroed just before and read
    just after; each kernel of ``want`` must launch that often per step,
    every other one never; losses finite, no step skipped. Prints the
    device time a step (CUDA events around the timed steps). Returns the
    counts, the device ms a step under ``device_ms`` and the peak memory of
    the timed steps in GiB under ``peak_gib``."""
    trainer.step(batches[0])                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = batches[1:]
    losses = []
    zero_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for batch in timed:
        loss, logging = trainer.step(batch)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    device_ms = start.elapsed_time(end) / len(timed)
    counts = read_counts(label, {k: v * len(timed) for k, v in want.items()})
    if not all(bool(torch.isfinite(x)) for x in losses) or trainer.fail_count:
        raise SystemExit(f"{label}: losses {[float(x) for x in losses]}, "
                         f"{trainer.fail_count} skipped steps")
    lab, gr = trainer.last_output["labels"], trainer.last_output["graph"]
    bs, size = batches[0]["imgs"].shape[:2]
    launched = ", ".join(f"{k} {v} ({v // len(timed)} per step)" for k, v in counts.items() if v)
    log(f"{label}: {model} w32/{size} batch {bs} f32, {len(timed)} steps in {dt:.3f} s: "
        f"{len(timed) / dt:.3f} steps/s, {bs * len(timed) / dt:.2f} img/s on {card}; "
        f"device time a step {device_ms:.1f} ms; "
        f"launches {launched}; losses {[round(float(x), 4) for x in losses]}; "
        f"parts of the last {({k: round(float(v), 4) for k, v in logging.items()})}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; valid nodes "
        f"{int(gr['node_valid'].sum())}/{gr['node_valid'].numel()}, label-positive "
        f"{int(lab['node'].sum())}; valid edges {int(gr['edge_valid'].sum())}/"
        f"{gr['edge_valid'].numel()}, label-positive {int(lab['edge'][0].sum())}")
    return {**counts, "device_ms": device_ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def capture_train_inputs(trainer, batch, name, steps=(0, 9)):
    """Runs one training forward and backward and keeps the inputs of the
    MPN layer's kernel wrapper ``name`` and the cotangent its backward
    receives at the given MPN steps (a list of one an output where the
    wrapper returns several, None where an output reaches no loss)."""
    from pemp_tpu_torch.models.mpn import layers

    real = getattr(layers, name)
    calls = []
    kept = {}

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        step = len(calls)
        calls.append(1)
        if step in steps:
            kept[step] = [tuple(a.detach().clone() if torch.is_tensor(a) else a
                                for a in args)]
            if isinstance(out, tuple):
                # one cotangent an output, None where it reaches no loss
                grads = [None] * len(out)
                kept[step].append(grads)
                for i, o in enumerate(out):
                    o.register_hook(lambda g, i=i: grads.__setitem__(i, g.detach().clone()))
            else:
                out.register_hook(lambda g: kept[step].append(g.detach().clone()))
        return out

    setattr(layers, name, recording)
    try:
        trainer.optimizer.zero_grad()
        loss, _, _ = trainer.loss(batch)
        loss.backward()
    finally:
        setattr(layers, name, real)
        trainer.optimizer.zero_grad()
    torch.cuda.synchronize()
    return kept


def phase_small_train(msg_pass="auto", cfg=None, name="small train", f64_bound=False):
    """small_train() (or ``cfg``, a small cut) on ``msg_pass``, same seeded
    weights and batch, CPU against card: labels exact, loss parts within
    1e-4, each parameter's gradient within 5e-3 of its largest, the MPN's
    running statistics within 1e-4 (of their tensor's largest where that
    passes 1).

    ``f64_bound``: the CPU also runs the step in float64 (the plain versions
    compute float64 inputs in float64; graph and labels come out the same),
    and the card's gradients are held against that instead: each tensor
    within 5e-3 of the float64 gradient's largest, or within 1.5 times the
    CPU's own float32 error against float64 where that is larger, never
    past F64_CAP. At random weights some gradients are ill-conditioned in
    float32 (model_gostic_position's edge embedding biases, model_nothing's
    mlp_node.mlp.16 bias: the CPU's float32 gradient is up to 1.6e-2 of its
    largest from float64), and no float32 program is closer there than it
    computes. Every tensor allowed more than 5e-3 is printed with both
    readings."""
    from pemp_tpu_torch.config import small_train
    from pemp_tpu_torch.data.synthetic import make_batch
    from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer

    cfg = small_train() if cfg is None else cfg
    cfg.TPU.MSG_PASS = msg_pass
    batch = make_batch(np.random.RandomState(5), cfg.TRAIN.BATCH_SIZE, 64, (16, 32),
                       cfg.DATASET.NUM_JOINTS, 30, scale_range=(0.4, 0.9))
    runs = {}
    state = None
    sides = [("cpu", "cpu", torch.float32), ("cuda", "cuda", torch.float32)]
    if f64_bound:
        sides.append(("f64", "cpu", torch.float64))
    for side, dev, dtype in sides:
        trainer = build_trainer(cfg, device=dev, seed=3)
        if state is None:
            calm_mplayer(trainer.model)
            state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        trainer.model.load_state_dict(state)
        tbatch = batch_to_torch(batch, dev)
        if dtype == torch.float64:
            trainer.model.double()
            trainer.model.dtype = dtype
            tbatch = {k: [x.double() for x in v] if isinstance(v, list) else
                      (v.double() if v.is_floating_point() else v) for k, v in tbatch.items()}
        loss, logging, out = trainer.loss(tbatch)
        loss.backward()
        runs[side] = (
            {k: float(v.detach() if torch.is_tensor(v) else v) for k, v in logging.items()},
            {k: (v[0] if isinstance(v, list) else v).cpu().float()
             for k, v in out["labels"].items() if k in ("node", "class", "person", "edge")},
            {k: p.grad.double().cpu() for k, p in trainer.model.named_parameters()
             if p.grad is not None},
            {k: b.double().cpu() for k, b in trainer.model.mpn.named_buffers() if "running" in k},
        )
    (lc, labc, gc, sc), (lg, labg, gg, sg) = runs["cpu"], runs["cuda"]
    for key in ("node", "class", "person", "edge"):
        for side in runs:
            if not torch.equal(labc[key], runs[side][1][key]):
                raise SystemExit(f"{name} {msg_pass}: labels {key} differ between CPU and "
                                 f"{side}")
    # f32 on both sides (TF32 off); cuDNN and the kernels sum in other
    # orders than the CPU: loss parts at 1e-4; gradients within 5e-3 of each
    # tensor's largest |grad| (the CPU tests' tolerance against the JAX
    # package, set from a float64 evaluation)
    bad = {k: (lc[k], lg[k]) for k in lc if abs(lc[k] - lg[k]) > 1e-4 * max(1.0, abs(lc[k]))}
    if bad:
        raise SystemExit(f"{name} {msg_pass}: loss parts differ: {bad}")
    if set(gc) != set(gg):
        raise SystemExit(f"{name} {msg_pass}: different parameters have gradients")

    ref, against = gc, "the CPU's"
    if f64_bound:
        ref, against = runs["f64"][2], "the float64 step's"

    def rel(a, k):
        return ((a[k] - ref[k]).abs().max() / ref[k].abs().max()).item()

    # a gradient that is zero but for rounding (the tag head's last bias:
    # the tag losses do not change when every tag shifts alike) has no
    # largest to be relative to: the card's is held to 1e-6 of the step's
    # largest gradient instead
    top = max(ref[k].abs().max().item() for k in ref)
    zero = [k for k in ref if ref[k].abs().max() <= 1e-12 * top]
    bad = {k: gg[k].abs().max().item() for k in zero if gg[k].abs().max() > 1e-6 * top}
    if bad:
        raise SystemExit(f"{name} {msg_pass}: gradients {against} zero to rounding are not "
                         f"on the card: {bad} against the largest {top:.3e}")
    keys = [k for k in ref if k not in zero]
    tol = {k: 5e-3 for k in keys}
    if f64_bound:
        tol = {k: min(F64_CAP, max(5e-3, 1.5 * rel(gc, k))) for k in keys}
    worst, worst_at = max((rel(gg, k) / tol[k], k) for k in keys)
    if f64_bound and not worst <= 1.0:
        # the card's backbone (cuDNN) differs from the CPU's by float32
        # rounding; where a gradient turns on an input difference of that
        # size (the tag model with NODE_STEPS 2 at these weights: 5.794e-3
        # of its largest on the card with the kernels and with their plain
        # versions alike, python -m pemp_tpu_torch.grad_reference), the
        # CPU's own float32 error is read also on features changed by 1e-6
        # (grad_reference --perturb), and the largest reading sets the limit
        from pemp_tpu_torch.grad_reference import step_grads

        moved = [step_grads(cfg, "cpu", torch.float32, 3, False, batch, (1e-6, s))
                 for s in (0, 1)]
        tol = {k: min(F64_CAP, max(tol[k], *(1.5 * rel(g, k) for g in moved))) for k in keys}
        worst, worst_at = max((rel(gg, k) / tol[k], k) for k in keys)
        log(f"{name} {msg_pass}: a tensor passed its limit on the first reading; with the "
            f"CPU's float32 gradients on features changed by 1e-6 ({worst_at}: "
            f"{', '.join(f'{rel(g, worst_at):.3e}' for g in moved)}) it allows "
            f"{tol[worst_at]:.3e}")
    err = rel(gg, worst_at)
    loose = "; ".join(f"{k}: card {rel(gg, k):.3e}, CPU {rel(gc, k):.3e}, allowed {tol[k]:.3e}"
                      for k in keys if tol[k] > 5e-3)
    if f64_bound:
        log(f"{name} {msg_pass}: against float64, tensors allowed more than 5e-3: "
            f"{loose or 'none'}; zero to rounding, held to 1e-6 of the largest: "
            f"{', '.join(zero) or 'none'}")
    if not worst <= 1.0:
        raise SystemExit(f"{name} {msg_pass}: gradients differ by {err:.2e} of {against} "
                         f"largest ({worst_at}; allowed {tol[worst_at]:.2e})")
    # each statistic within 1e-4 of its tensor's largest where that passes
    # 1, as the loss parts: VanillaMPN2's BatchNorms over the edges read
    # variances of ~500 at the small cut, where float32 sums of ~15,000 rows
    # in another order differ by ~5e-4
    stat_err, stat_at = max(((((sc[k] - sg[k]).abs().max()
                               / sc[k].abs().max().clamp(min=1.0)).item(), k) for k in sc),
                            default=(0.0, None))
    if not stat_err <= 1e-4:
        raise SystemExit(f"{name} {msg_pass}: MPN running statistics {stat_at} differ by "
                         f"{stat_err:.2e} of max(1, their largest)")
    log(f"{name} {msg_pass}: CPU vs card labels exact ({int(labc['node'].sum())} positive "
        f"nodes, {int(labc['edge'].sum())} positive edges); loss {lc['loss']:.6f} vs "
        f"{lg['loss']:.6f}; card gradients within {err:.2e} of {against} largest "
        f"({worst_at}; {worst:.2f} of its tolerance); MPN running statistics within "
        f"{stat_err:.2e} of max(1, their largest)")


def capture_eval_inputs(pipe, images, name, steps=(0, 9)):
    """Runs one forward and keeps the inputs of the MPN layer's kernel
    wrapper ``name`` at the given MPN steps."""
    from pemp_tpu_torch.models.mpn import layers

    real = getattr(layers, name)
    seen = []
    kept = {}

    def recording(*args, **kwargs):
        if len(seen) in steps:
            kept[len(seen)] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        seen.append(1)
        return real(*args, **kwargs)

    setattr(layers, name, recording)
    try:
        pipe(images)
    finally:
        setattr(layers, name, real)
    torch.cuda.synchronize()
    return kept


def check_feature_swaps(label, gc, gg, cpu_model):
    """The feature kNN graphs of the CPU (``gc``) and the card (``gg``),
    which may differ where two neighbours' float32 distances tie: the
    nodes equal; each edge that differs differs in one endpoint (the
    neighbour: row 1 in the forward block, row 0 in the reverse one), whose
    distance from the endpoint both share (float64, on the CPU's features)
    equals the other graph's within 1e-5 of the larger; ``edge_valid``
    equal but on those edges and on the edges between a swapped pair's
    nodes, whose mutual mask the swap changes. Returns the last step's
    outputs of the CPU's MPN on the card's graph."""
    for key in ("nodes", "node_valid"):
        if not torch.equal(gc[key], gg[key]):
            raise SystemExit(f"{label}: graph field {key} differs between CPU and card")
    ic, ig = gc["edge_index"].long(), gg["edge_index"].long()
    diff = ic != ig
    if bool(diff.all(0).any()):
        raise SystemExit(f"{label}: an edge differs in both endpoints between CPU and card")
    differ = diff.any(0).nonzero()[:, 0]
    row = diff[1, differ].long()[None]               # the row of the neighbour
    fixed = ic[:, differ].gather(0, 1 - row)[0]
    n_cpu, n_card = ic[:, differ].gather(0, row)[0], ig[:, differ].gather(0, row)[0]
    x = gc["x"].double()
    d_cpu = ((x[fixed] - x[n_cpu]) ** 2).sum(-1)
    d_card = ((x[fixed] - x[n_card]) ** 2).sum(-1)
    if not bool(((d_cpu - d_card).abs() <= 1e-5 * torch.maximum(d_cpu, d_card)).all()):
        raise SystemExit(f"{label}: the feature kNN graphs differ past float32 rounding of "
                         f"their distances")
    n = x.shape[0]
    pair = lambda a, b: torch.minimum(a, b) * n + torch.maximum(a, b)  # noqa: E731
    swapped = torch.cat([pair(fixed, n_cpu), pair(fixed, n_card)])
    slots = (gc["edge_valid"] != gg["edge_valid"]).nonzero()[:, 0]
    free = torch.isin(slots, differ) | torch.isin(pair(ic[0, slots], ic[1, slots]), swapped)
    if not bool(free.all()):
        raise SystemExit(f"{label}: edge_valid differs between CPU and card on "
                         f"{int((~free).sum())} edges no swap explains")
    gb = SimpleNamespace(x=gg["x"], edge_attr=gg["edge_attr"], edge_index=gg["edge_index"],
                         edge_valid=gg["edge_valid"], edge_src_local=gg["edge_src_local"],
                         node_valid=gg["node_valid"], joint_det=gg["nodes"], joint_tags=None,
                         node_labels=None, batch_index=gg["batch_index"])
    with torch.no_grad():
        preds = cpu_model.mpn_forward(gb)
    log(f"{label}: {len(differ)} neighbours swapped within float32 rounding of their feature "
        f"distances, {len(slots)} edge_valid flips on their pairs")
    return {k: v[-1] for k, v in preds.items() if v is not None and v[-1] is not None}


def phase_small_slice(msg_pass="auto", cfg=None, name="small slice", feature_ties=False):
    """The narrow test configuration (or ``cfg``, a small cut) on
    ``msg_pass``, same weights, CPU against card. ``feature_ties``: the
    graph is kNN among the node features, whose distances the card sums in
    another order than the CPU; where the two graphs differ, they are held
    by :func:`check_feature_swaps`, the CPU's MPN runs on the card's graph
    and its outputs are held against the card's at the same 2e-3, and the
    persons, which the decode forms on each side's own graph, are not
    compared."""
    from pemp_tpu_torch.config import small
    from pemp_tpu_torch.pipeline import build_pipeline

    cfg = small() if cfg is None else cfg
    cfg.TPU.MSG_PASS = msg_pass
    imgs = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    runs, pipes = {}, {}
    for dev in ("cpu", "cuda"):
        pipe = pipes[dev] = build_pipeline(2, dtype=torch.float32, device=dev, cfg=cfg, seed=3)
        calm_mplayer(pipe.model)
        persons, valid, _, out = pipe.forward(imgs.to(dev))
        runs[dev] = (persons.cpu(), valid.cpu(),
                     {k: v.cpu() for k, v in out["graph"].items()},
                     {k: v[-1].cpu() for k, v in out["preds"].items()
                      if v is not None and v[-1] is not None})
    (pc, vc, gc, mc), (pg, vg, gg, mg) = runs["cpu"], runs["cuda"]
    swapped = feature_ties and not (torch.equal(gc["edge_index"], gg["edge_index"])
                                    and torch.equal(gc["edge_valid"], gg["edge_valid"]))
    if swapped:
        mc = check_feature_swaps(f"{name} {msg_pass}", gc, gg, pipes["cpu"].model)
        gc = gg
    for key in ("nodes", "edge_index", "edge_valid", "node_valid"):
        if not torch.equal(gc[key], gg[key]):
            raise SystemExit(f"{name} {msg_pass}: graph field {key} differs between CPU "
                             f"and card")
    ev = gc["edge_valid"]
    errs = {k: (mc[k] - mg[k])[ev if k == "edge" else slice(None)].abs().max().item()
            for k in mc}
    # f32 on both sides (TF32 off); cuDNN and the kernel sum in other orders
    # than the CPU: the JAX package's MPN parity tolerance
    bad = {k: v for k, v in errs.items() if not v <= 2e-3}
    if bad:
        raise SystemExit(f"{name} {msg_pass}: MPN outputs differ: {bad}")
    if swapped:
        log(f"{name} {msg_pass}: the CPU's MPN on the card's graph vs the card's, max abs err "
            f"{errs}; valid edges {int(ev.sum())}")
        return
    if not (torch.equal(vc, vg) and torch.equal(pc[..., :2], pg[..., :2])
            and (pc[..., 2] - pg[..., 2]).abs().max().item() <= 1e-5):
        raise SystemExit(f"{name} {msg_pass}: persons differ between CPU and card")
    log(f"{name} {msg_pass}: CPU vs card MPN max abs err {errs}; graph exact; "
        f"persons equal ({int(vc.sum())} found); valid edges {int(ev.sum())}")


def decode_scene(rng, j=17, k=6, c=10, h=24, w=28, persons=3):
    """One image's decode inputs, built by hand so that persons form:
    random MPN weights put every sigmoid near 0.5, below the 0.8 edge
    threshold. Each person's joints are chained by edges far above it."""
    n = j * k
    det = np.stack([rng.randint(0, w, n), rng.randint(0, h, n), np.arange(n) // k], -1)
    person = np.full(n, -1)
    for p in range(persons):
        person[np.arange(j) * k + p] = np.where(rng.rand(j) < 0.85, p, -1)
    node_valid = (rng.rand(n) > 0.1) | (person >= 0)
    node_scores = np.where(person >= 0, rng.uniform(0.6, 0.99, n), rng.uniform(0.0, 0.05, n))
    src = rng.randint(0, n, (n, c))
    for i in np.flatnonzero(person >= 0):
        mates = np.flatnonzero(person == person[i])
        src[i, 0] = mates[(np.searchsorted(mates, i) + 1) % len(mates)]
    dst = np.repeat(np.arange(n), c).reshape(n, c)
    ev = (rng.rand(n, c) > 0.2) | (np.arange(c) == 0)
    same = (person[src] == person[dst]) & (person[src] >= 0)
    edge_pred = np.where(same, rng.uniform(0.85, 0.99, (n, c)), rng.uniform(0.0, 0.6, (n, c)))
    logits = rng.randn(n, j) + 8.0 * np.eye(j)[det[:, 2]]
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (f32(rng.rand(h, w, j)), f32(rng.randn(h, w, j)), det.astype(np.int32),
            f32(node_scores), np.stack([src.ravel(), dst.ravel()]).astype(np.int32),
            ev.ravel(), f32(edge_pred.ravel()), node_valid,
            f32(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)))


def phase_decode():
    """decode_poses on hand-built scenes that form persons, CPU against card."""
    from pemp_tpu_torch.decode.assembly import decode_poses

    rng = np.random.RandomState(4)
    scenes = [decode_scene(rng) for _ in range(2)]
    batch = [torch.from_numpy(np.stack(parts)) for parts in zip(*scenes)]
    runs = {}
    for dev in ("cpu", "cuda"):
        *args, class_probs = (t.to(dev) for t in batch)
        persons, valid = decode_poses(*args, node_threshold=0.1, num_joints=17,
                                      blocked_c=10, class_probs=class_probs)
        runs[dev] = (persons.cpu(), valid.cpu())
    (pc, vc), (pg, vg) = runs["cpu"], runs["cuda"]
    if int(vc.sum(dim=1).min()) < 2:
        raise SystemExit(f"decode: the hand-built scenes formed {vc.sum(dim=1).tolist()} persons")
    # coordinates are integers plus quarter offsets: exact; scores at 1e-6
    if not (torch.equal(vc, vg) and torch.equal(pc[..., :2], pg[..., :2])
            and (pc[..., 2] - pg[..., 2]).abs().max().item() <= 1e-6):
        raise SystemExit("decode: persons differ between CPU and card")
    log(f"decode: hand-built scenes, persons per image {vc.sum(dim=1).tolist()}, "
        f"equal on CPU and card")


# Phase 21: detections made from the ground truth with normal noise of 2
# pixels score these stats through the port's KeypointEval (COCO's ten,
# CrowdPose's nine); tests/test_torch_eval.py holds pemp_tpu.eval's stats
# on the same detections to them (1e-12).
SCORING_STATS = {
    "coco": [0.788558989578646, 0.8563657767093993, 0.8563657767093993, 0.8907142857142857,
             0.7806647807637905, 0.9296296296296296, 1.0, 1.0, 0.9, 0.9800000000000001],
    "crowdpose": [0.7550370172152349, 0.761180982963161, 0.761180982963161,
                  0.9962962962962963, 1.0, 1.0, 0.9158415841584159, 0.7405178979436402,
                  0.7878359264497875],
}


def scoring_case(crowdpose: bool, noise: float):
    """Ground truth for ten 300x400 images (a tenth of the persons crowds)
    and detections made from it with ``noise`` pixels of normal noise plus
    a false person per image."""
    from pemp_tpu_torch.data.synthetic import eval_scenes, noisy_results

    gt = eval_scenes(np.random.RandomState(0), [(300, 400)] * 10, 14 if crowdpose else 17,
                     render=False, crowd_fraction=0.1)[1]
    return gt, noisy_results(np.random.RandomState(1), gt, noise)


def keypoint_stats(gt, dets, crowdpose: bool):
    from pemp_tpu_torch.data.coco_api import COCO
    from pemp_tpu_torch.eval.coco_eval import KeypointEval

    coco = COCO(gt)
    ev = KeypointEval(coco, coco.loadRes(dets), crowdpose=crowdpose)
    ev.evaluate(sorted(coco.imgs))
    ev.accumulate()
    return ev.summarize(verbose=False)


def phase_scoring():
    """The ground truth as detections scores AP 1.0; noisy detections score
    SCORING_STATS."""
    worst = 0.0
    for name, crowdpose in (("coco", False), ("crowdpose", True)):
        gt, dets = scoring_case(crowdpose, 2.0)
        stats = keypoint_stats(gt, sum(dets, []), crowdpose)
        err = float(np.abs(stats - np.asarray(SCORING_STATS[name])).max())
        worst = max(worst, err)
        if not err <= 1e-12:
            raise SystemExit(f"scoring {name}: stats {stats.tolist()} differ from the pinned "
                             f"{SCORING_STATS[name]} by {err:.3e}")
        for a in gt["annotations"]:
            a["iscrowd"] = 0
        exact = [{"image_id": a["image_id"], "category_id": 1, "keypoints": a["keypoints"],
                  "score": 1.0} for a in gt["annotations"]]
        ap = keypoint_stats(gt, exact, crowdpose)[0]
        if ap != 1.0:
            raise SystemExit(f"scoring {name}: the ground truth as detections scores AP {ap}")
    log(f"scoring: the ground truth scores AP 1.0 (COCO, CrowdPose); noisy detections the "
        f"pinned stats within {worst:.1e}")


def tta_model(cfg, device, dtype, seed):
    """The eval entry point's model with seeded random weights, the edge
    head's last bias raised to 2 so that, at the narrow width, edges pass
    the 0.8 grouping threshold and persons form."""
    from pemp_tpu_torch.models.pose_estimation import build_pose_model
    from pemp_tpu_torch.pipeline import init_random_weights

    model = build_pose_model(cfg, dtype=dtype, device=device, path="valid")
    init_random_weights(model, seed)
    if hasattr(model.mpn, "edge_classification"):   # the tag model has no edge head
        with torch.no_grad():
            model.mpn.edge_classification[-1].bias.fill_(2.0)
    return model


def phase_small_tta():
    """Multi-scale + flip test-time augmentation on the narrow configuration
    at scales [1.0, 0.5] with flip, two images of different sizes, the same
    weights on the CPU (plain versions) and on the card (kernels)."""
    from pemp_tpu_torch.config import small
    from pemp_tpu_torch.data.synthetic import eval_scenes
    from pemp_tpu_torch.tta.multi_scale import TTAPipeline

    cfg = small()
    cfg.merge_from_other({"DATASET": {"INPUT_SIZE": 64, "OUTPUT_SIZE": [16, 32]},
                          "TEST": {"SCALE_FACTOR": [1.0, 0.5], "FLIP_TEST": True}})
    images, _ = eval_scenes(np.random.RandomState(5), [(72, 96), (96, 80)])
    runs = {}
    for dev in ("cpu", "cuda"):
        pipe = TTAPipeline(tta_model(cfg, dev, torch.float32, 3), cfg)
        runs[dev] = [{k: v.cpu() if torch.is_tensor(v) else v for k, v in o.items()}
                     for o in pipe.run_batched(images, batch_size=2)]
    errs = {}
    for c, g in zip(runs["cpu"], runs["cuda"]):
        for key in ("nodes", "edge_index", "edge_valid", "node_valid", "person_valid"):
            if not torch.equal(c[key], g[key]):
                raise SystemExit(f"small TTA: {key} differs between CPU and card")
        # f32 on both sides (TF32 off), sums in other orders: each map within
        # 1e-4 of its largest; persons at the CPU tests' 2e-3 against JAX
        for key in ("scoremaps", "tags", "node_features"):
            errs[key] = max(errs.get(key, 0.0),
                            float((c[key] - g[key]).abs().max() / c[key].abs().max()))
        errs["persons"] = max(errs.get("persons", 0.0),
                              float((c["persons"] - g["persons"]).abs().max()))
    bad = {k: v for k, v in errs.items() if not v <= (2e-3 if k == "persons" else 1e-4)}
    found = sum(int(o["person_valid"].sum()) for o in runs["cpu"])
    if bad or found < 2:
        raise SystemExit(f"small TTA: CPU and card differ {bad}, or too few persons ({found})")
    log(f"small TTA: scales [1.0, 0.5] with flip, images 72x96 and 96x80, CPU vs card: "
        f"relative errors {errs}; graphs exact; persons found {found}")


def landscape(rendered, dataset):
    """The rendered images of 480x640 (8 of the 16) and their annotations,
    one batch of 8: the set of the full-width eval phases (19, 20, 28, 30,
    36, 39, 41), cut from the 16 images in two shapes for the smoke's time
    limit (at 4 images phase 30's score_based forms no person)."""
    keep = [i for i, im in enumerate(rendered) if im.shape[:2] == (480, 640)]
    ids = {dataset["images"][i]["id"] for i in keep}
    return [rendered[i] for i in keep], {
        **dataset, "images": [dataset["images"][i] for i in keep],
        "annotations": [a for a in dataset["annotations"] if a["image_id"] in ids]}


class RenderedSet:
    """A COCO-format eval set whose annotations file is written to ``root``
    and whose images are rendered arrays (the card's machine has no PIL)."""

    def __init__(self, root, images, dataset):
        import os

        from pemp_tpu_torch.data.datasets import CocoKeypoints

        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        with open(os.path.join(root, "annotations", "person_keypoints_val2017.json"), "w") as f:
            json.dump(dataset, f)
        base = CocoKeypoints(root, filter_empty=False)
        self.coco, self.img_ids = base.coco, base.img_ids
        self.images = {r["id"]: image for r, image in zip(dataset["images"], images)}

    def __len__(self):
        return len(self.img_ids)

    def load_raw(self, idx):
        img_id = int(self.img_ids[idx])
        return (img_id, self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id)),
                self.coco.loadImgs(img_id)[0], self.images[img_id])


def full_width_model(cfg, images):
    """tta_model at full width in bf16, made to form persons. Each
    BatchNorm's statistics are set to those of its input on ``images`` at
    scale 1, in one forward in layer order: without it the random maps
    grow to ~1e3 at full depth, the MPN's sigmoids saturate, and no node
    passes (node scores 0) or every edge does. Then the node head's last
    bias is raised to 2 and the edge head's set to 0.5, so that most nodes
    pass the threshold and edge scores lie on both sides of 0.5 for GAEC."""
    model = tta_model(cfg, "cuda", torch.bfloat16, 0)
    with torch.no_grad():
        measure_batchnorm(model, scale_one_inputs(model, cfg, images))
        model.mpn.node_classification[-1].bias.fill_(2.0)
        if hasattr(model.mpn, "edge_classification"):
            model.mpn.edge_classification[-1].bias.fill_(0.5)
    calm_mplayer(model)
    if getattr(model.mpn, "tag_pred", None) is not None:
        calm_tags(model, cfg, images)
    return model


def calm_tags(model, cfg, images):
    """A tag model groups its nodes by tag (valid._tag_grouping); at random
    weights the nodes' tags (the tag head's output plus the map's tag at
    the node) spread far past the grouping's tag threshold 1.0, so nearly
    every joint becomes a person of its own (564 an image at full width,
    each refined over every map). The backbone's tag rows and the tag
    head's last layer, the two linear ends of a node's tag, are scaled
    alike so that the valid nodes' tags spread 0.1 over ``images``, and
    joints join into persons."""
    from pemp_tpu_torch.tta.multi_scale import TTAPipeline

    j = cfg.DATASET.NUM_JOINTS
    head, last = model.backbone.final_layers[0], model.mpn.tag_pred[-1]
    with torch.no_grad():
        outs = TTAPipeline(model, cfg, with_decode=False).run_batched(images)
        tags = torch.cat([o["tag_pred"][o["node_valid"]] for o in outs]).float()
        factor = 0.1 / tags.std()
        scale = torch.ones(head.out_channels, device=head.weight.device)
        scale[j:2 * j] = factor
        head.weight.mul_(scale.to(head.weight.dtype)[:, None, None, None])
        head.bias.mul_(scale.to(head.bias.dtype))
        last.weight.mul_(factor.to(last.weight.dtype))
        last.bias.mul_(factor.to(last.bias.dtype))


def calm_mplayer(model):
    """An MPLayer sums up to C = 80 messages unnormalised, step after step:
    at random weights its features and logits grow to ~1e3 and beyond,
    past the sigmoids' range and past an absolute tolerance. The message
    weights of each MPLayer of the MPN (ClassificationMPN has two) are
    scaled by 0.01 to keep them in range (the CPU tests do the same); other
    layers are left as they are."""
    from pemp_tpu_torch.models.mpn.layers import MPLayer

    for layer in model.mpn.modules():
        if isinstance(layer, MPLayer):
            with torch.no_grad():
                layer.mlp_node[0].weight.mul_(0.01)


def scale_one_inputs(model, cfg, images):
    """The prepared scale-1 inputs of ``images`` (all of one shape) as the
    eval pipeline feeds them, on the card."""
    from pemp_tpu_torch.tta.multi_scale import TTAPipeline

    pipe = TTAPipeline(model, cfg, maps_only=True)
    x = np.stack([pipe._prepare(im)[0][pipe.scales.index(1.0)]["padded"] for im in images])
    return torch.from_numpy(x).cuda()


def measure_batchnorm(model, x):
    """Sets each BatchNorm's statistics to those of its input on ``x``, in
    one forward in layer order."""
    from pemp_tpu_torch.models.hrnet import BatchNorm2d

    def measure(bn, args):
        y = args[0].float()
        bn.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(y.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(measure) for m in model.modules()
             if isinstance(m, BatchNorm2d)]
    try:
        model.backbone_forward(x)
    finally:
        for h in hooks:
            h.remove()


def check_full_width_decode(label, cfg, model, images, half=None):
    """The pipeline over ``images`` in batches of 8; each image's persons
    (the card's threshold decode, or the host clustering and its decode on
    the card) against the same outputs decoded on the CPU: person_valid
    exact, keypoints within phase 18's 2e-3. With ``half`` 0 or 1 only the
    images half, half + 2, ... are decoded on the CPU too (the CPU decode
    is the slowest part of the full-width eval phases; a phase that runs
    several configurations alternates the halves). Fails unless persons
    form. Returns their number (the card's, over all images) and the
    largest error; keeps the valid edges and the edge slots over all
    images in ``check_full_width_decode.edges``."""
    from pemp_tpu_torch.tta.multi_scale import TTAPipeline
    from pemp_tpu_torch.valid import _greedy_grouping, _host_grouping, _tag_grouping

    tag = getattr(model.mpn, "tag_pred", None) is not None
    threshold = cfg.MODEL.GC.CC_METHOD == "threshold" and not tag
    host_grouping = _tag_grouping if tag else (
        _greedy_grouping if cfg.MODEL.GC.CC_METHOD == "greedy" else _host_grouping)
    pipe = TTAPipeline(model, cfg, with_decode=threshold)
    found, err = 0, 0.0
    outs = pipe.run_batched(images, batch_size=8)
    check_full_width_decode.edges = (sum(int(o["edge_valid"].sum()) for o in outs),
                                     sum(o["edge_valid"].numel() for o in outs))
    for i, out in enumerate(outs):
        if threshold:
            card_p, card_v = out["persons"], out["person_valid"]
        else:
            card_p, card_v = (torch.as_tensor(t) for t in host_grouping(out, cfg))
        found += int(card_v.sum())
        if half is not None and i % 2 != half:
            continue
        host = {k: v.cpu() if torch.is_tensor(v) else v for k, v in out.items()}
        if threshold:
            batch = {k: v[None] for k, v in host.items() if torch.is_tensor(v)}
            cpu_p, cpu_v = (t[0] for t in pipe.decode(batch))
        else:
            cpu_p, cpu_v = (torch.as_tensor(t) for t in host_grouping(host, cfg))
        if not torch.equal(card_v.cpu(), cpu_v):
            raise SystemExit(f"{label}: the card and the CPU decode other persons from the "
                             f"same outputs")
        if cpu_v.any():
            err = max(err, float((card_p.cpu() - cpu_p)[cpu_v].abs().max()))
    if found == 0 or not err <= 2e-3:
        raise SystemExit(f"{label}: {found} persons, card against CPU decode {err:.3e}")
    return found, err


def drive_valid(label, cfg, eval_set, batches, card, log_dir, model=None, k1=10, half=None):
    """valid.evaluate in batches of 8 at full width, bf16, after
    check_full_width_decode (which also warms up; ``half`` is its CPU
    decode's half of the images, None for all): a run with the counts
    zeroed just before and read just after (K1 ``k1`` times a batch,
    nothing else), timed, then one with the stages timed. Checks the report
    and that the results file holds persons; returns the K1 count, the
    stage times and the staged run's seconds."""
    import os

    from pemp_tpu_torch.valid import evaluate

    cfg.LOG_DIR = log_dir
    images = [eval_set.load_raw(i)[3] for i in range(len(eval_set))]
    if model is None:
        model = full_width_model(cfg, [im for im in images if im.shape == images[0].shape])
    found, err = check_full_width_decode(label, cfg, model, images, half)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    stats = evaluate(cfg, model, eval_set, "eval.txt", batch_size=8)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(label, {"K1": k1 * batches})
    peak = torch.cuda.max_memory_allocated() / 2**30
    split = cfg.TEST.SPLIT
    with open(os.path.join(log_dir, f"person_keypoints_{split}_mpn_results.json")) as f:
        results = json.load(f)
    n_stats = 10 if cfg.DATASET.DATASET == "coco" else 9
    if len(stats) != n_stats or not np.isfinite(stats).all() or not results or not all(
            np.isfinite(r["keypoints"]).all() and r["image_id"] in eval_set.img_ids
            for r in results):
        raise SystemExit(f"{label}: stats {list(stats)}, {len(results)} results")
    n = len(eval_set)
    valid_edges, slots = check_full_width_decode.edges
    log(f"{label}: {n} images in {batches} batches in {dt:.3f} s: {n / dt:.2f} img/s on "
        f"{card}; launches K1 {counts['K1']} ({counts['K1'] // batches} a batch); peak "
        f"memory {peak:.2f} GiB; {len(results)} persons, AP {stats[0]:.4f}; card against "
        f"CPU decode of the same outputs ({'all' if half is None else f'half {half} of the'} "
        f"images): {found} persons, largest error {err:.3e}; valid "
        f"edges {valid_edges / batches:.0f} a batch of {slots / batches:.0f} slots")
    stage_times = {}
    t0 = time.perf_counter()
    evaluate(cfg, model, eval_set, "stages.txt", batch_size=8, stage_times=stage_times)
    dt_staged = time.perf_counter() - t0
    split_ms = ", ".join(f"{k} {v * 1e3 / n:.1f}" for k, v in stage_times.items())
    log(f"{label}, stages timed (the card synchronised at each stage's end): {dt_staged:.3f} "
        f"s; ms an image by stage: {split_ms}; stages sum to "
        f"{sum(stage_times.values()):.3f} s")
    del model
    torch.cuda.empty_cache()
    return counts["K1"], stage_times, dt_staged


def rle_counts(mask):
    """Uncompressed COCO RLE counts of a binary mask (column-major runs,
    zeros first)."""
    flat = mask.flatten(order="F").astype(np.int8)
    edges = np.flatnonzero(np.diff(np.concatenate([[0], flat, [1 - flat[-1]]])))
    return np.diff(np.concatenate([[0], edges])).tolist()


def with_crowd_regions(dataset, image_ids):
    """Adds to each of ``image_ids`` a crowd annotation whose RLE mask
    covers a quarter of the image, so the training sample's ignore mask
    runs."""
    sizes = {r["id"]: (r["height"], r["width"]) for r in dataset["images"]}
    j = len(dataset["annotations"][0]["keypoints"]) // 3
    for img_id in image_ids:
        h, w = sizes[img_id]
        m = np.zeros((h, w), np.uint8)
        m[h // 4: h // 2, w // 4: w // 2] = 1
        dataset["annotations"].append({
            "id": len(dataset["annotations"]) + 1, "image_id": img_id, "category_id": 1,
            "keypoints": [0.0] * (3 * j), "num_keypoints": 0, "area": float(m.sum()),
            "bbox": [w / 4, h / 4, w / 4, h / 4], "iscrowd": 1,
            "segmentation": {"counts": rle_counts(m), "size": [h, w]}})
    return dataset


def rendered_train_set(root, mode, images, dataset, cfg, rng):
    """A COCO-format training set on rendered arrays (the card's machine
    has no PIL): data.datasets.CocoKeypoints with the training
    augmentation drawing from ``rng`` and the targets of ``cfg``'s output
    sizes (sigma 1 below 64, where the default size / 64 does not splat),
    its load_raw serving the arrays."""
    import os

    from pemp_tpu_torch.data.datasets import CocoKeypoints
    from pemp_tpu_torch.data.targets import HeatmapGenerator, JointsGenerator
    from pemp_tpu_torch.data.transforms import transforms_hr_train

    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    with open(os.path.join(root, "annotations", f"person_keypoints_{mode}2017.json"), "w") as f:
        json.dump(dataset, f)
    outs, nj = list(cfg.DATASET.OUTPUT_SIZE), cfg.DATASET.NUM_JOINTS
    sigma = -1 if min(outs) >= 64 else 1
    arrays = {r["id"]: image for r, image in zip(dataset["images"], images)}

    class Rendered(CocoKeypoints):
        def load_raw(self, idx):
            img_id = int(self.img_ids[idx])
            return (img_id, self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id)),
                    self.coco.loadImgs(img_id)[0], arrays[img_id])

    return Rendered(root, mode=mode, filter_empty=False, num_joints=nj,
                    transforms=transforms_hr_train(cfg, rng=rng),
                    heatmap_generator=[HeatmapGenerator(s, nj, sigma) for s in outs],
                    joint_generator=[JointsGenerator(cfg.DATASET.MAX_NUM_PEOPLE, nj, s, True)
                                     for s in outs])


def training_scenes(seed, n_train, n_val):
    """Rendered 480x640 and 640x480 scenes, the first two training images
    with a crowd region: (train images, train dataset, val images, val
    dataset)."""
    from pemp_tpu_torch.data.synthetic import eval_scenes

    sizes = [(480, 640), (640, 480)] * ((n_train + n_val + 1) // 2)
    images, dataset = eval_scenes(np.random.RandomState(seed), sizes[:n_train + n_val])
    train_ds = {"images": dataset["images"][:n_train], "categories": dataset["categories"],
                "annotations": [a for a in dataset["annotations"] if a["image_id"] <= n_train]}
    val_ds = {"images": dataset["images"][n_train:], "categories": dataset["categories"],
              "annotations": [a for a in dataset["annotations"] if a["image_id"] > n_train]}
    return images[:n_train], with_crowd_regions(train_ds, (1, 2)), images[n_train:], val_ds


# phase 22's configuration (b): what the training entry point's slice
# opened, on the small cut
OPENED = {"MODEL": {"GC": {"EDGE_LABEL_METHOD": 4, "USE_NEIGHBOURS": True},
                    "LOSS": {"NAME": ["edge", "node", "class", "heatmap", "tagmap"]}},
          "TRAIN": {"WITH_AE_LOSS": [True, False], "FREEZE_BN": False},
          "TPU": {"MATCHER": "greedy"}}


def f64_backbone_grads(cfg, state, batch, device):
    """The first step's gradients with the backbone and feature gather in
    float64 (the MPN in float32 on its kernels or plain versions). With the
    backbone's BatchNorm in training mode the float32 gradients of this
    random network's backbone are ill-conditioned (tests/
    test_torch_train_opened.py), so configuration (b) is compared so."""
    from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer

    trainer = build_trainer(cfg, device=device)
    m = trainer.model
    m.load_state_dict(state)
    m.backbone.double()
    m.feature_gather.double()
    m.dtype = torch.float64
    m.mpn_forward = lambda gb, route=None, feature_maps=None: m.mpn(
        gb.x, gb.edge_attr, gb.edge_index, gb.edge_valid, gb.edge_src_local, torch.float32,
        node_valid=gb.node_valid, route=route)
    loss, _, _ = trainer.loss(batch_to_torch(batch, device))
    loss.backward()
    return {k: p.grad.double().cpu() for k, p in m.named_parameters() if p.grad is not None}


def phase_small_train_entry():
    """train() on the small cut, CPU against card, one epoch of 2 steps and
    validation, for model_58_4's options (a) and the opened ones (b), on the
    same batches of a rendered COCO-format set."""
    import tempfile

    from pemp_tpu_torch.config import small_train
    from pemp_tpu_torch.data.datasets import DataLoader
    from pemp_tpu_torch.train.__main__ import train

    tr_images, tr_ds, va_images, va_ds = training_scenes(11, 8, 8)
    for label, opts in (("a", {}), ("b", OPENED)):
        cfg = small_train()
        cfg.merge_from_other({"PRINT_FREQ": 1, "MODEL": {"PRETRAINED": ""}})
        cfg.merge_from_other(opts)
        with tempfile.TemporaryDirectory() as tmp:
            rng = np.random.RandomState(3)
            train_set = rendered_train_set(tmp + "/set", "train", tr_images, tr_ds, cfg, rng)
            val_set = rendered_train_set(tmp + "/set", "val", va_images, va_ds, cfg, rng)
            bs = cfg.TRAIN.BATCH_SIZE
            batches = list(DataLoader(train_set, bs))[:2]      # images 1-4, crowds in 1 and 2
            val_batches = list(DataLoader(val_set, bs))
            masked = sum(int((b["masks"][-1] == 0).sum()) for b in batches)
            runs = {}
            for dev in ("cpu", "cuda"):
                first = {}

                def on_step(trainer, it, loss, logging, first=first):
                    if it:
                        return
                    m = trainer.model
                    first["labels"] = {k: (v[0] if isinstance(v, list) else v).cpu()
                                       for k, v in trainer.last_output["labels"].items()
                                       if k in ("node", "class", "person", "edge")}
                    first["parts"] = {k: float(v) for k, v in logging.items()}
                    first["grads"] = {k: p.grad.cpu() for k, p in m.named_parameters()
                                      if p.grad is not None}
                    first["stats"] = {k: b.cpu().clone() for k, b in m.backbone.named_buffers()
                                      if "running" in k}

                summary = train(cfg, batches, val_batches, f"{tmp}/{dev}", schedule_steps=2,
                                epochs=1, device=dev, seed=3, on_step=on_step)
                runs[dev] = (first, summary["val_losses"][0])
            (c, c_val), (g, g_val) = runs["cpu"], runs["cuda"]
            if not masked:
                raise SystemExit(f"small train() ({label}): the crowd regions masked nothing")
            for key in c["labels"]:
                if not torch.equal(c["labels"][key], g["labels"][key]):
                    raise SystemExit(f"small train() ({label}): labels {key} differ")
            bad = {k: (c["parts"][k], g["parts"][k]) for k in c["parts"]
                   if abs(c["parts"][k] - g["parts"][k]) > 5e-3 * abs(c["parts"][k]) + 1e-7}
            if bad:
                raise SystemExit(f"small train() ({label}): loss parts differ {bad}")
            if label == "a":
                gc, gg = c["grads"], g["grads"]
            else:
                from pemp_tpu_torch.pipeline import init_random_weights
                from pemp_tpu_torch.train.train_step import build_trainer

                model = build_trainer(cfg, device="cpu").model
                init_random_weights(model, 3)
                state = model.state_dict()
                gc = f64_backbone_grads(cfg, state, batches[0], "cpu")
                gg = f64_backbone_grads(cfg, state, batches[0], "cuda")
            if set(gc) != set(gg):
                raise SystemExit(f"small train() ({label}): different parameters have gradients")
            worst = max(((gc[k] - gg[k]).abs().max() / gc[k].abs().max()).item()
                        for k in gc if gc[k].abs().max() > 0)
            if not worst <= 5e-3:
                raise SystemExit(f"small train() ({label}): gradients differ by {worst:.2e} of "
                                 f"their largest")
            # each statistic within 1e-4 of its tensor's largest (a mean
            # near zero has no relative error of its own)
            stat_err = max(((c["stats"][k] - g["stats"][k]).abs().max()
                            / c["stats"][k].abs().max().clamp(min=1e-30)).item()
                           for k in c["stats"])
            if label == "b" and not stat_err <= 1e-4:
                raise SystemExit(f"small train() (b): backbone running statistics differ by "
                                 f"{stat_err:.2e} of their largest")
            if not abs(c_val - g_val) <= 1e-3 * abs(c_val):
                raise SystemExit(f"small train() ({label}): validation losses {c_val}, {g_val}")
        log(f"small train() ({label}), CPU vs card: labels exact "
            f"({int(c['labels']['node'].sum())} positive nodes, "
            f"{int(c['labels']['edge'].sum())} positive edges; {masked} masked output pixels); "
            f"loss {c['parts']['loss']:.6f} vs {g['parts']['loss']:.6f}; gradients"
            f"{' (backbone in float64)' if label == 'b' else ''} within {worst:.2e} of each "
            f"tensor's largest; backbone running statistics within {stat_err:.2e} of their largest; "
            f"validation loss {c_val:.6f} vs {g_val:.6f}")


def phase_train_entry(card):
    """train() at full width: model_58_4 as its preset gives it (w32/512,
    batch 8, f32, pallas, WORKERS threads) on 32 rendered training images
    and 8 validation images, 2 epochs of 4 steps with LR_STEP [1]; then
    CONTINUE for one more epoch and FINETUNE from the snapshot for one
    step. Returns the launch counts of the first run."""
    import os
    import tempfile

    from pemp_tpu_torch.config import w32_512_train
    from pemp_tpu_torch.data.datasets import DataLoader
    from pemp_tpu_torch.train.__main__ import train
    from pemp_tpu_torch.train.optim import multistep_lr

    cfg = w32_512_train()
    bs, workers = cfg.TRAIN.BATCH_SIZE, cfg.WORKERS
    t0 = time.perf_counter()
    tr_images, tr_ds, va_images, va_ds = training_scenes(13, 32, 8)
    log(f"train entry: 40 scenes rendered in {time.perf_counter() - t0:.1f} s (set-up)")
    with tempfile.TemporaryDirectory() as tmp:
        cfg.merge_from_other({"MODEL": {"PRETRAINED": ""}, "TRAIN": {"LR_STEP": [1]},
                              "LOG_DIR": f"{tmp}/log"})
        rng = np.random.RandomState(0)
        train_set = rendered_train_set(f"{tmp}/set", "train", tr_images, tr_ds, cfg, rng)
        val_set = rendered_train_set(f"{tmp}/set", "val", va_images, va_ds, cfg, rng)
        loader = DataLoader(train_set, bs, shuffle=True, num_workers=workers)
        val_loader = DataLoader(val_set, bs, num_workers=workers)
        steps = len(loader)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        summary = train(cfg, loader, val_loader, cfg.LOG_DIR, schedule_steps=steps, epochs=2,
                        seed=0)
        torch.cuda.synchronize()
        mpn_steps = cfg.MODEL.MPN.STEPS
        n_val = 2 * len(val_loader)
        counts = read_counts("train entry", {"K2": mpn_steps * (2 * steps + n_val),
                                             "K2b": mpn_steps * 2 * steps,
                                             "G1": mpn_steps * 2 * steps})
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = summary["losses"]
        ckpt = summary["ckpt_path"]
        if (len(losses) != 2 * steps or not np.isfinite(losses).all() or summary["fail_count"]
                or not all(np.isfinite(v) for v in summary["val_losses"].values())):
            raise SystemExit(f"train entry: losses {losses}, validation "
                             f"{summary['val_losses']}, {summary['fail_count']} skipped")
        with open(os.path.join(cfg.LOG_DIR, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        parts = [r for r in records if r["tag"] == "Loss/parts"]
        saved = torch.load(ckpt, weights_only=True)
        if (not parts or not {"heatmap", "node", "edge", "class_loss", "loss"} <= set(parts[0])
                or saved["epoch"] != 1 or not os.path.exists(f"{ckpt}.epoch0")):
            raise SystemExit(f"train entry: metrics {parts[:1]}, checkpoint epoch "
                             f"{saved['epoch']}, snapshot {os.path.exists(f'{ckpt}.epoch0')}")
        timed = summary["epochs"][1]
        n = timed["steps"] * bs
        log(f"train entry: model_58_4 w32/512 batch {bs} f32 pallas, {workers} loader threads, "
            f"32 training and 8 validation images (480x640, 640x480): epoch 1 (timed) "
            f"{timed['steps']} steps in {timed['seconds']:.3f} s: {n / timed['seconds']:.2f} "
            f"img/s on {card}; loader wait {timed['loader_s']:.3f} s "
            f"({100 * timed['loader_s'] / timed['seconds']:.1f} %), steps "
            f"{timed['step_s']:.3f} s, device time a step {1e3 * timed['device_s'] / timed['steps']:.1f} "
            f"ms (CUDA events around each step); epoch 0 {summary['epochs'][0]['seconds']:.3f} s "
            f"(loader wait {summary['epochs'][0]['loader_s']:.3f} s); peak memory {peak:.2f} GiB; "
            f"launches K2 {counts['K2']} (10 a step and a validation batch), K2b {counts['K2b']}, "
            f"G1 {counts['G1']}; losses {[round(x, 4) for x in losses]}; validation "
            f"{ {k: round(v, 4) for k, v in summary['val_losses'].items()} }")
        device_ms = 1e3 * timed["device_s"] / timed["steps"]

        # resume: the saved epoch runs again, from the restored count's rate
        firsts = []

        def first_lr(trainer, it, loss, logging):
            if len(firsts) < want_runs:
                firsts.append((it, trainer.optimizer.count - 1,
                               [g["lr"] for g in trainer.optimizer.opt.param_groups]))

        want_runs = 1
        cfg.TRAIN.CONTINUE = ckpt
        resumed = train(cfg, loader, None, f"{tmp}/resumed", schedule_steps=steps, epochs=2,
                        seed=0, on_step=first_lr)
        it, count, lrs = firsts[0]
        want = [multistep_lr(base, [1], cfg.TRAIN.LR_FACTOR, steps, count)
                for base in (cfg.TRAIN.LR, cfg.TRAIN.KP_LR)]
        if (resumed["start_epoch"] != 1 or count != 2 * steps or it != steps
                or not np.allclose(lrs, want, rtol=1e-12) or resumed["fail_count"]
                or not np.isfinite(resumed["losses"]).all()):
            raise SystemExit(f"train entry: resumed at epoch {resumed['start_epoch']}, "
                             f"iteration {it}, count {count}, rates {lrs} (want {want})")
        # finetune: the snapshot's weights, a fresh optimizer, one step
        want_runs = 2
        cfg.TRAIN.CONTINUE, cfg.TRAIN.FINETUNE = f"{ckpt}.epoch0", True
        one = DataLoader(val_set, bs, num_workers=workers)
        tuned = train(cfg, one, None, f"{tmp}/finetuned", schedule_steps=steps, epochs=1, seed=0,
                      on_step=first_lr)
        if (firsts[1][:2] != (0, 0) or tuned["fail_count"]
                or not np.isfinite(tuned["losses"]).all()):
            raise SystemExit(f"train entry: finetune first step {firsts[1]}, "
                             f"losses {tuned['losses']}")
        log(f"train entry: CONTINUE re-ran epoch 1 from update {count} at rates "
            f"{[f'{x:.3e}' for x in lrs]} (multistep_lr at the restored count), losses "
            f"{[round(x, 4) for x in resumed['losses']]}; FINETUNE from the epoch-0 snapshot: "
            f"a fresh optimizer, loss {tuned['losses'][0]:.4f}")
    return {**counts, "device_ms": device_ms}


def phase_small_hg():
    """The narrow Hourglass (config.small_hg: 2 stacks 16 wide at 512,
    long-side scaling) through TTAPipeline with ``maps_only`` at scales
    [1.0, 0.5] with flip on two images of different sizes, the same seeded
    weights on the CPU and on the card: the aggregated maps within 1e-4 of
    each one's largest, the same canvas and scaling; then HG's parser on
    each side's maps (host numpy: only the maps come from the card)."""
    from pemp_tpu_torch.config import small_hg
    from pemp_tpu_torch.data.synthetic import eval_scenes
    from pemp_tpu_torch.decode.group_hg import HeatmapParserHG
    from pemp_tpu_torch.models.ae_group import build_ae_group_model
    from pemp_tpu_torch.pipeline import init_random_weights
    from pemp_tpu_torch.tta.multi_scale import TTAPipeline
    from pemp_tpu_torch.valid_hr import host_maps

    cfg = small_hg()
    cfg.merge_from_other({"TEST": {"SCALE_FACTOR": [1.0, 0.5], "FLIP_TEST": True}})
    images, _ = eval_scenes(np.random.RandomState(5), [(72, 96), (96, 80)])
    runs = {}
    for dev in ("cpu", "cuda"):
        model = build_ae_group_model(cfg, device=dev)
        init_random_weights(model, 3)
        runs[dev] = [{k: v.cpu() if torch.is_tensor(v) else v for k, v in o.items()}
                     for o in TTAPipeline(model, cfg, maps_only=True).run_batched(images, 2)]
    errs = {}
    for c, g in zip(runs["cpu"], runs["cuda"]):
        if (c["canvas_size"], c["scaling_type"]) != (g["canvas_size"], g["scaling_type"]) \
                or c["scaling_type"] != "long_with_multiscale":
            raise SystemExit(f"small Hourglass: canvas or scaling {c['canvas_size']}, "
                             f"{c['scaling_type']} against {g['canvas_size']}, {g['scaling_type']}")
        # f32 on both sides (TF32 off), sums in other orders
        for key in ("scoremaps", "tags"):
            errs[key] = max(errs.get(key, 0.0),
                            float((c[key] - g[key]).abs().max() / c[key].abs().max()))
    if not all(v <= 1e-4 for v in errs.values()):
        raise SystemExit(f"small Hourglass: CPU and card maps differ {errs}")
    parser = HeatmapParserHG(cfg)
    found = {dev: [len(parser.parse(*host_maps(o))[0]) for o in outs]
             for dev, outs in runs.items()}
    log(f"small Hourglass maps_only: scales [1.0, 0.5] with flip, images 72x96 and 96x80, "
        f"canvas {runs['cpu'][0]['canvas_size']}, CPU vs card: relative errors {errs}; HG "
        f"parser persons per image from the CPU's maps {found['cpu']}, from the card's "
        f"{found['cuda']}")


def ae_full_width_model(cfg, images):
    """models.ae_group at full width in f32 (the AE-grouping entry point's
    type) with seeded random weights, made to form persons on ``images``
    (all of one shape): HigherHRNet's BatchNorm statistics from the images
    (as full_width_model), then each output head's heat row scaled so that
    the 5th-highest NMS peak of its joint type's map (the median over the
    images) sits at the 0.1 detection threshold, and each tag row so that
    its spread is 0.3, below the parsers' 1.0 tag threshold, so that joints
    join. Three passes: HigherHRNet's second head reads the first's output."""
    from pemp_tpu_torch.models.ae_group import build_ae_group_model
    from pemp_tpu_torch.ops.detection import nms_mask
    from pemp_tpu_torch.pipeline import init_random_weights

    model = build_ae_group_model(cfg, device="cuda")
    init_random_weights(model, 0)
    x = scale_one_inputs(model, cfg, images)
    j = cfg.DATASET.NUM_JOINTS
    if cfg.MODEL.KP == "hourglass":
        heads = [(model.backbone.outs[-1].conv, 2 * j)]
    else:
        heads = [(model.backbone.final_layers[0], 2 * j), (model.backbone.final_layers[1], j)]
    with torch.no_grad():
        measure_batchnorm(model, x)
        for _ in range(3):
            _, heat, _, tags = model.backbone_forward(x)
            heat = heat.permute(0, 3, 1, 2)
            kth = (nms_mask(heat, 5) * heat).flatten(2).topk(5, dim=-1).values[..., -1]
            kth = kth.median(dim=0).values                              # (J,)
            # a type whose peaks all lie below 0 has its row negated first
            s_heat = torch.where(kth > 0, 0.1 / kth, -torch.ones_like(kth))
            s_tag = 0.3 / tags.flatten(0, 2).std(dim=0)                # (J,)
            for conv, channels in heads:
                scale = torch.ones(conv.out_channels, device="cuda")
                scale[:j], scale[j:channels] = s_heat, s_tag[:channels - j]
                conv.weight.mul_(scale[:, None, None, None])
                conv.bias.mul_(scale)
        if not bool((s_heat > 0).all()):
            raise SystemExit(f"{cfg.MODEL.KP}: a joint type's map has no positive peaks")
    return model


def phase_valid_hr(card, rendered, dataset):
    """The AE-grouping entry point at full width (valid_hr.evaluate, batches
    of 8, f32): hg_512 (4 stacks 256 wide, 512, long-side scaling) with the
    hg and hg2 parsers, and w32/512 with flip and the hr parser, on the
    rendered images given, weights from ae_full_width_model. Per configuration
    the card's maps are held against the CPU's on two images (1e-4 of each
    one's largest); per parser a run with each stage timed, whose outputs
    are kept: the results files (AE grouping and correlation clustering)
    must hold persons and equal the host's parse of the card's maps, and a
    timed run (img/s). Returns {config: {parser: numbers}}."""
    import os
    import tempfile

    from pemp_tpu_torch import valid_hr
    from pemp_tpu_torch.config import hg_512, w32_512
    from pemp_tpu_torch.models.ae_group import build_ae_group_model
    from pemp_tpu_torch.tta.multi_scale import TTAPipeline

    numbers = {}
    same = [im for im in rendered if im.shape == rendered[0].shape]
    with tempfile.TemporaryDirectory() as tmp:
        eval_set = RenderedSet(tmp, rendered, dataset)
        n = len(eval_set)
        for name, cfg, parsers in (("hg_512", hg_512(), ("hg", "hg2")),
                                   ("w32_512", w32_512(), ("hr",))):
            t_phase = time.perf_counter()
            cfg.LOG_DIR = os.path.join(tmp, name)
            model = ae_full_width_model(cfg, same)
            cpu_model = build_ae_group_model(cfg, device="cpu")
            cpu_model.load_state_dict(model.state_dict())
            card_out = TTAPipeline(model, cfg, maps_only=True).run_batched(rendered[:2], 2)
            cpu_out = TTAPipeline(cpu_model, cfg, maps_only=True).run_batched(rendered[:2], 2)
            del cpu_model
            # f32 on both sides (TF32 off), sums in other orders
            errs = {key: max(float((c[key] - g[key].cpu()).abs().max() / c[key].abs().max())
                             for c, g in zip(cpu_out, card_out)) for key in ("scoremaps", "tags")}
            if not all(v <= 1e-4 for v in errs.values()):
                raise SystemExit(f"valid_hr {name}: CPU and card maps differ {errs}")
            log(f"valid_hr {name}: card against CPU maps on two images, relative errors {errs}; "
                f"canvas {card_out[0]['canvas_size']}, scaling {card_out[0]['scaling_type']}")
            numbers[name] = {}
            for parser in parsers:
                kept = []
                real = TTAPipeline.run_batched

                def recording(self, images, batch_size=8):
                    outs = real(self, images, batch_size)
                    kept.extend({k: v.cpu() if torch.is_tensor(v) else v for k, v in o.items()}
                                for o in outs)
                    return outs

                stage_times = {}
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                TTAPipeline.run_batched = recording
                try:
                    valid_hr.evaluate(cfg, model, eval_set, f"{parser}_staged.txt",
                                      parser=parser, batch_size=8, stage_times=stage_times)
                finally:
                    TTAPipeline.run_batched = real
                peak = torch.cuda.max_memory_allocated() / 2**30
                # the card's persons against the host's parse of the same maps
                ae_parser = valid_hr.make_parser(parser, cfg)
                want = {"dt_ae.json": [], "dt_cc.json": []}
                for i, out in enumerate(kept):
                    det, tags = valid_hr.host_maps(out)
                    grouped, persons_cc = valid_hr.group(parser, ae_parser, det, tags, cfg)
                    for key, persons in (("dt_ae.json", grouped), ("dt_cc.json", persons_cc)):
                        ann = valid_hr.to_anns(persons, out, int(eval_set.img_ids[i]), cfg)
                        want[key].extend(ann or [])
                found = {}
                for key, anns in want.items():
                    with open(os.path.join(cfg.LOG_DIR, key)) as f:
                        got = json.load(f)
                    if not got or got != json.loads(json.dumps(anns)):
                        raise SystemExit(f"valid_hr {name} {parser}: {key} holds {len(got)} "
                                         f"persons, the host's parse of the card's maps "
                                         f"{len(anns)}, or they differ")
                    found[key] = len(got)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stats_ae, stats_cc = valid_hr.evaluate(cfg, model, eval_set, f"{parser}.txt",
                                                       parser=parser, batch_size=8)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                with open(os.path.join(cfg.LOG_DIR, f"{parser}.txt")) as f:
                    kpt = [line.split()[-1] for line in f if line.startswith("kpt_forward")][0]
                split_ms = ", ".join(f"{k} {v * 1e3 / n:.1f}" for k, v in stage_times.items())
                log(f"valid_hr {name} {parser}: {n} images in {dt:.3f} s: {n / dt:.2f} img/s "
                    f"with the host parse on {card} (kpt_forward {float(kpt) * 1e3:.2f} ms an "
                    f"image); persons AE {found['dt_ae.json']}, clustering "
                    f"{found['dt_cc.json']}, equal to the host's parse of the card's maps; AP "
                    f"AE {stats_ae[0]:.4f}, clustering {stats_cc[0]:.4f}; peak memory "
                    f"{peak:.2f} GiB; stages timed (the card synchronised at each stage's "
                    f"end), ms an image: {split_ms}")
                numbers[name][parser] = dict(img_s=n / dt, stages=stage_times, peak=peak)
            del model
            torch.cuda.empty_cache()
            log(f"valid_hr {name}: done in {time.perf_counter() - t_phase:.1f} s")
    return numbers


def phase_model_81_1_2(card, sizes):
    """Phases 25-27: model_81_1_2 at full width. 25: K1 against its plain
    version on the step-0 inputs of its eval path (bf16, batch 8 at
    480x640, T = 14), K2 and K2b on its training path's (f32, batch 8). 26:
    valid.evaluate with GAEC on 16 rendered images with 14 joints (K1 10
    times a batch). 27: 1 warm-up and 3 timed training steps (K2, K2b and
    G1 10 times each a step). Returns the errors and the launch counts."""
    import tempfile

    from pemp_tpu_torch.config import model_81_1_2
    from pemp_tpu_torch.data.synthetic import eval_scenes, make_batch
    from pemp_tpu_torch.ops import fused_step, typed_message
    from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer
    from pemp_tpu_torch.tta.multi_scale import TTAPipeline

    out = {}
    t0 = time.perf_counter()
    rendered14, dataset14 = eval_scenes(np.random.RandomState(11), sizes, num_joints=14)
    cfg81 = model_81_1_2()
    cfg81.MODEL.MPN.NODE_THRESHOLD = 0.5   # the file's 1.0: no sigmoid score passes it
    model81 = full_width_model(cfg81, [im for im in rendered14
                                       if im.shape == rendered14[0].shape])
    tta81 = TTAPipeline(model81, cfg81, with_decode=False)
    args = capture_eval_inputs(lambda ims: tta81.run_batched(ims, batch_size=8),
                               rendered14[0::2], "fused_mpn_step", steps=(0,))[0]
    if args[4].shape[1] != 14 or args[0].shape[0] != 8 * 14 * cfg81.TPU.NODES_PER_TYPE:
        raise SystemExit(f"model_81_1_2 eval path: K1's a is {tuple(args[4].shape)}, "
                         f"p {tuple(args[0].shape)}")
    out["K1 err"] = check_k1("model_81_1_2 step 0 bf16 (T 14)", args[:13], args[13:], 2e-2,
                             fused_step)[0]
    del tta81, args
    train81 = model_81_1_2()
    rng = np.random.RandomState(12)
    size = train81.DATASET.INPUT_SIZE
    batches81 = [batch_to_torch(make_batch(rng, train81.TRAIN.BATCH_SIZE, size,
                                           tuple(train81.DATASET.OUTPUT_SIZE), 14,
                                           train81.DATASET.MAX_NUM_PEOPLE), "cuda")
                 for _ in range(4)]
    trainer = build_trainer(train81, device="cuda", seed=0)
    args, g = capture_train_inputs(trainer, batches81[0], "fused_typed_message_aggregate",
                                   steps=(0,))[0]
    if args[1].shape[1] != 14:
        raise SystemExit(f"model_81_1_2 train path: K2's a is {tuple(args[1].shape)}")
    numbers = check_k2("model_81_1_2 train path step 0 (T 14)", args[:6], g, args[6:],
                       typed_message)
    out["K2 errs"] = {way: v[0] for way, v in numbers.items()}
    log(f"K2/K2b groups and blocks, model_81_1_2 train path step 0: "
        f"{k2_group_stats(args, args[6:], typed_message._CHUNK)}")
    del args, g
    torch.cuda.empty_cache()
    log(f"chip_smoke: phase 25 done in {time.perf_counter() - t0:.1f} s")

    # 26. through the eval entry point: one scale, GAEC on the host,
    # CrowdPose scoring; two shapes, so two batches of 8
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        eval_set = RenderedSet(tmp, rendered14, dataset14)
        out["K1"], times, dt = drive_valid("valid model_81_1_2 GAEC", cfg81, eval_set, 2, card,
                                           tmp, model=model81)
    del model81
    torch.cuda.empty_cache()
    log(f"valid model_81_1_2 GAEC: host clustering and its decode {times['cluster']:.3f} s "
        f"of the staged run's {dt:.3f} ({100 * times['cluster'] / dt:.1f} %)")
    log(f"chip_smoke: phase 26 done in {time.perf_counter() - t0:.1f} s")

    # 27. training: 1 warm-up step and 3 timed
    t0 = time.perf_counter()
    steps = train81.MODEL.MPN.STEPS
    counts = drive_train("model_81_1_2 training", trainer, batches81,
                         {"K2": steps, "K2b": steps, "G1": steps}, card, model="model_81_1_2")
    out.update({k: counts[k] for k in ("K2", "K2b", "G1")})
    del trainer, batches81
    torch.cuda.empty_cache()
    log(f"chip_smoke: phase 27 done in {time.perf_counter() - t0:.1f} s")
    return out


# Phases 29-31: the ablation configurations (config.ABLATIONS, model_58_4
# with each delta merged): per configuration the kernels its path runs a
# batch or a step (MPLayer and the edge-list routes run none)
ABLATION_EVAL = {"connectivity/fully": 0, "connectivity/score_based": 0,
                 "connectivity/score_based_per_type": 0,
                 "feature_importance/model_gostic_position": 0,
                 "feature_importance/model_nothing": 10}
ABLATION_TRAIN = {"connectivity/score_based": {},
                  "feature_importance/model_gostic_position": {},
                  "train/model_50_4": {},
                  "feature_importance/model_nothing": {"K2": 10, "K2b": 10, "G1": 10}}


def small_ablation(name, eval_cut):
    """small_train() with the ablation ``name`` merged; for the eval slice
    without a checkpoint, threshold grouping at node threshold 0.1."""
    from pemp_tpu_torch.config import ablation, small_train

    cfg = ablation(name, small_train())
    if eval_cut:
        cfg.merge_from_other({"MODEL": {"PRETRAINED": "", "GC": {"CC_METHOD": "threshold"},
                                        "MPN": {"NODE_THRESHOLD": 0.1}}})
    return cfg


def phase_ablations(card, rendered, dataset):
    """Phases 29-31. 29: small cuts CPU against card, as phases 4 and 7:
    eval slices of fully, score_based, model_gostic_position (MPLayer on
    the kNN layout) and model_nothing (K1 on one-column edge features);
    training steps of fully, score_based, model_gostic_position, model_50_4
    (VanillaMPN, edge loss, frozen backbone) and model_nothing (K2, K2b,
    G1). 30: valid.evaluate at full width (model_58_4's w32/512, bf16, one
    scale, GAEC at node threshold 0.5, as phase 20) on the 8 rendered
    images of 480x640 (one batch) for fully, score_based, score_based_per_type,
    model_gostic_position and model_nothing, the CPU's reference decode on
    the even and the odd images in turn: K1 10 times a batch on
    model_nothing, never on the others. 31: training at full width
    (model_58_4, batch 8, f32, synthetic batches), 1 warm-up and 3 timed
    steps, for score_based, model_gostic_position, model_50_4 and
    model_nothing (K2, K2b, G1 10 times a step on model_nothing, no kernel
    on the others). Returns the launch counts of the timed runs."""
    import tempfile

    from pemp_tpu_torch.config import ablation
    from pemp_tpu_torch.data.synthetic import make_batch
    from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer

    short = lambda name: name.split("/")[1]  # noqa: E731
    t0 = time.perf_counter()
    for name in ("connectivity/fully", "connectivity/score_based",
                 "feature_importance/model_gostic_position", "feature_importance/model_nothing"):
        phase_small_slice("auto", small_ablation(name, True), f"small {short(name)} slice")
    for name in ("connectivity/fully", "connectivity/score_based",
                 "feature_importance/model_gostic_position", "train/model_50_4",
                 "feature_importance/model_nothing"):
        phase_small_train("auto", small_ablation(name, False), f"small {short(name)} train",
                          f64_bound=True)
    log(f"chip_smoke: phase 29 done in {time.perf_counter() - t0:.1f} s")

    counts = {"K1": 0, "K2": 0, "K2b": 0, "G1": 0}
    t0 = time.perf_counter()
    # the 8 images of 480x640, one batch: phase 30 is the first depth cut
    # for the smoke's time limit, as the smoke grew past 950 s
    with tempfile.TemporaryDirectory() as tmp:
        eval_set = RenderedSet(tmp, *landscape(rendered, dataset))
        for i, (name, k1) in enumerate(ABLATION_EVAL.items()):
            cfg = ablation(name)
            cfg.MODEL.MPN.NODE_THRESHOLD = 0.5   # the file's 1.0: no sigmoid passes it
            count, times, dt = drive_valid(f"valid {short(name)} GAEC", cfg, eval_set, 1, card,
                                           tmp, k1=k1, half=i % 2)
            counts["K1"] += count
            log(f"valid {short(name)} GAEC: host clustering and its decode "
                f"{times['cluster']:.3f} s of the staged run's {dt:.3f} "
                f"({100 * times['cluster'] / dt:.1f} %)")
    log(f"chip_smoke: phase 30 done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    base = ablation("connectivity/score_based")
    rng = np.random.RandomState(13)
    batches = [batch_to_torch(make_batch(rng, base.TRAIN.BATCH_SIZE, base.DATASET.INPUT_SIZE,
                                         tuple(base.DATASET.OUTPUT_SIZE), 17,
                                         base.DATASET.MAX_NUM_PEOPLE), "cuda")
               for _ in range(4)]
    for name, want in ABLATION_TRAIN.items():
        trainer = build_trainer(ablation(name), device="cuda", seed=0)
        calm_mplayer(trainer.model)
        got = drive_train(f"{short(name)} training", trainer, batches, want, card,
                          model=short(name))
        for k in ("K2", "K2b", "G1"):
            counts[k] += got[k]
        del trainer
        torch.cuda.empty_cache()
    log(f"chip_smoke: phase 31 done in {time.perf_counter() - t0:.1f} s")
    return counts


# the graph paths on the GT joints that training takes (phases 32-33)
GT_TRAIN = {"method 7 + WEIGHT_CLASS_LOSS": {"MODEL": {"GC": {"EDGE_LABEL_METHOD": 7,
                                                              "WEIGHT_CLASS_LOSS": True}}},
            "USE_GT + method 2": {"MODEL": {"GC": {"USE_GT": True, "EDGE_LABEL_METHOD": 2}}}}


def gt_train_cut(label):
    from pemp_tpu_torch.config import small_train

    cfg = small_train()
    cfg.merge_from_other(GT_TRAIN[label])
    return cfg


def phase_small_gt():
    """Phase 32, the small cut CPU against card: training steps with method
    7 and the weighted class loss on pallas, with USE_GT and method 2 on
    pallas and dots (phase 29's limits: labels exact, loss parts 1e-4,
    gradients against the CPU's float64 step)."""
    for label in GT_TRAIN:
        phase_small_train("pallas", gt_train_cut(label), f"small {label} train", f64_bound=True)
    phase_small_train("dots", gt_train_cut("USE_GT + method 2"), "small USE_GT + method 2 train",
                      f64_bound=True)


def phase_gt_train(card):
    """Phase 33: model_58_4 at full width (w32/512, batch 8, f32, pallas)
    through ``train()`` on 2 synthetic batches for 2 epochs (4 steps), with
    method 7 and the weighted class loss, then with USE_GT and method 2;
    the counts zeroed just before each run and read just after (K2, K2b and
    G1 10 times a step). Losses finite, no step skipped. Prints the device
    time a step over the second epoch (CUDA events around each step) and
    the peak memory. Then K2 and K2b on the USE_GT layout at this width
    (person-major GT nodes, source types gathered from the nodes, an
    invalid tail), their inputs taken at MPN steps 0 and 9 of one training
    step on the first batch, against their plain versions as phase 6 holds
    them. Returns the launch counts and K2's and K2b's errors."""
    import tempfile

    from pemp_tpu_torch.config import w32_512_train
    from pemp_tpu_torch.data.synthetic import make_batch
    from pemp_tpu_torch.ops import typed_message
    from pemp_tpu_torch.train.__main__ import train
    from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer

    rng = np.random.RandomState(21)
    base = w32_512_train()
    batches = [make_batch(rng, base.TRAIN.BATCH_SIZE, base.DATASET.INPUT_SIZE,
                          tuple(base.DATASET.OUTPUT_SIZE), 17, base.DATASET.MAX_NUM_PEOPLE)
               for _ in range(2)]
    total = {"K2": 0, "K2b": 0, "G1": 0}
    steps = base.MODEL.MPN.STEPS
    with tempfile.TemporaryDirectory() as tmp:
        for label in GT_TRAIN:
            cfg = w32_512_train()
            cfg.merge_from_other(GT_TRAIN[label])
            cfg.merge_from_other({"MODEL": {"PRETRAINED": ""}, "LOG_DIR": f"{tmp}/log",
                                  "PRINT_FREQ": 100})
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            summary = train(cfg, batches, None, cfg.LOG_DIR, schedule_steps=2, epochs=2, seed=0)
            torch.cuda.synchronize()
            n = 2 * len(batches)
            counts = read_counts(f"{label} train", {"K2": steps * n, "K2b": steps * n,
                                                    "G1": steps * n})
            losses = summary["losses"]
            if len(losses) != n or not np.isfinite(losses).all() or summary["fail_count"]:
                raise SystemExit(f"{label} train: losses {losses}, "
                                 f"{summary['fail_count']} skipped")
            timed = summary["epochs"][1]
            for k in total:
                total[k] += counts[k]
            log(f"{label} train: model_58_4 w32/512 batch {cfg.TRAIN.BATCH_SIZE} f32 pallas "
                f"through train(), {n} steps on {card}: device time a step "
                f"{1e3 * timed['device_s'] / timed['steps']:.1f} ms (epoch 1, CUDA events "
                f"around each step), epoch 1 {timed['seconds']:.3f} s; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches K2 "
                f"{counts['K2']}, K2b {counts['K2b']}, G1 {counts['G1']} (10 a step each); "
                f"losses {[round(x, 4) for x in losses]}")
    errs = {"fwd": [], "bwd": []}
    trainer = build_trainer(cfg, device="cuda", seed=0)
    captured = capture_train_inputs(trainer, batch_to_torch(batches[0], "cuda"),
                                    "fused_typed_message_aggregate")
    for step in (0, 9):
        args, g = captured[step]
        numbers = check_k2(f"USE_GT train path step {step}", args[:6], g, args[6:],
                           typed_message)
        for way in errs:
            errs[way].append(numbers[way][0])
    log(f"K2/K2b groups and blocks, USE_GT train path step 0: "
        f"{k2_group_stats(captured[0][0], captured[0][0][6:], typed_message._CHUNK)}")
    del trainer, captured, args, g
    torch.cuda.empty_cache()
    return total, errs


UB_FILES = {"upper_bound/hg": 4, "upper_bound/hrnet": 2, "upper_bound/mmpose_hrnet": 2}


def phase_upper_bounds(card, rendered, dataset):
    """Phase 34: ``calc_upper_bounds.evaluate`` (upper_bound/hrnet: the GT
    joints as nodes, method 2) on the 16 rendered images on the card and on
    the CPU: the same persons per image, keypoints within 2e-3, scores
    within 1e-6, the same stats; prints the AP and each side's seconds.
    Then UpperBoundModel at full width for the three upper_bound files
    (the 4-stack Hourglass at 512, HigherHRNet-w32 at 512, mmpose_hrnet at
    14 joints; seeded random weights, batch 8 of synthetic scenes, each
    file's own graph settings): no kernel launches; the graph, labels and
    masks exact against the CPU's graph on the card's maps."""
    import tempfile

    from pemp_tpu_torch import calc_upper_bounds as cub
    from pemp_tpu_torch.config import upper_bound
    from pemp_tpu_torch.data.synthetic import make_batch
    from pemp_tpu_torch.graph.constructor import construct_graph_batch
    from pemp_tpu_torch.models.upper_bound import build_upper_bound_model
    from pemp_tpu_torch.pipeline import init_random_weights
    from pemp_tpu_torch.train.train_step import batch_to_torch

    with tempfile.TemporaryDirectory() as tmp:
        eval_set = RenderedSet(tmp, rendered, dataset)
        res = {}
        for dev in ("cuda", "cpu"):
            cfg = cub.upper_bound_config(upper_bound("upper_bound/hrnet"))
            cfg.LOG_DIR = f"{tmp}/{dev}"
            t0 = time.perf_counter()
            stats, anns = cub.evaluate(cfg, eval_set, "ub.txt", device=dev)
            res[dev] = (np.asarray(stats), anns, time.perf_counter() - t0)
    (s_card, a_card, t_card), (s_cpu, a_cpu, t_cpu) = res["cuda"], res["cpu"]
    flat = lambda anns, key: [p[key] for image in anns for p in image]  # noqa: E731
    ids = [[p["image_id"] for p in image] for image in a_card]
    kp_err = np.abs(np.asarray(flat(a_card, "keypoints")) - np.asarray(flat(a_cpu, "keypoints")))
    sc_err = np.abs(np.asarray(flat(a_card, "score")) - np.asarray(flat(a_cpu, "score")))
    if (ids != [[p["image_id"] for p in image] for image in a_cpu] or not len(ids)
            or not kp_err.max() <= 2e-3 or not sc_err.max() <= 1e-6
            or not np.array_equal(s_card, s_cpu)):
        raise SystemExit(f"calc_upper_bounds: card {len(flat(a_card, 'score'))} persons, CPU "
                         f"{len(flat(a_cpu, 'score'))}; keypoints within {kp_err.max()}, scores "
                         f"within {sc_err.max()}; stats {s_card} against {s_cpu}")
    log(f"calc_upper_bounds upper_bound/hrnet on 16 rendered images: AP {s_card[0]:.4f} "
        f"(AP50 {s_card[1]:.4f}), {len(flat(a_card, 'score'))} persons; card {t_card:.2f} s, "
        f"CPU {t_cpu:.2f} s; keypoints within {kp_err.max():.1e} of the CPU's, stats equal")

    rng = np.random.RandomState(22)
    for name, stride in UB_FILES.items():
        cfg = upper_bound(name)
        j = cfg.DATASET.NUM_JOINTS
        model = build_upper_bound_model(cfg, device="cuda")
        init_random_weights(model, 0)
        tb = batch_to_torch(make_batch(rng, 8, 512, (512 // stride,), j, 30), "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            sm, out = model(tb["imgs"], tb["keypoints"], masks=tb["masks"][-1],
                            factors=tb["factors"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        read_counts(f"upper bound {name}", {})
        h, w = sm.shape[1:3]
        gb = construct_graph_batch(model.gc, sm.cpu(), torch.zeros(8, h, w, 1),
                                   out["graph"]["tags"].cpu(), masks=tb["masks"][-1].cpu(),
                                   joints_gt=tb["keypoints"].cpu(), factors=tb["factors"].cpu(),
                                   testing=True)
        pairs = {"labels edge": ("labels", "edge", gb.edge_labels),
                 "labels node": ("labels", "node", gb.node_labels),
                 "labels class": ("labels", "class", gb.node_classes),
                 "labels refine": ("labels", "refine", gb.node_persons),
                 "masks edge": ("masks", "edge", gb.label_mask),
                 "masks node": ("masks", "node", gb.label_mask_node),
                 "nodes": ("graph", "nodes", gb.joint_det),
                 "edge_index": ("graph", "edge_index", gb.edge_index),
                 "node_valid": ("graph", "node_valid", gb.node_valid),
                 "edge_valid": ("graph", "edge_valid", gb.edge_valid)}
        for what, (part, key, want) in pairs.items():
            if not torch.equal(out[part][key].cpu(), want):
                raise SystemExit(f"upper bound {name}: {what} differ between card and CPU")
        if not bool(torch.isfinite(sm).all()):
            raise SystemExit(f"upper bound {name}: non-finite score maps")
        log(f"upper bound {name}: UpperBoundModel ({model.backbone_name}) batch 8 at 512, maps "
            f"{h}x{w}, f32 on {card}: forward {dt:.3f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; no kernel launches; graph, "
            f"labels and masks exact against the CPU's graph on the card's maps (method "
            f"{model.gc.edge_label_method}, valid nodes {int(gb.node_valid.sum())}/"
            f"{gb.node_valid.numel()}, label-positive nodes {int(gb.node_labels.sum())}, "
            f"edges {int(gb.edge_labels.sum())})")
        del model, sm, out
        torch.cuda.empty_cache()


# Phases 35-37: the tag-regression, background-class, group-based and
# greedy configurations (config.ZOO over model_58_4; MPNTag and
# JointTypeClassification, config.ZOO_CUTS, on the small cut only)
ZOO_SMALL = (("tag", {}), ("tag", {"MODEL": {"MPN": {"NODE_STEPS": 2}}}), ("pure_tag", {}),
             ("group_based", {}), ("background", {}), ("joint_type", {}))
# K2, K2b and G1 a training step at full width: one launch each an MPN
# step, two on the group-based model (a pass within body parts, one across)
ZOO_TRAIN = {"tag": 10, "background": 10, "group_based": 20}


def zoo_cut(name, extra, eval_cut):
    """small_train() with the delta ``name`` and ``extra`` merged; for the
    eval slice without a checkpoint, threshold grouping at node threshold
    0.1."""
    from pemp_tpu_torch.config import small_train, zoo

    cfg = zoo(name, small_train())
    cfg.merge_from_other(extra)
    if eval_cut:
        cfg.merge_from_other({"MODEL": {"PRETRAINED": "", "GC": {"CC_METHOD": "threshold"},
                                        "MPN": {"NODE_THRESHOLD": 0.1}}})
    return cfg


def phase_small_zoo():
    """Phase 35, the small cut CPU against card: per configuration of
    :data:`ZOO_SMALL` the eval slice as phase 4 (every head's output within
    2e-3, the tags' too) and one training step on ``auto`` held to phase
    29's limits (labels exact, loss parts 1e-4, gradients against the CPU's
    float64 step); then the greedy grouping on the card's outputs against
    the CPU's."""
    for name, extra in ZOO_SMALL:
        label = f"small {name}" + (" NODE_STEPS 2" if extra else "")
        phase_small_slice("auto", zoo_cut(name, extra, True), f"{label} slice")
        phase_small_train("auto", zoo_cut(name, extra, False), f"{label} train",
                          f64_bound=True)
    phase_small_greedy()


def phase_small_greedy():
    """The greedy grouping (valid._greedy_grouping) of the narrow
    configuration's eval outputs, one scale, on two rendered images: the
    persons grouped from the card's outputs equal those from the CPU's
    (keypoints exactly, scores within 1e-5), and some form (the node head's
    last bias at 1, so that nodes pass the 0.5 seed score)."""
    from pemp_tpu_torch.config import small, zoo
    from pemp_tpu_torch.data.synthetic import eval_scenes
    from pemp_tpu_torch.tta.multi_scale import TTAPipeline
    from pemp_tpu_torch.valid import _greedy_grouping

    cfg = zoo("greedy", small())
    cfg.merge_from_other({"DATASET": {"INPUT_SIZE": 64, "OUTPUT_SIZE": [16, 32]}})
    images, _ = eval_scenes(np.random.RandomState(5), [(72, 96), (96, 80)])
    runs = {}
    for dev in ("cpu", "cuda"):
        model = tta_model(cfg, dev, torch.float32, 3)
        with torch.no_grad():
            model.mpn.node_classification[-1].bias.fill_(1.0)
        outs = TTAPipeline(model, cfg, with_decode=False).run_batched(images, batch_size=2)
        runs[dev] = [_greedy_grouping(o, cfg)[0] for o in outs]
    found = 0
    for c, g in zip(runs["cpu"], runs["cuda"]):
        if c.shape != g.shape or not np.array_equal(c[..., :2], g[..., :2]) or (
                len(c) and not np.abs(c[..., 2] - g[..., 2]).max() <= 1e-5):
            raise SystemExit(f"small greedy: card {g.shape[0]} persons, CPU {c.shape[0]}: the "
                             f"greedy grouping differs")
        found += len(c)
    if not found:
        raise SystemExit("small greedy: no person formed")
    log(f"small greedy: persons grouped from the card's outputs equal the CPU's ({found} on 2 "
        f"images)")


def phase_zoo_valid(card, rendered, dataset):
    """Phase 36: valid.evaluate at full width (model_58_4's w32/512, bf16,
    one scale) on phase 19's 8 images of 480x640, one batch (cut from 16,
    as phase 30, for the smoke's time limit), for ``tag`` (grouped by its
    tags on the host) and ``greedy`` (the greedy grouping on the host), as
    phase 20 (node threshold 0.5): each run's persons equal to the host
    grouping of the same outputs on the CPU (on the even images for tag,
    the odd for greedy), K1 10 times a batch. Returns the K1 count."""
    import tempfile

    from pemp_tpu_torch.config import zoo

    total = 0
    with tempfile.TemporaryDirectory() as tmp:
        eval_set = RenderedSet(tmp, *landscape(rendered, dataset))
        for i, name in enumerate(("tag", "greedy")):
            cfg = zoo(name)
            cfg.MODEL.MPN.NODE_THRESHOLD = 0.5   # the file's 1.0: no sigmoid passes it
            count, times, dt = drive_valid(f"valid {name}", cfg, eval_set, 1, card, tmp,
                                           half=i)
            total += count
            log(f"valid {name}: host grouping {times['cluster']:.3f} s of the staged run's "
                f"{dt:.3f} ({100 * times['cluster'] / dt:.1f} %)")
    return total


def zoo_train_entry(card, runs):
    """model_58_4 at full width (w32/512, batch 8, f32, ``auto``: pallas)
    through ``train()`` on 2 synthetic batches for 2 epochs (4 steps) for
    each config.ZOO name of ``runs`` ({name: K2, K2b and G1 launches a
    step, one number for all three or a dict}), the counts zeroed just
    before each run and read just after; losses finite, no step skipped;
    prints the device time a step (epoch 1, CUDA events around each step)
    and the peak memory. An MPN with an
    MPLayer starts from the seeded weights with calm_mplayer's message
    weights (TRAIN.CONTINUE with FINETUNE). Returns the launch counts and
    the batches."""
    import tempfile

    from pemp_tpu_torch.config import zoo
    from pemp_tpu_torch.config.defaults import plain_route
    from pemp_tpu_torch.data.synthetic import make_batch
    from pemp_tpu_torch.models.mpn.layers import MPLayer
    from pemp_tpu_torch.train.__main__ import train
    from pemp_tpu_torch.train.train_step import build_trainer

    rng = np.random.RandomState(23)
    base = zoo("tag")
    batches = [make_batch(rng, base.TRAIN.BATCH_SIZE, base.DATASET.INPUT_SIZE,
                          tuple(base.DATASET.OUTPUT_SIZE), 17, base.DATASET.MAX_NUM_PEOPLE)
               for _ in range(2)]
    total = {"K2": 0, "K2b": 0, "G1": 0}
    n = 2 * len(batches)
    with tempfile.TemporaryDirectory() as tmp:
        for name, a_step in runs.items():
            cfg = zoo(name)
            cfg.merge_from_other({"MODEL": {"PRETRAINED": ""}, "LOG_DIR": f"{tmp}/log",
                                  "PRINT_FREQ": 100})
            if plain_route(cfg) == "agnostic":
                model = build_trainer(cfg, device="cuda", seed=0).model
                if any(isinstance(m, MPLayer) for m in model.mpn.modules()):
                    calm_mplayer(model)
                    torch.save(model.state_dict(), f"{tmp}/calm.pt")
                    cfg.merge_from_other({"TRAIN": {"CONTINUE": f"{tmp}/calm.pt",
                                                    "FINETUNE": True}})
                del model
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            summary = train(cfg, batches, None, cfg.LOG_DIR, schedule_steps=2, epochs=2, seed=0)
            torch.cuda.synchronize()
            a_step = a_step if isinstance(a_step, dict) else dict.fromkeys(total, a_step)
            counts = read_counts(f"{name} train", {k: a_step[k] * n for k in total})
            losses = summary["losses"]
            if len(losses) != n or not np.isfinite(losses).all() or summary["fail_count"]:
                raise SystemExit(f"{name} train: losses {losses}, "
                                 f"{summary['fail_count']} skipped")
            timed = summary["epochs"][1]
            for k in total:
                total[k] += counts[k]
            log(f"{name} train: model_58_4 w32/512 batch {cfg.TRAIN.BATCH_SIZE} f32 "
                f"{cfg.MODEL.MPN.NAME} through train(), {n} steps on {card}: device time a "
                f"step {1e3 * timed['device_s'] / timed['steps']:.1f} ms (epoch 1, CUDA events "
                f"around each step), epoch 1 {timed['seconds']:.3f} s; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches K2 "
                f"{counts['K2']}, K2b {counts['K2b']}, G1 {counts['G1']} ({a_step} a "
                f"step); losses {[round(x, 4) for x in losses]}")
            torch.cuda.empty_cache()
    return total, batches


def phase_zoo_train(card):
    """Phase 37: model_58_4 at full width (w32/512, batch 8, f32, pallas)
    through ``train()`` on 2 synthetic batches for 2 epochs (4 steps) for
    ``tag``, ``background`` and ``group_based``, the counts zeroed just
    before each run and read just after (K2, K2b and G1 10 a step, 20 on
    group_based); losses finite, no step skipped; prints the device time a
    step and the peak memory. Then K2 and K2b against their plain versions
    on group_based's within-part and cross-part masks at MPN steps 0 and 9
    of one step, as phase 6 holds them. Returns the launch counts and K2's
    and K2b's errors."""
    from pemp_tpu_torch.config import zoo
    from pemp_tpu_torch.ops import typed_message
    from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer

    total, batches = zoo_train_entry(card, ZOO_TRAIN)
    errs = {"fwd": [], "bwd": []}
    cfg = zoo("group_based")
    cfg.MODEL.PRETRAINED = ""
    trainer = build_trainer(cfg, device="cuda", seed=0)
    # calls 2s and 2s + 1 are MPN step s's within-part and cross-part passes
    captured = capture_train_inputs(trainer, batch_to_torch(batches[0], "cuda"),
                                    "fused_typed_message_aggregate", steps=(0, 1, 18, 19))
    for call in (0, 1, 18, 19):
        args, g = captured[call]
        label = f"group_based train path step {call // 2} {('within', 'cross')[call % 2]}-part"
        numbers = check_k2(label, args[:6], g, args[6:], typed_message)
        for way in errs:
            errs[way].append(numbers[way][0])
    log(f"K2/K2b groups and blocks, group_based train path step 0 within-part: "
        f"{k2_group_stats(captured[0][0], captured[0][0][6:], typed_message._CHUNK)}")
    del trainer, captured, args, g
    torch.cuda.empty_cache()
    return total, errs


# the research zoo (phases 38-39): each small cut's MPN passes, so K1 at
# eval and K2 and G1 in training launch that often on the six on the
# flagship's layer (STEPS 3 at the small cut, plus EDGE_STEPS or
# NODE_STEPS), and K2b as often but on Simple and Simple2, whose last pass's
# nodes reach no head (their edge head reads the edges alone): no gradient
# reaches that pass's K2 output. None on the MPLayer models and VanillaMPN2.
ZOO_RESEARCH = {"simple": (5, 4), "simple2": (5, 4), "type_based": (3, 3),
                "type_constrained": (3, 3), "fp_constrained": (3, 3), "with_ref": (4, 4),
                "two_phase": (0, 0), "attention": (0, 0), "self_attention": (0, 0),
                "vanilla2": (0, 0)}
# K2, K2b and G1 a training step at full width (STEPS 10 + EDGE_STEPS 2 on
# simple, K2b one fewer; the other two run no kernel)
ZOO_RESEARCH_TRAIN = {"simple": {"K2": 12, "K2b": 11, "G1": 12}, "two_phase": 0,
                      "self_attention": 0}


def phase_small_zoo_research():
    """Phase 38: each cut of :data:`ZOO_RESEARCH`, CPU against card, as
    phase 35 (the eval slice, every head within 2e-3; one training step on
    ``auto`` against the CPU's float64 step), the counts zeroed just before
    and read just after each pair of runs (only the card's run launches).
    Returns the counts."""
    total = {"K1": 0, "K2": 0, "K2b": 0, "G1": 0}
    for name, (passes, backward) in ZOO_RESEARCH.items():
        zero_counts()
        phase_small_slice("auto", zoo_cut(name, {}, True), f"small {name} slice")
        total["K1"] += read_counts(f"small {name} slice", {"K1": passes})["K1"]
        zero_counts()
        phase_small_train("auto", zoo_cut(name, {}, False), f"small {name} train",
                          f64_bound=True)
        counts = read_counts(f"small {name} train",
                             {"K2": passes, "K2b": backward, "G1": passes})
        for k in ("K2", "K2b", "G1"):
            total[k] += counts[k]
    log(f"small zoo: launches {total} over {len(ZOO_RESEARCH)} cuts")
    return total


def phase_zoo_research(card, rendered, dataset):
    """Phase 39: ``simple`` through valid.evaluate as phase 36 (K1 12 times
    a batch), then simple, two_phase and self_attention through ``train()``
    (zoo_train_entry: K2 and G1 12 a step on simple, K2b 11, none on the
    others). Returns the launch counts."""
    import tempfile

    from pemp_tpu_torch.config import zoo

    with tempfile.TemporaryDirectory() as tmp:
        # phase 19's 8 images, one batch (cut from 16 for the time limit
        # when phases 40-41 came)
        eval_set = RenderedSet(tmp, *landscape(rendered, dataset))
        cfg = zoo("simple")
        cfg.MODEL.MPN.NODE_THRESHOLD = 0.5   # the file's 1.0: no sigmoid passes it
        steps = cfg.MODEL.MPN.STEPS + cfg.MODEL.MPN.EDGE_STEPS
        k1, times, dt = drive_valid("valid simple", cfg, eval_set, 1, card, tmp, k1=steps)
        log(f"valid simple: host clustering and its decode {times['cluster']:.3f} s of the "
            f"staged run's {dt:.3f} ({100 * times['cluster'] / dt:.1f} %)")
    counts, _ = zoo_train_entry(card, ZOO_RESEARCH_TRAIN)
    return {"K1": k1, **counts}


def run_child(cmd, timeout_s):
    """Runs ``cmd`` in its own session from the repo's root and returns its
    output; past ``timeout_s`` the whole session is killed and the phase
    fails, as it does on a non-zero exit."""
    import os
    import signal

    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SystemExit(f"{' '.join(cmd)}: killed after {timeout_s} s")
    if proc.returncode != 0:
        raise SystemExit(f"{' '.join(cmd)}: exit code {proc.returncode}\n{out[-4000:]}\n"
                         f"{err[-4000:]}")
    return out


def phase_dp_train_entry(card, single_ms):
    """Phase 40: the training entry point launched by torchrun, one process
    (a group of one under NCCL): model_58_4 at full width (w32/512, batch
    8, f32, pallas) on synthetic batches, 2 epochs of 2 steps. The child's
    last JSON line gives its device ms a step and gradient all-reduce ms a
    step (CUDA events, the second epoch), its peak memory and its kernels'
    launches since it started: K2, K2b and G1 10 a step, nothing else.
    Returns the launch counts."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = run_child([sys.executable, "-m", "torch.distributed.run", "--standalone",
                         "--nproc_per_node=1", "-m", "pemp_tpu_torch.train",
                         "hybrid_class_agnostic_end2end/model_58_4", "--synthetic",
                         "--epochs", "2", "--steps-per-epoch", "2", "--msg-pass", "pallas",
                         "MODEL.PRETRAINED", "", "LOG_DIR", f"{tmp}/log"], 300)
    dt = time.perf_counter() - t0
    lines = [line for line in out.splitlines() if line.startswith('{"train"')]
    if not lines:
        raise SystemExit(f"torchrun train: no summary line in\n{out[-4000:]}")
    got = json.loads(lines[-1])["train"]
    steps, per_step = got["steps"], 10
    want = {"K2": per_step * steps, "K2b": per_step * steps, "G1": per_step * steps}
    counts = got["launches"]
    bad = {k: (v, want.get(k, 0)) for k, v in counts.items() if v != want.get(k, 0)}
    if (bad or got["world"] != 1 or steps != 4 or got["skipped"]
            or not np.isfinite(got["losses"]).all()
            or not got["allreduce_ms_a_step"] > 0):
        raise SystemExit(f"torchrun train: launches (got, expected) {bad}, summary {got}")
    log(f"torchrun train (NCCL, world 1): model_58_4 w32/512 batch 8 f32 pallas, {steps} steps "
        f"on synthetic batches on {card}: device time a step {got['device_ms_a_step']:.1f} ms "
        f"(phase 23's single process in this call {single_ms:.1f} ms); the gradients' packing "
        f"into one buffer {got['pack_ms_a_step']:.3f} ms and its all-reduce "
        f"{got['allreduce_ms_a_step']:.3f} ms a step (CUDA events); peak "
        f"memory {got['peak_gib']:.2f} GiB; launches K2 {counts['K2']}, K2b {counts['K2b']}, G1 "
        f"{counts['G1']} (10 each a step); losses {[round(x, 4) for x in got['losses']]}; "
        f"the child ran {dt:.1f} s")
    for line in out.splitlines():
        if " done in " in line or " steps in " in line or "model params" in line:
            log(f"  torchrun train: {line}")
    return counts


def dp_rank_jobs(jobs):
    """What each rank of phase 41 runs: each (name, args) of ``jobs``."""
    return [{"train": dp_rank_train, "valid": dp_rank_valid}[name](*args) for name, args in jobs]


def dp_rank_train(cfg, state, batches):
    """A rank's small training steps on its rows of each global batch:
    the loss parts of each step, the first step's gradients (the sum over
    the ranks), the state after and the launches."""
    from pemp_tpu_torch.parallel import distributed
    from pemp_tpu_torch.ops import launch_counts
    from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer

    dev = torch.device("cuda", torch.cuda.current_device())
    trainer = build_trainer(cfg, device=dev, seed=0)
    trainer.model.load_state_dict(state)
    distributed.broadcast_state(trainer.model)
    zero_counts()
    records = []
    for i, batch in enumerate(batches):
        _, logging = trainer.step(batch_to_torch(distributed.shard_rows(batch), dev))
        records.append({"logging": {k: float(v) for k, v in logging.items()}})
        if i == 0:
            records[0]["grads"] = {k: p.grad.double().cpu()
                                   for k, p in trainer.model.named_parameters()
                                   if p.grad is not None}
    return {"records": records, "fail_count": trainer.fail_count, "counts": launch_counts(),
            "state": {k: v.cpu() for k, v in trainer.model.state_dict().items()}}


def dp_rank_valid(cfg, state, images, dataset, root):
    """A rank's share of valid.evaluate (rank 0 merges and scores); its
    result and its K1 launches."""
    import os

    from pemp_tpu_torch.models.pose_estimation import build_pose_model
    from pemp_tpu_torch.parallel import distributed
    from pemp_tpu_torch.ops import launch_counts
    from pemp_tpu_torch.valid import evaluate

    dev = torch.device("cuda", torch.cuda.current_device())
    model = build_pose_model(cfg, dtype=torch.bfloat16, device=dev, path="valid")
    model.load_state_dict(state)
    eval_set = RenderedSet(os.path.join(root, f"rank{distributed.rank()}"), images, dataset)
    zero_counts()
    stats = evaluate(cfg, model, eval_set, "eval.txt", batch_size=8)
    return {"stats": None if stats is None else [float(x) for x in stats],
            "K1": launch_counts()["K1"]}


def small_step_records(cfg, state, batches, device, dtype=torch.float32):
    """One process's steps on the global batches: each step's loss parts,
    the first step's gradients and the state after."""
    from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer

    trainer = build_trainer(cfg, device=device, seed=0)
    trainer.model.load_state_dict(state)
    records = []
    for i, batch in enumerate(batches):
        tbatch = batch_to_torch(batch, device)
        if dtype == torch.float64:
            trainer.model.double()
            trainer.model.dtype = dtype
            tbatch = {k: [x.double() for x in v] if isinstance(v, list) else
                      (v.double() if v.is_floating_point() else v) for k, v in tbatch.items()}
        _, logging = trainer.step(tbatch)
        records.append({"logging": {k: float(v) for k, v in logging.items()}})
        if i == 0:
            records[0]["grads"] = {k: p.grad.double().cpu()
                                   for k, p in trainer.model.named_parameters()
                                   if p.grad is not None}
    return records


def phase_dp_two_ranks(card, rendered, dataset):
    """Phase 41: two ranks on the one card under gloo (NCCL refuses two
    ranks on one GPU), spawned fresh, against one process on the card. The
    small cut (global batch 4, two rows a rank, pallas: K2, K2b and G1 3 a
    step on each rank) for 2 steps: each step's loss parts within 1e-4 of
    the single process's (of max(1, their size)), the first step's
    gradients within phase 29's limits of them (5e-3 of each tensor's
    largest; where a tensor passes it, held to the CPU's float64 step
    within 1.5 times the single card process's own error against it, never
    past F64_CAP), no step skipped, the ranks' parameters bit-identical
    after the steps. Then valid.evaluate (model_58_4, w32/512, bf16, one
    scale, GAEC at node threshold 0.5) on phase 19's 8 images: each rank
    its 4, one batch of 4 (K1 10), rank 0's merged results equal to those
    of one process that runs the same two batches of 4, rank 1 returns
    None, no part file left. Returns the counts launched by the ranks."""
    import os
    import tempfile

    from pemp_tpu_torch.config import small_train, w32_512_train
    from pemp_tpu_torch.data.synthetic import make_batch
    from pemp_tpu_torch.parallel.distributed import run_ranks
    from pemp_tpu_torch.parallel.eval_shard import shard_indices
    from pemp_tpu_torch.train.train_step import build_trainer
    from pemp_tpu_torch.valid import evaluate

    t0 = time.perf_counter()
    cfg = small_train()
    cfg.TRAIN.BATCH_SIZE = 4
    rng = np.random.RandomState(21)
    batches = [make_batch(rng, 4, 64, (16, 32), 17, 30, scale_range=(0.4, 0.9))
               for _ in range(2)]
    state = {k: v.clone() for k, v in build_trainer(cfg, device="cpu", seed=3)
             .model.state_dict().items()}
    single = small_step_records(cfg, state, batches, "cuda")

    vcfg = w32_512_train()
    vcfg.MODEL.MPN.NODE_THRESHOLD = 0.5    # the file's 1.0: no sigmoid score passes it
    images, subset = landscape(rendered, dataset)
    model = full_width_model(vcfg, images)
    vstate = {k: v.cpu() for k, v in model.state_dict().items()}
    # the one process takes the ranks' batches, rank 0's 4 images then rank
    # 1's, so that only the sharding and the merge differ: the bf16 outputs,
    # and GAEC's persons on them, change with the batch
    order = [i for r in range(2) for i in shard_indices(len(images), 2, r)]
    ordered = {**subset, "images": [subset["images"][i] for i in order]}
    with tempfile.TemporaryDirectory() as tmp:
        vcfg.LOG_DIR = f"{tmp}/one"
        one = evaluate(vcfg, model, RenderedSet(f"{tmp}/set", [images[i] for i in order],
                                                ordered), "eval.txt", batch_size=4)
        del model
        torch.cuda.empty_cache()
        pair_cfg = vcfg.clone()
        pair_cfg.LOG_DIR = f"{tmp}/two"
        t1 = time.perf_counter()
        ranks = run_ranks(dp_rank_jobs, 2, f"{tmp}/ranks",
                          [("train", (cfg, state, batches)),
                           ("valid", (pair_cfg, vstate, images, subset, f"{tmp}/sets"))],
                          device="cuda:0", backend="gloo", deadline_s=240.0)
        ranks_s = time.perf_counter() - t1
        split = vcfg.TEST.SPLIT
        results = {}
        for side in ("one", "two"):
            with open(f"{tmp}/{side}/person_keypoints_{split}_mpn_results.json") as f:
                results[side] = sorted(json.load(f), key=lambda a: (a["image_id"], -a["score"]))
        files = {side: sorted(os.listdir(f"{tmp}/{side}")) for side in ("one", "two")}

    # training: the ranks against the single process
    (a, va), (b, vb) = ranks
    worst = (0.0, None)
    for step, (rec, ref) in enumerate(zip(a["records"], single)):
        for k, v in ref["logging"].items():
            err = abs(rec["logging"][k] - v) / max(1.0, abs(v))
            if not err <= 1e-4:
                raise SystemExit(f"two ranks: step {step} loss part {k} {rec['logging'][k]} "
                                 f"against one process's {v}")
    got, ref = a["records"][0]["grads"], single[0]["grads"]
    if set(got) != set(ref):
        raise SystemExit("two ranks: different parameters have gradients")

    def rel(g, r, k):
        return ((g[k] - r[k]).abs().max() / r[k].abs().max().clamp(min=1e-30)).item()

    loose = {k: rel(got, ref, k) for k in ref if rel(got, ref, k) > 5e-3}
    if loose:
        f64 = small_step_records(cfg, state, batches[:1], "cpu", torch.float64)[0]["grads"]
        for k in loose:
            tol = min(F64_CAP, max(5e-3, 1.5 * rel(ref, f64, k)))
            if not rel(got, f64, k) <= tol:
                raise SystemExit(f"two ranks: gradient {k} {rel(got, f64, k):.3e} of the "
                                 f"float64 step's largest (allowed {tol:.3e})")
        log(f"two ranks: gradients past 5e-3 of the single process's, held to float64: "
            f"{ {k: round(v, 6) for k, v in loose.items()} }")
    worst = max((rel(got, ref, k), k) for k in ref)
    same = all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
    want = {"K2": 6, "K2b": 6, "G1": 6}
    for r, res in enumerate((a, b)):
        bad = {k: (v, want.get(k, 0)) for k, v in res["counts"].items() if v != want.get(k, 0)}
        if bad or res["fail_count"]:
            raise SystemExit(f"two ranks: rank {r} launches (got, expected) {bad}, "
                             f"{res['fail_count']} skipped steps")
    if not same:
        raise SystemExit("two ranks: the ranks' parameters differ after 2 steps")

    # valid: rank 0's merged results against the single process's
    if vb["stats"] is not None or va["stats"] is None or va["K1"] != 10 or vb["K1"] != 10:
        raise SystemExit(f"two ranks valid: rank results {va['stats'] is not None}, "
                         f"{vb['stats'] is not None}; K1 {va['K1']}, {vb['K1']}")
    if files["one"] != files["two"] or len(results["one"]) != len(results["two"]) or not (
            results["one"]):
        raise SystemExit(f"two ranks valid: files {files}, persons {len(results['one'])} "
                         f"and {len(results['two'])}")
    kp_err = max(np.abs(np.array(x["keypoints"]) - np.array(y["keypoints"])).max()
                 for x, y in zip(results["one"], results["two"]))
    ids_same = [x["image_id"] for x in results["one"]] == [x["image_id"] for x in results["two"]]
    if not (ids_same and kp_err <= 2e-3 and np.allclose(va["stats"], one, rtol=0, atol=1e-6)):
        raise SystemExit(f"two ranks valid: image ids equal {ids_same}, keypoints within "
                         f"{kp_err:.3e}, stats {va['stats']} against {list(one)}")
    log(f"two ranks on one card (gloo): small cut, 2 steps on a global batch of 4: loss parts "
        f"within 1e-4 of one process's, first-step gradients within {worst[0]:.3e} of its "
        f"largest ({worst[1]}), parameters bit-identical across ranks {same}; launches a rank "
        f"K2 {a['counts']['K2']}, K2b {a['counts']['K2b']}, G1 {a['counts']['G1']}; valid "
        f"model_58_4 GAEC on 8 images: {len(results['two'])} persons merged on rank 0 equal "
        f"to one process's (keypoints within {kp_err:.3e}), K1 10 a rank, no part file "
        f"left; the ranks ran {ranks_s:.1f} s, the phase {time.perf_counter() - t0:.1f} s on "
        f"{card}")
    return {"K1": va["K1"] + vb["K1"], "K2": a["counts"]["K2"] + b["counts"]["K2"],
            "K2b": a["counts"]["K2b"] + b["counts"]["K2b"],
            "G1": a["counts"]["G1"] + b["counts"]["G1"]}


def phase_overfit(card):
    """Phase 42: the overfit tool at full width (model_58_4's preset: w32/512,
    batch 8, f32, pallas) on its fixed batch, 30 iterations printing every
    10. The last loss must be below the first and all finite; K2, K2b and
    G1 launch 10 times a step, K2 10 more an eval pass, nothing else.
    Returns the counts."""
    from pemp_tpu_torch import overfit
    from pemp_tpu_torch.config import w32_512_train

    cfg = w32_512_train()
    iters, freq = 30, 10
    t0 = time.perf_counter()
    batch = overfit.overfit_batch(cfg)
    log(f"overfit: the fixed batch of {cfg.TRAIN.BATCH_SIZE} made in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    rows = overfit.overfit(cfg, batch, "cuda", iters, freq)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps, passes = cfg.MODEL.MPN.STEPS, len(rows)
    counts = read_counts("overfit", {"K2": steps * (iters + passes), "K2b": steps * iters,
                                     "G1": steps * iters})
    losses = [r["loss"] for r in rows]
    if [r["iter"] for r in rows] != [0, 10, 20, 29] or not np.isfinite(losses).all() \
            or not losses[-1] < losses[0]:
        raise SystemExit(f"overfit: printed iterations {[r['iter'] for r in rows]}, "
                         f"losses {losses}")
    # steady state: from the row of iteration 10 to the last, two eval
    # passes included
    steady = (1e3 * (rows[-1]["seconds"] - rows[1]["seconds"])
              / (rows[-1]["iter"] - rows[1]["iter"]))
    log(f"overfit: model_58_4 w32/512 batch {cfg.TRAIN.BATCH_SIZE} f32 pallas, {iters} "
        f"iterations and {passes} eval passes in {dt:.3f} s, {1e3 * dt / iters:.1f} ms an "
        f"iteration with the first, {steady:.1f} from iteration 10 on (eval passes "
        f"included) on {card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in counts.items() if v} }; losses {[round(x, 4) for x in losses]}")
    return counts


def phase_overfit_learns():
    """Phase 43: tests/test_overfit.py's learning check on the card, at its
    cut of model_58_4 (config.overfit_cut(): a one-stack Hourglass at
    64x64, 3 MPN steps, K = 6, the greedy matcher) and on its batch (seed 7,
    2 images of 2 large persons): every 25 steps the training forward's
    edge and node precision and recall and the class accuracy on the true
    nodes; all must reach 0.9 within 400 steps. K2, K2b and G1 launch once a
    pass, nothing else. Returns (the counts, the step that reached it)."""
    from pemp_tpu_torch.config import overfit_cut
    from pemp_tpu_torch.data.synthetic import make_batch
    from pemp_tpu_torch.overfit import eval_metrics
    from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer

    cfg = overfit_cut()
    batch = batch_to_torch(make_batch(np.random.RandomState(7), batch_size=2, input_size=64,
                                      output_sizes=(16, 16), n_people=2,
                                      scale_range=(0.55, 0.8)), "cuda")
    trainer = build_trainer(cfg, "cuda", steps_per_epoch=10**6)
    host = lambda t: t.detach().float().cpu().numpy()  # noqa: E731

    def metrics(out):
        em, nm = eval_metrics(out)
        # class accuracy on the true nodes (tests/test_overfit.py:84-92)
        labels = out["labels"]
        pos = (host(out["masks"]["node"]) == 1.0) & (host(labels["node"]) == 1.0)
        cls = host(out["preds"]["class"][-1]).argmax(-1)
        acc = float(np.mean(cls[pos] == host(labels["class"])[pos])) if pos.any() else 0.0
        return (em.get("prec", 0.0), em.get("rec", 0.0), nm.get("prec", 0.0),
                nm.get("rec", 0.0), acc)

    zero_counts()
    t0 = time.perf_counter()
    trainer.step(batch)
    out = trainer.last_output
    edge_pos = int(((host(out["labels"]["edge"][-1]) == 1.0)
                    & (host(out["masks"]["edge"][-1]) == 1.0)).sum())
    node_pos = int(((host(out["labels"]["node"]) == 1.0)
                    & (host(out["masks"]["node"]) == 1.0)).sum())
    if edge_pos < 10 or node_pos < 10:
        raise SystemExit(f"overfit learns: too few positives, edges {edge_pos} nodes {node_pos}")
    history, reached = [], None
    for i in range(1, 401):
        loss, _ = trainer.step(batch)
        if i % 25 == 0:
            vals = metrics(trainer.last_output)
            history.append((i, round(float(loss), 4), *[round(v, 3) for v in vals]))
            if all(v >= 0.9 for v in vals):
                reached = i
                break
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = cfg.MODEL.MPN.STEPS * (len(history) * 25 + 1)
    counts = read_counts("overfit learns", {"K2": steps, "K2b": steps, "G1": steps})
    if reached is None or trainer.fail_count:
        raise SystemExit(f"overfit learns: no 0.9 within 400 steps ({trainer.fail_count} "
                         f"skipped); (step, loss, e_prec, e_rec, n_prec, n_rec, cls_acc) "
                         f"{history}")
    log(f"overfit learns: edge and node precision and recall and class accuracy reached 0.9 "
        f"at step {reached} in {dt:.1f} s (positives: edges {edge_pos}, nodes {node_pos}); "
        f"(step, loss, e_prec, e_rec, n_prec, n_rec, cls_acc) {history}")
    return counts, reached


def published_backbone(model, seed):
    """A HigherHRNet state_dict in the published key layout (the
    reference's names, which the port's backbone carries) with seeded
    weights of the sizes init_random_weights draws, and BatchNorm
    statistics drawn around identity."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.backbone.state_dict().items():
        if not v.is_floating_point():
            out[k] = v.cpu()
        elif k.endswith("running_var") or (v.dim() == 1 and k.endswith("weight")):
            out[k] = 0.9 + 0.2 * torch.rand(v.shape, generator=gen)
        elif v.dim() == 1:
            out[k] = 0.02 * (torch.rand(v.shape, generator=gen) - 0.5)
        else:
            out[k] = torch.randn(v.shape, generator=gen) / v[0].numel() ** 0.5
    return out


SCHEME_PREFIX = {"plain": "", "strip1": "module.", "strip2": "model.module.",
                 "strip_prefix2char": "1."}


def phase_convert(card):
    """Phase 44: the checkpoint converter at w48/640. A seeded backbone
    saved as a published-layout .pth under each rename scheme, and once in
    mmpose's names; each converted checkpoint's backbone must equal it bit
    for bit. Then the main path (bf16, batch 8) takes the converted weights
    through load_params_only and runs one forward: K1 10 times, nothing
    else, finite outputs. Returns the counts."""
    import os
    import tempfile

    from pemp_tpu_torch.config import w48_640
    from pemp_tpu_torch.convert_checkpoint import convert
    from pemp_tpu_torch.pipeline import build_pipeline
    from pemp_tpu_torch.train.checkpoint import load_params_only

    cfg = w48_640()
    pipe = build_pipeline(8, 640, dtype=torch.bfloat16, device="cuda", seed=0)
    published = published_backbone(pipe.model, 44)
    heads = ("final_layers.", "deconv_layers.")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pth, out = os.path.join(tmp, "published.pth"), os.path.join(tmp, "converted.ckpt")
        for scheme, mmpose in [(s, False) for s in SCHEME_PREFIX] + [("plain", True)]:
            sd = published
            if mmpose:
                sd = {("keypoint_head." if k.startswith(heads) else "backbone.") + k: v
                      for k, v in sd.items()}
            torch.save({"state_dict": {SCHEME_PREFIX[scheme] + k: v for k, v in sd.items()}},
                       pth)
            convert(cfg, pth, out, scheme, mmpose, "cuda")
            got = torch.load(out, map_location="cpu", weights_only=True)["model_state_dict"]
            bad = [k for k, v in published.items() if not torch.equal(got[f"backbone.{k}"], v)]
            if bad or got.keys() != pipe.model.state_dict().keys():
                raise SystemExit(f"convert {scheme} mmpose={mmpose}: {len(bad)} backbone "
                                 f"tensors differ ({bad[:4]})")
        load_params_only(out, pipe.model)
    convert_s = time.perf_counter() - t0
    images = torch.rand(8, 640, 640, 3, generator=torch.Generator().manual_seed(44)).cuda()
    torch.cuda.synchronize()
    zero_counts()
    persons, valid, scoremaps, output = pipe.forward(images)
    torch.cuda.synchronize()
    counts = read_counts("convert forward", {"K1": cfg.MODEL.MPN.STEPS})
    for name, t in (("scoremaps", scoremaps), ("edge logits", output["preds"]["edge"][-1]),
                    ("node logits", output["preds"]["node"][-1])):
        if not bool(torch.isfinite(t.float()).all()):
            raise SystemExit(f"convert forward: non-finite {name}")
    bb = pipe.model.backbone.state_dict()
    if not all(torch.equal(bb[k].float().cpu(), v.to(bb[k].dtype).float())
               for k, v in published.items()):
        raise SystemExit("convert forward: the model's backbone is not the converted one")
    params = sum(p.numel() for p in pipe.model.backbone.parameters())
    log(f"convert: w48/640 backbone ({params / 1e6:.1f}M params) through 4 rename schemes "
        f"and mmpose's names, bit for bit, in {convert_s:.1f} s; the main path's forward on "
        f"the converted weights: launches { {k: v for k, v in counts.items() if v} }, "
        f"persons {int(valid.sum())} on {card}")
    return counts


def png_size(path):
    """(height, width) of an 8-bit RGB PNG of one IDAT stream (utils.vis's),
    checked by decompressing its rows (the card's machine has no PIL)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise SystemExit(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        chunks[tag] = chunks.get(tag, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    raw = zlib.decompress(chunks[b"IDAT"])
    if depth != 8 or colour != 2 or len(raw) != h * (1 + 3 * w) or b"IEND" not in chunks:
        raise SystemExit(f"{path}: {w}x{h} depth {depth} colour {colour}, {len(raw)} bytes")
    return h, w


def phase_draw(card, rendered, dataset):
    """Phase 45: the drawing tool with --detail at w48/640 (bf16, one
    scale, the weights of phase 19's full_width_model so that persons form)
    on the 8 rendered images of 480x640, one a call: K1 10 times an image,
    nothing else; 8 PNGs an image, each of the image's size (the poses) or
    the pipeline's canvas (the rest). Returns the counts."""
    import os
    import tempfile

    from pemp_tpu_torch.config import w48_640
    from pemp_tpu_torch.draw_images import draw

    cfg = w48_640()
    model = full_width_model(cfg, rendered)
    with tempfile.TemporaryDirectory() as tmp:
        eval_set = RenderedSet(tmp, rendered, dataset)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        written = draw(cfg, model, eval_set, os.path.join(tmp, "draws"), len(rendered), True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts("draw", {"K1": cfg.MODEL.MPN.STEPS * len(rendered)})
        sizes = {os.path.basename(p): png_size(p) for p in written}
    if len(sizes) != 8 * len(rendered) or any(
            sizes[f"{r['id']}_poses.png"] != (r["height"], r["width"])
            for r in dataset["images"]):
        raise SystemExit(f"draw: {len(sizes)} files, sizes {sorted(set(sizes.values()))}")
    log(f"draw: w48/640 --detail on {len(rendered)} images of 480x640, one a call, in "
        f"{dt:.1f} s on {card}; {len(sizes)} PNGs, sizes {sorted(set(sizes.values()))}; "
        f"launches { {k: v for k, v in counts.items() if v} }")
    return counts


def phase_graph_tools(card, rendered, dataset):
    """Phase 46: comp_graph_stats (model_58_4's sizes, the training
    augmentation on the rendered val set) on the card and, on 2 images,
    the same lines on the CPU; measure_deviations at input 512 on the same
    images, four rows, the labels grouping most persons (AP above 0.5 at
    the shipped capacity). No kernel launches."""
    import tempfile

    from pemp_tpu_torch import comp_graph_stats, measure_deviations
    from pemp_tpu_torch.config import w32_512_train
    from pemp_tpu_torch.data.datasets import CocoKeypoints

    arrays = {r["id"]: image for r, image in zip(dataset["images"], rendered)}

    class Arrays(CocoKeypoints):
        def load_raw(self, idx):
            img_id = int(self.img_ids[idx])
            return (img_id, self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id)),
                    self.coco.loadImgs(img_id)[0], arrays[img_id])

    with tempfile.TemporaryDirectory() as tmp:
        eval_set = RenderedSet(tmp, rendered, dataset)
        cfg = w32_512_train()
        cfg.DATASET.ROOT = tmp
        zero_counts()
        t0 = time.perf_counter()
        lines = comp_graph_stats.report(comp_graph_stats.graph_stats(
            cfg, comp_graph_stats.stats_set(cfg, Arrays), len(rendered), "cuda"))
        stats_s = time.perf_counter() - t0
        card_two = comp_graph_stats.report(comp_graph_stats.graph_stats(
            cfg, comp_graph_stats.stats_set(cfg, Arrays), 2, "cuda"))
        cpu_two = comp_graph_stats.report(comp_graph_stats.graph_stats(
            cfg, comp_graph_stats.stats_set(cfg, Arrays), 2, "cpu"))
        if card_two != cpu_two or lines[1].startswith("detections/img: mean=0.00"):
            raise SystemExit(f"comp_graph_stats: card {card_two} against CPU {cpu_two}")
        config = measure_deviations.deviation_config(tmp, 512)
        config.LOG_DIR = tmp
        t0 = time.perf_counter()
        rows = measure_deviations.measure(config, eval_set, None, "cuda")
        deviations_s = time.perf_counter() - t0
        read_counts("graph tools", {})
    if len(rows) != 4 or not rows[0]["AP"] > 0.5:
        raise SystemExit(f"measure_deviations: rows {rows}")
    log(f"graph tools: comp_graph_stats on {len(rendered)} images in {stats_s:.1f} s, the "
        f"first 2 equal on the CPU; measure_deviations at input 512 in {deviations_s:.1f} s "
        f"on {card}: {rows}")


# Phases 47-49: training on the fused step. K1's differentiable inputs by
# position, and the names of their gradients
K1_FLOATS = (0, 1, 2, 3, 4, 8, 9, 10, 11, 12)
K1_GRADS = ("dp", "dh_node", "dq", "dcur", "da", "dw_cur", "dw_e1", "db_e1", "dwe", "dw_attn")


def k1b_bound_ms(args, g_ne, g_agg):
    """Least time for K1b's work on these inputs: q, cur, ne and the
    cotangents it takes (ne's, K2b's d_ef) read once, p, h_node, the source
    column and the weights once, dq, dcur, dh_node and the weight gradients
    written once, at the memory rate, against its five 64x64 products a
    slot (every slot: the edge MLP runs on the invalid ones too) at the f32
    rate; the larger."""
    p, h_node, q, cur, src, w_cur, w_e1 = (args[i] for i in (0, 1, 2, 3, 5, 8, 9))
    e, w = cur.shape
    rows = 3 + (g_ne is not None) + (g_agg is not None)      # q, cur, ne, cotangents
    nbytes = 4 * (rows * e * w + 2 * p.numel() + src.numel() + 2 * w_cur.numel()
                  + 2 * e * w + h_node.numel() + 2 * w_e1.numel() + w)
    flops = e * 5 * 2 * w * w
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def check_k1_backward(label, args, dims, cotangents):
    """Phase 47 on one set of inputs: K1's autograd Function on the card
    (forward K1's f32 form; backward K2b, K1b, G1) against autograd through
    the plain version, TF32 off, on the same inputs and cotangents (None
    where an output reaches no loss): each of the ten gradients within 1e-4
    of its own largest value, a second backward with the same bits; K1b's
    outputs against its plain factored form on the same inputs. Times K1b,
    its plain form, the K1 f32 forward and the whole backward (K2b + K1b +
    G1, on a kept graph) against the plain autograd's, each with its bound.
    Returns (K1b's max abs error, ms, plain ms, bound, bound by)."""
    import functools

    from pemp_tpu_torch.ops import fused_step, gather_mm, typed_message

    n, t, n_img = dims
    g_out, g_ne = cotangents
    plan = gather_mm.gather_plan(args[5], n_img, n)
    step = functools.partial(fused_step.fused_mpn_step, plan=plan)

    def run(fn):
        leaves = [x.clone().requires_grad_() if i in K1_FLOATS else x
                  for i, x in enumerate(args)]
        outs = fn(*leaves, *dims)
        pairs = [(o, g) for o, g in zip(outs, cotangents) if g is not None]
        floats = [leaves[i] for i in K1_FLOATS]

        def backward():
            return torch.autograd.grad([o for o, _ in pairs], floats, [g for _, g in pairs],
                                       retain_graph=True, allow_unused=True)
        return outs, backward

    got_outs, got_backward = run(step)
    got, again = got_backward(), got_backward()
    want_outs, want_backward = run(fused_step.fused_mpn_step_plain)
    want = want_backward()
    torch.cuda.synchronize()
    parts = []
    for name, x, x2, y in zip(K1_GRADS, got, again, want):
        if y is None:
            if x is not None:
                raise SystemExit(f"K1 backward {label}: {name} has a gradient where the plain "
                                 f"version has none")
            parts.append(f"{name} none")
            continue
        if not torch.equal(x, x2):
            raise SystemExit(f"K1 backward {label}: a second backward gives other bits ({name})")
        err, scale = (x - y).abs().max().item(), y.abs().max().item()
        # the ReLU decisions: elements of dq that are zero on one side only
        flips = int(((x == 0) != (y == 0)).sum()) if name == "dq" else 0
        if not (np.isfinite(err) and err <= 1e-4 * scale):
            raise SystemExit(f"K1 backward {label}: {name} max abs error {err} exceeds 1e-4 of "
                             f"its max |plain| {scale} (dq zero on one side only at "
                             f"{flips} elements)")
        parts.append(f"{name} {err:.3e} of max {scale:.3e}")
    ne_bits = torch.equal(got_outs[1], want_outs[1])
    flips = int(((got[2] == 0) != (want[2] == 0)).sum())

    # K1b alone against its plain factored form, on K1's ne and K2b's d_ef
    p, h_node, q, cur, a, src, types, valid, w_cur, w_e1, _, we, w_attn = args
    ne = got_outs[1].detach()
    g_agg = None
    if g_out is not None:
        g_agg = typed_message._launch_backward(ne, a, types, valid, we, w_attn, g_out, n, t)[0]
    k1b_args = (p, h_node, q, cur, src, w_cur, w_e1, ne, g_ne, g_agg, n, n_img)
    k1b = fused_step._launch_backward(*k1b_args)
    k1b_plain = fused_step.fused_step_bwd_plain(*k1b_args)
    k1b_err = max((x - y).abs().max().item() for x, y in zip(k1b, k1b_plain))
    k1b_rel = max(((x - y).abs().max() / y.abs().max()).item() for x, y in zip(k1b, k1b_plain))
    if not k1b_rel <= 1e-4:
        raise SystemExit(f"K1b {label}: an output differs from its plain factored form by "
                         f"{k1b_rel:.3e} of its largest")
    ms = median_ms(lambda: fused_step._launch_backward(*k1b_args))
    plain_ms = median_ms(lambda: fused_step.fused_step_bwd_plain(*k1b_args))
    bound, bound_by, nbytes, flops = k1b_bound_ms(args, g_ne, g_agg)
    k1_ms = median_ms(lambda: fused_step.fused_mpn_step(*args, *dims))
    k1_plain_ms = median_ms(lambda: fused_step.fused_mpn_step_plain(*args, *dims))
    k1_bound, k1_by, _, _ = k1_bound_ms(args)
    bwd_ms = median_ms(got_backward)
    bwd_plain_ms = median_ms(want_backward)
    bwd_bound = bound + g1_bound_ms(k1b[0], plan, n)[0]
    if g_out is not None:
        bwd_bound += k2_bound_ms((ne, a, types, valid, we, w_attn), True)[0]
    log(f"K1 backward {label}: gradients against autograd through the plain version "
        f"(tol 1e-4 of each max): {'; '.join(parts)}; second backward bit-identical; K1's ne "
        f"bit-identical to the plain forward's {ne_bits}; dq zero on one side only at "
        f"{flips} of {got[2].numel()} elements; valid slots {int(valid.sum())}/{valid.numel()}")
    log(f"K1b {label}: max abs err {k1b_err:.3e} ({k1b_rel:.3e} of the largest) against its "
        f"plain form; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f} by "
        f"{bound_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); K1 f32 forward "
        f"kernel_ms={k1_ms:.4f} plain_ms={k1_plain_ms:.4f} bound_ms={k1_bound:.4f} by {k1_by}; "
        f"whole backward (K2b + K1b + G1) {bwd_ms:.4f} ms against the plain autograd's "
        f"{bwd_plain_ms:.4f} ms (the three bounds' sum {bwd_bound:.4f})")
    if all(g is not None for g in cotangents):
        parts, rest = launch_ms(step, args, K1_FLOATS, cotangents, dims,
                                {"K1b reduce": "fused_step_bwd_reduce", "K1b": "fused_step_bwd",
                                 "K1": "fused_step_f32_kernel",
                                 "K2b reduce": "typed_message_bwd_reduce",
                                 "K2b": "typed_message_bwd", "G1": "gather_rows"})
        if not all(parts[k] > 0 for k in ("K1", "K1b", "K1b reduce", "K2b", "G1")):
            raise SystemExit(f"K1 backward launches: the profiler saw no device time ({parts})")
        log(f"K1 forward and backward launches, {label} (torch.profiler, device ms per call): "
            + "; ".join(f"{k} {v:.4f}" for k, v in parts.items() if k != "rest")
            + f"; rest {parts['rest']:.4f} ({'; '.join(rest)})")
    return k1b_err, ms, plain_ms, bound, bound_by


def phase_k1_backward(batch):
    """Phase 47: K1's autograd Function against autograd through the plain
    version (check_k1_backward) on seeded random f32 inputs at the model_58_4
    training shapes (B = 8: N = 5440, C = 80, T = 17), at a ragged shape
    (C = 77, T = 14, 85 nodes an image) and on the inputs and cotangents
    the fused_step model_58_4 training path feeds at MPN steps 0 and 9.
    Returns K1b's numbers at step 0 and the largest error."""
    from pemp_tpu_torch.config import w32_512_train
    from pemp_tpu_torch.train.train_step import build_trainer

    args, dims = random_k1_inputs(torch.float32, seed=21)
    rng = np.random.RandomState(22)
    n, t, _ = dims
    cot = (torch.from_numpy(rng.randn(n, t, 64).astype(np.float32)).cuda(),
           torch.from_numpy(rng.randn(args[3].shape[0], 64).astype(np.float32)).cuda())
    errs = [check_k1_backward("random f32", args, dims, cot)[0]]
    del args, cot
    # ragged: C = 77 is no multiple of 16, T = 14, and 85 nodes an image
    # fill no whole number of K1's 3-node tiles
    args, dims = random_k1_inputs(torch.float32, seed=23, j=17, k=5, c=77, t=14)
    n, t, _ = dims
    cot = (torch.from_numpy(rng.randn(n, t, 64).astype(np.float32)).cuda(),
           torch.from_numpy(rng.randn(args[3].shape[0], 64).astype(np.float32)).cuda())
    errs.append(check_k1_backward("ragged f32 (C 77, T 14, 85 nodes per image)", args, dims,
                                  cot)[0])
    del args, cot
    cfg = w32_512_train()
    cfg.TPU.MSG_PASS = "fused_step"
    trainer = build_trainer(cfg, device="cuda", seed=0)
    captured = capture_train_inputs(trainer, batch, "fused_mpn_step")
    numbers = None
    for step in (0, 9):
        args, cot = captured[step]
        got = check_k1_backward(f"fused_step train path step {step}", args[:13], args[13:],
                                tuple(cot))
        errs.append(got[0])
        numbers = numbers or got
    del captured, trainer
    torch.cuda.empty_cache()
    return numbers, max(errs)


def phase_small_fused_train():
    """Phase 48: small training steps on ``fused_step``, CPU against card, as
    phase 7 (small_train()) and as phase 38 (the ``simple`` zoo cut, whose
    last pass reaches no head, against the CPU's float64 step); the counts
    zeroed just before each and read just after: K1, K1b and G1 once a pass,
    K2b once a pass whose out reaches a loss. Returns the counts."""
    from pemp_tpu_torch.config import small_train

    total = {"K1": 0, "K2b": 0, "K1b": 0, "G1": 0}
    runs = (("small train", small_train(), False, small_train().MODEL.MPN.STEPS, 0),
            ("small simple train", zoo_cut("simple", {}, False), True,
             *ZOO_RESEARCH["simple"]))
    for name, cfg, f64, passes, backward in runs:
        backward = backward or passes
        zero_counts()
        phase_small_train("fused_step", cfg, name, f64_bound=f64)
        counts = read_counts(f"{name} fused_step",
                             {"K1": passes, "K2b": backward, "K1b": passes, "G1": passes})
        for k in total:
            total[k] += counts[k]
    return total


def phase_fused_train(card, batches, pallas_ms):
    """Phase 49: model_58_4 training at full width on ``fused_step``, as
    phase 8 (w32/512, batch 8, f32, the same synthetic batches: one warm-up
    and 3 timed steps): K1, K2b, K1b and G1 10 times each a step, K2 never;
    prints the device time a step beside phase 8's on pallas in this call.
    Returns the counts."""
    from pemp_tpu_torch.config import w32_512_train
    from pemp_tpu_torch.train.train_step import build_trainer

    cfg = w32_512_train()
    cfg.TPU.MSG_PASS = "fused_step"
    steps = cfg.MODEL.MPN.STEPS
    trainer = build_trainer(cfg, device="cuda", seed=0)
    counts = drive_train("fused_step training", trainer, batches,
                         {"K1": steps, "K2b": steps, "K1b": steps, "G1": steps}, card)
    log(f"fused_step training: device time a step {counts['device_ms']:.1f} ms against "
        f"{pallas_ms:.1f} ms on pallas (phase 8, this call)")
    del trainer
    torch.cuda.empty_cache()
    return counts


# Phases 50-51: the JAX package's MPN and graph variants (config.VARIANTS;
# VARIANT_CUTS on the small cut only). The kernels a card run launches once
# an MPN pass, by the form config.layer_route gives the variant on the
# run's route (eval, training): K4 and K4b only for an attention
FORM_LAUNCHES = {
    False: {"fused_step": {"K1": 1}, "pallas": {"K2": 1}, "hybrid": {"K3": 1},
            "einsum": {"K4": 1}, "dots": {"K4": 1}},
    True: {"fused_step": {"K1": 1, "K2b": 1, "K1b": 1, "G1": 1},
           "pallas": {"K2": 1, "K2b": 1, "G1": 1}, "hybrid": {"K3": 1, "K3b": 1, "G1": 1},
           "einsum": {"K4": 1, "K4b": 1, "G1": 2}, "dots": {"K4": 1, "K4b": 1, "G1": 3}},
}
# phase 50: each variant's (eval routes, training routes) on the small cut
VARIANT_SMALL = {
    "edge_mlp_per_type": (("auto", "hybrid"), ("auto", "hybrid", "fused_step")),
    "update_hierarch": (("auto", "dots"), ("auto", "fused_step")),
    "attn_per_type": (("auto", "einsum"), ("auto",)),
    "aggr_per_type": (("auto",), ("auto",)),
    "aggr_max": (("auto",), ("auto",)),
    "aggr_mean": (("hybrid",), ()),
    "node_steps": (("auto",), ("auto",)),
    "late_fusion": (("auto",), ("auto",)),
    "angle": (("auto",), ("auto",)),
    "ae_normed": (("auto",), ("auto",)),
    "ae": (("auto",), ()),
    "ae_normed_alone": (("auto",), ()),
    "ae_tracking_1": (("auto",), ()),
    "knn_list": (("auto",), ("auto",)),
    "topk": (("auto",), ("auto",)),
    "feature_knn": (("auto",), ()),
    "vanilla_per_type": (("auto",), ("auto",)),
    "vanilla_update_mlp": (("auto",), ("auto",)),
    "vanilla_drop_dist": (("auto",), ("auto",)),
}
# phase 51: the variants at model_58_4's full width; the edge lists run one
# eval forward each
VARIANT_FULL = ("edge_mlp_per_type", "update_hierarch", "attn_per_type", "aggr_per_type",
                "node_steps", "late_fusion", "angle", "ae_normed")
VARIANT_EDGE_LISTS = ("knn_list", "feature_knn", "topk")
# the most memory the per-type edge MLP may add to model_58_4's pallas
# training peak: its saved edge activations are ~E x 320 floats a step
# against the agnostic MLP's E x 128; an (E, T, D) form would add ~38 GB
PER_TYPE_PEAK_GIB = 8.0


def variant_launches(cfg, train):
    """The launches one forward (eval) or one step (``train``) of ``cfg``'s
    MPN must show on the card: its form's kernels (FORM_LAUNCHES) once an
    MPN pass (STEPS + NODE_STEPS); none on the kernel-free routes."""
    from pemp_tpu_torch.config.defaults import layer_route, msg_pass_route, plain_route

    if plain_route(cfg):
        return {}
    mpn = cfg.MODEL.MPN
    route = layer_route(msg_pass_route(cfg.TPU.MSG_PASS, train), mpn.EDGE_MLP, mpn.AGGR_SUB)
    attn = mpn.AGGR_SUB in ("node_edge_attn", "node_edge_attn_per_type")
    passes = mpn.STEPS + mpn.get("NODE_STEPS", 0)
    return {k: v * passes for k, v in FORM_LAUNCHES[train][route].items()
            if attn or k not in ("K4", "K4b")}


def variant_cut(name, msg_pass, eval_cut, base=None):
    """``base`` (small_train() when None) with the variant ``name`` merged,
    on ``msg_pass``; for an eval run without a checkpoint, threshold
    grouping at node threshold 0.1."""
    from pemp_tpu_torch.config import small_train, variant

    cfg = variant(name, small_train() if base is None else base)
    cfg.TPU.MSG_PASS = msg_pass
    if eval_cut:
        cfg.merge_from_other({"MODEL": {"PRETRAINED": "", "GC": {"CC_METHOD": "threshold"},
                                        "MPN": {"NODE_THRESHOLD": 0.1}}})
    return cfg


def phase_small_variants():
    """Phase 50: each variant of :data:`VARIANT_SMALL` on the small cut, CPU
    against card, as phase 29 (the eval slice, every head within 2e-3 and
    the graph exact, but for the feature kNN graph's float32 ties; one
    training step held to the CPU's float64 step), on each route listed;
    the counts zeroed just before each pair of runs and read just after:
    each card run launches its form's kernels once an MPN pass
    (:func:`variant_launches`) and no other. Returns the counts."""
    total = {}
    for name, (evals, trains) in VARIANT_SMALL.items():
        for train, routes in ((False, evals), (True, trains)):
            for route in routes:
                cfg = variant_cut(name, route, not train)
                label = f"small {name} {'train' if train else 'slice'}"
                zero_counts()
                if train:
                    phase_small_train(route, cfg, label, f64_bound=True)
                else:
                    phase_small_slice(route, cfg, label, feature_ties=name == "feature_knn")
                counts = read_counts(f"{label} {route}", variant_launches(cfg, train))
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
    log(f"small variants: launches {total}")
    return total


def phase_variants(card, batches, pallas_peak):
    """Phase 51: model_58_4 at full width (w32/512, batch 8) with each
    variant of :data:`VARIANT_FULL`: one bf16 forward of the eval pipeline
    on ``auto`` on 8 random images, then two f32 training steps on ``auto``
    (``pallas``; a warm-up and a timed step on phase 8's batches), the
    counts zeroed just before each timed run and read just after
    (:func:`variant_launches`); then update_hierarch training on
    ``fused_step`` and edge_mlp_per_type training on ``hybrid``. K2 and K2b
    are held against their plain versions on edge_mlp_per_type's training
    inputs at MPN step 0 (phase 6's limits), K4 on attn_per_type's eval
    inputs at step 0 (bf16, 2e-2 of the largest). The edge lists of
    :data:`VARIANT_EDGE_LISTS` run one eval forward each (the segment
    route: no kernel). Prints each run's device ms, img/s and peak memory;
    edge_mlp_per_type's training peak may pass ``pallas_peak`` (phase 8's,
    this call) by :data:`PER_TYPE_PEAK_GIB` at most. Returns the counts
    and the K2, K2b and K4 errors and numbers, with the launches of K2's
    bf16 form (the eval forwards' K2) under "K2 bf16", apart from the
    counts."""
    from pemp_tpu_torch.config import variant, w32_512_train
    from pemp_tpu_torch.ops import blocked_attn, segment, typed_message
    from pemp_tpu_torch.pipeline import build_pipeline
    from pemp_tpu_torch.train.train_step import build_trainer

    total, peaks, numbers = {}, {}, {}

    def add(counts):
        for k, v in counts.items():
            if k not in ("device_ms", "peak_gib"):
                total[k] = total.get(k, 0) + v

    images = torch.rand(8, 512, 512, 3, generator=torch.Generator().manual_seed(2)).cuda()
    for name in (*VARIANT_FULL, *VARIANT_EDGE_LISTS):
        cfg = variant_cut(name, "auto", True, w32_512_train())
        pipe = build_pipeline(8, 512, dtype=torch.bfloat16, device="cuda", cfg=cfg, seed=0)
        counts = drive_eval(f"{name} eval", pipe, images, 1, variant_launches(cfg, False), card,
                            model="w32")
        numbers["K2 bf16"] = numbers.get("K2 bf16", 0) + counts["K2"]     # K2's bf16 form
        add({k: v for k, v in counts.items() if k != "K2"})
        peaks[f"{name} eval"] = torch.cuda.max_memory_allocated() / 2**30
        if name == "attn_per_type":
            args = capture_eval_inputs(pipe, images, "blocked_attn_aggregate", steps=(0,))[0]
            numbers["K4"] = check_k4("attn_per_type eval path step 0 bf16", args, 2e-2,
                                     blocked_attn, segment)
            del args
        del pipe
        torch.cuda.empty_cache()
    runs = [(name, "auto") for name in VARIANT_FULL] + [("update_hierarch", "fused_step"),
                                                        ("edge_mlp_per_type", "hybrid")]
    for name, route in runs:
        cfg = variant(name)
        cfg.TPU.MSG_PASS = route
        trainer = build_trainer(cfg, device="cuda", seed=0)
        got = drive_train(f"{name} {route} training", trainer, batches[:2],
                          variant_launches(cfg, True), card, model=f"model_58_4 {name}")
        add(got)
        peaks[f"{name} {route} training"] = got["peak_gib"]
        if (name, route) == ("edge_mlp_per_type", "auto"):
            captured = capture_train_inputs(trainer, batches[0], "fused_typed_message_aggregate",
                                            steps=(0,))
            args, g = captured[0]
            numbers["K2"] = check_k2("edge_mlp_per_type train path step 0", args[:6], g,
                                     args[6:], typed_message)
            del captured, args, g
            extra = got["peak_gib"] - pallas_peak
            if not extra <= PER_TYPE_PEAK_GIB:
                raise SystemExit(f"edge_mlp_per_type training: peak {got['peak_gib']:.2f} GiB, "
                                 f"{extra:.2f} above model_58_4's {pallas_peak:.2f} on pallas "
                                 f"(at most {PER_TYPE_PEAK_GIB})")
            log(f"edge_mlp_per_type training: peak {got['peak_gib']:.2f} GiB, {extra:.2f} GiB "
                f"above model_58_4's {pallas_peak:.2f} on pallas (phase 8, this call)")
        del trainer
        torch.cuda.empty_cache()
    log("variants' peak memory (GiB): " + "; ".join(f"{k} {v:.2f}" for k, v in peaks.items()))
    log(f"full-width variants: launches {total}")
    return total, numbers


def main() -> int:
    t_start = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    card = card_line()
    device_kind = torch.cuda.get_device_name(0)
    log(f"device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"capability {torch.cuda.get_device_capability(0)})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    from pemp_tpu_torch.ops import _build, fused_step, typed_message

    t0 = time.perf_counter()
    report = _build.build_all()
    log(f"build: {sorted(report)} in {time.perf_counter() - t0:.1f} s "
        f"(into {_build.build_dir()})")
    for name, entry in sorted(report.items()):
        kernel = "?"
        for line in entry["log"].splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_name(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                log(f"  {name} ptxas {kernel}: {line.strip()}")

    # 3. K1 against its plain version
    from pemp_tpu_torch.pipeline import BATCH, INPUT_SIZE, build_pipeline

    for dtype, form in fused_step.FORMS.items():
        log(f"K1 form for {str(dtype)[6:]}: {form}")
    errs = []
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        args, dims = random_k1_inputs(dtype)
        errs.append(check_k1(f"random {str(dtype)[6:]}", args, dims, tol, fused_step)[0])
        del args
    # ragged: C = 77 is no multiple of 16, 85 nodes per image and 170 in all
    # fill no whole number of either form's 3-node tiles
    args, dims = random_k1_inputs(torch.bfloat16, seed=3, b=2, j=17, k=5, c=77)
    errs.append(check_k1("ragged bf16 (C 77, T 17, 85 nodes per image)", args, dims, 2e-2,
                         fused_step)[0])
    args, dims = random_k1_inputs(torch.float32, seed=4, b=2, j=17, k=5, c=77, t=14)
    errs.append(check_k1("ragged f32 (C 77, T 14, 85 nodes per image)", args, dims, 1e-4,
                         fused_step)[0])
    del args
    batch, size = BATCH, INPUT_SIZE
    pipe = build_pipeline(batch, size, dtype=torch.bfloat16, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(0)
    images = torch.rand(batch, size, size, 3, generator=gen).cuda()
    captured = capture_eval_inputs(pipe, images, "fused_mpn_step")
    main_numbers = None
    for step in (0, 9):
        args = captured[step][:13]
        dims = captured[step][13:]
        numbers = check_k1(f"main path step {step} bf16", args, dims, 2e-2, fused_step)
        errs.append(numbers[0])
        if step == 0:
            main_numbers = numbers[1:]
    del captured, args

    # 4. small slice and decode, CPU against card
    phase_small_slice()
    phase_decode()

    # 5. main path at full width
    steps = pipe.model.mpn.cfg["STEPS"]
    counts = drive_eval("main path", pipe, images, 5, {"K1": steps}, card)
    launches = counts["K1"]
    del pipe
    torch.cuda.empty_cache()

    # 6. K2 and K2b against their plain version
    from pemp_tpu_torch.config import w32_512_train
    from pemp_tpu_torch.data.synthetic import make_batch
    from pemp_tpu_torch.train.train_step import batch_to_torch, build_trainer

    k2_errs = {"fwd": [], "bwd": []}
    args, g, dims = random_k2_inputs()
    for way, numbers in check_k2("random f32", args, g, dims, typed_message).items():
        k2_errs[way].append(numbers[0])
    del args, g
    cfg = w32_512_train()
    bs, train_size = cfg.TRAIN.BATCH_SIZE, cfg.DATASET.INPUT_SIZE
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    batches = [batch_to_torch(make_batch(rng, bs, train_size, tuple(cfg.DATASET.OUTPUT_SIZE),
                                         17, cfg.DATASET.MAX_NUM_PEOPLE), "cuda")
               for _ in range(5)]
    log(f"train batches: 5 synthetic batches of {bs} at {train_size} made in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    trainer = build_trainer(cfg, device="cuda", seed=0)
    captured = capture_train_inputs(trainer, batches[0], "fused_typed_message_aggregate")
    k2_numbers = None
    for step in (0, 9):
        args, g = captured[step]
        numbers = check_k2(f"train path step {step}", args[:6], g, args[6:], typed_message)
        for way in k2_errs:
            k2_errs[way].append(numbers[way][0])
        if step == 0:
            k2_numbers = numbers
            # K2b's reduction launch first: its name extends the main pass's
            parts, rest = launch_ms(typed_message.fused_typed_message_aggregate, args[:6],
                                    (0, 1, 4, 5), g, args[6:],
                                    {"reduce": "typed_message_bwd_reduce",
                                     "main": "typed_message_bwd", "fwd": "typed_message_fwd"})
            if not (parts["fwd"] > 0 and parts["main"] > 0 and parts["reduce"] > 0):
                raise SystemExit(f"K2/K2b launches: the profiler saw no device time ({parts})")
            log(f"K2 and K2b launches, train path step 0 (torch.profiler, device ms per call): "
                f"K2 {parts['fwd']:.4f}; K2b main {parts['main']:.4f}, reduce "
                f"{parts['reduce']:.4f}; rest {parts['rest']:.4f} ({'; '.join(rest)})")
            log(f"K2/K2b groups and blocks, train path step 0: "
                f"{k2_group_stats(args, args[6:], typed_message._CHUNK)}")
    del captured, args, g
    torch.cuda.empty_cache()

    # 7. small training step, CPU against card
    phase_small_train()

    # 8. training at full width
    counts = drive_train("training", trainer, batches[1:],
                         {"K2": steps, "K2b": steps, "G1": steps}, card)
    k2_fwd, k2_bwd, g1_launches = counts["K2"], counts["K2b"], counts["G1"]
    pallas_ms, pallas_peak = counts["device_ms"], counts["peak_gib"]
    del trainer
    torch.cuda.empty_cache()
    log(f"chip_smoke: phases 1-8 done in {time.perf_counter() - t_start:.1f} s")

    # 9. K3 and K3b against their plain version
    from pemp_tpu_torch.config import w48_640
    from pemp_tpu_torch.ops import attn_aggregate, blocked_attn, segment

    k3_errs = {"fwd": [], "bwd": []}
    k3_random, g, dims = random_k3_inputs()
    for way, numbers in check_k3("random f32", k3_random, g, dims, 1e-4,
                                 attn_aggregate).items():
        k3_errs[way].append(numbers[0])
    del g
    train_cfg = w32_512_train()
    train_cfg.TPU.MSG_PASS = "hybrid"
    trainer = build_trainer(train_cfg, device="cuda", seed=0)
    captured = capture_train_inputs(trainer, batches[0], "fused_attn_aggregate")
    k3_numbers = None
    for step in (0, 9):
        args, g = captured[step]
        numbers = check_k3(f"hybrid train path step {step}", args[:5], g, args[5:], 1e-4,
                           attn_aggregate)
        for way in k3_errs:
            k3_errs[way].append(numbers[way][0])
        if step == 0:
            k3_numbers = numbers
            parts, rest = launch_ms(attn_aggregate.fused_attn_aggregate, args[:5], (0, 1, 4), g,
                                    args[5:], {"bwd": "attn_aggregate_bwd",
                                               "fwd": "attn_aggregate_fwd"})
            if not (parts["fwd"] > 0 and parts["bwd"] > 0):
                raise SystemExit(f"K3/K3b launches: the profiler saw no device time ({parts})")
            log(f"K3 and K3b launches, hybrid train path step 0 (torch.profiler, device ms per "
                f"call): K3 {parts['fwd']:.4f}; K3b {parts['bwd']:.4f}; rest "
                f"{parts['rest']:.4f} ({'; '.join(rest)})")
            log(f"K3/K3b rows and groups, hybrid train path step 0: "
                f"{group_stats(args[2], args[3], *args[5:])}")
    del captured, args, g, trainer
    torch.cuda.empty_cache()
    eval_cfgs = {}
    for route in ("hybrid", "einsum"):
        eval_cfgs[route] = w48_640()
        eval_cfgs[route].TPU.MSG_PASS = route
    pipe = build_pipeline(batch, size, dtype=torch.bfloat16, device="cuda",
                          cfg=eval_cfgs["hybrid"], seed=0)
    args = capture_eval_inputs(pipe, images, "fused_attn_aggregate", steps=(0,))[0]
    k3_errs["fwd"].append(check_k3("hybrid eval path step 0 bf16", args[:5], None, args[5:],
                                   2e-2, attn_aggregate)["fwd"][0])
    del pipe, args
    torch.cuda.empty_cache()

    # 10. K4 against its plain version
    pipe = build_pipeline(batch, size, dtype=torch.bfloat16, device="cuda",
                          cfg=eval_cfgs["einsum"], seed=0)
    args = capture_eval_inputs(pipe, images, "blocked_attn_aggregate", steps=(0,))[0]
    k4_numbers = check_k4("einsum eval path step 0 bf16", args, 2e-2, blocked_attn, segment)
    k4_errs = [k4_numbers[0]]
    parts, rest = launch_ms(blocked_attn.blocked_attn_aggregate, args, (), None, (),
                            {"fwd": "blocked_attn_fwd"})
    if not parts["fwd"] > 0:
        raise SystemExit(f"K4 launch: the profiler saw no device time ({parts})")
    log(f"K4 launch, einsum eval path step 0 (torch.profiler, device ms per call): K4 "
        f"{parts['fwd']:.4f}; rest {parts['rest']:.4f} ({'; '.join(rest)})")
    m, _, types, n, t, valid = args
    log(f"K4 rows and groups, einsum eval path step 0: {group_stats(types, valid, n, t)}; "
        f"resident warps per SM {blocked_attn.resident_warps(types.numel() // n, m.dtype)} "
        f"(a warp a node, {n} nodes, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs)")
    del pipe, args, m, types, valid
    b, a, types, valid, logits = k3_random
    n, t = dims
    node = torch.arange(b.shape[0], device="cuda") // (b.shape[0] // n)
    m = torch.relu(a[node, types.long()] + b)
    k4_errs.append(check_k4("random f32", (m, logits, types, n, t, valid), 1e-4, blocked_attn,
                            segment)[0])
    with torch.no_grad():
        via_k4 = blocked_attn.blocked_attn_aggregate(m, logits, types, n, t, valid)
        via_k3 = attn_aggregate.fused_attn_aggregate(b, a, types, valid, logits, n, t)
    err, scale = (via_k4 - via_k3).abs().max().item(), via_k3.abs().max().item()
    if not err <= 1e-5 * scale:
        raise SystemExit(f"K4 on relu(a_sel + b) differs from K3 on (b, a) by {err}")
    log(f"K4 on relu(a_sel + b) against K3 on (b, a), random f32: max abs err {err:.3e} of "
        f"max {scale:.3e}; bit-identical {torch.equal(via_k4, via_k3)}")
    del k3_random, b, a, types, valid, logits, node, m, via_k4, via_k3
    torch.cuda.empty_cache()

    # 11. small slices on the reverse-permutation routes, CPU against card
    phase_small_train("hybrid")
    phase_small_slice("hybrid")
    phase_small_slice("einsum")

    # 12. full width per route
    trainer = build_trainer(train_cfg, device="cuda", seed=0)
    counts_train = drive_train("hybrid training", trainer, batches[1:],
                               {"K3": steps, "K3b": steps, "G1": steps}, card)
    g1_launches += counts_train["G1"]
    del trainer
    torch.cuda.empty_cache()
    counts_eval = {}
    for route, kernel in (("hybrid", "K3"), ("einsum", "K4")):
        pipe = build_pipeline(batch, size, dtype=torch.bfloat16, device="cuda",
                              cfg=eval_cfgs[route], seed=0)
        counts_eval[route] = drive_eval(f"{route} eval", pipe, images, 5, {kernel: steps}, card)
        del pipe
        torch.cuda.empty_cache()

    log(f"chip_smoke: phases 1-12 done in {time.perf_counter() - t_start:.1f} s")

    # 13. K2's bf16 form against its plain version at the pallas eval path's step 0
    from pemp_tpu_torch.ops import gather_mm

    for route in ("pallas", "dots"):
        eval_cfgs[route] = w48_640()
        eval_cfgs[route].TPU.MSG_PASS = route
    k2_bf16_numbers = phase_k2_bf16(images, eval_cfgs["pallas"])

    # 14. K4b against its plain versions at the einsum train path's step 0
    # and on random f32 inputs
    route_cfgs = {}
    for route in ("einsum", "dots"):
        route_cfgs[route] = w32_512_train()
        route_cfgs[route].TPU.MSG_PASS = route
    trainer = build_trainer(route_cfgs["einsum"], device="cuda", seed=0)
    args, g = capture_train_inputs(trainer, batches[0], "blocked_attn_aggregate", steps=(0,))[0]
    if args[0].dtype != torch.float32:
        raise SystemExit("einsum train path: K4's messages are not float32")
    k4b_numbers = check_k4b("einsum train path step 0", args, g, blocked_attn, segment)
    k4b_errs = [k4b_numbers[0]]
    parts, rest = launch_ms(blocked_attn.blocked_attn_aggregate, args, (0, 1), g, (),
                            {"bwd": "blocked_attn_bwd", "fwd": "blocked_attn_fwd"})
    if not (parts["fwd"] > 0 and parts["bwd"] > 0):
        raise SystemExit(f"K4/K4b launches: the profiler saw no device time ({parts})")
    log(f"K4 and K4b launches, einsum train path step 0 (torch.profiler, device ms per call): "
        f"K4 {parts['fwd']:.4f}; K4b {parts['bwd']:.4f}; rest {parts['rest']:.4f} "
        f"({'; '.join(rest)})")
    log(f"K4b rows and groups, einsum train path step 0: "
        f"{group_stats(args[2], args[5], args[3], args[4])}")
    del args, g, trainer
    torch.cuda.empty_cache()
    (b, a, types, valid, logits), g, (n, t) = random_k3_inputs(seed=8)
    node = torch.arange(b.shape[0], device="cuda") // (b.shape[0] // n)
    m = torch.relu(a[node, types.long()] + b)
    k4b_errs.append(check_k4b("random f32", (m, logits, types, n, t, valid), g, blocked_attn,
                              segment)[0])
    del b, a, types, valid, logits, g, node, m
    torch.cuda.empty_cache()

    # 15. G1 against its plain version at the pallas train path's first gather
    trainer = build_trainer(cfg, device="cuda", seed=0)
    (x, j, _, plan), g = capture_train_inputs(trainer, batches[0], "gather_rows_mm_or_plain",
                                              steps=(0,))[0]
    if plan is None or x.dtype != torch.float32:
        raise SystemExit("pallas train path: the source gather has no plan or is not float32")
    g1_numbers, g1_library_ms = check_g1("pallas train path step 0", x, j, plan, g, gather_mm)
    g1_errs = [g1_numbers[0]]
    del x, j, plan, g, trainer
    torch.cuda.empty_cache()
    # and at the dots train path's step 0: the source gather, then the
    # projection's two selections, (node, type) rows of a and (slot, type)
    # rows of the all-types projection
    trainer = build_trainer(route_cfgs["dots"], device="cuda", seed=0)
    captured = capture_train_inputs(trainer, batches[0], "gather_rows_mm_or_plain",
                                    steps=(1, 2))
    for call, what in ((1, "a rows"), (2, "all-types rows")):
        (x, j, _, plan), g = captured[call]
        g1_errs.append(check_g1(f"dots train path step 0, {what}", x, j, plan, g,
                                gather_mm)[0][0])
    del captured, x, j, plan, g, trainer
    torch.cuda.empty_cache()

    # 16. small slices on pallas and dots at eval, small training steps on
    # einsum and dots, CPU against card
    phase_small_slice("pallas")
    phase_small_slice("dots")
    phase_small_train("einsum")
    phase_small_train("dots")

    # 17. full width on the new routes, the counts zeroed just before each
    # run and read just after
    for route, kernel in (("pallas", "K2"), ("dots", "K4")):
        pipe = build_pipeline(batch, size, dtype=torch.bfloat16, device="cuda",
                              cfg=eval_cfgs[route], seed=0)
        counts_eval[route] = drive_eval(f"{route} eval", pipe, images, 5, {kernel: steps}, card)
        del pipe
        torch.cuda.empty_cache()
    counts_fit = {}
    for route, gathers in (("einsum", 2), ("dots", 3)):
        # G1: the source gather, the (node, type) selection and on dots the
        # all-types selection, each once a step
        trainer = build_trainer(route_cfgs[route], device="cuda", seed=0)
        counts_fit[route] = drive_train(f"{route} training", trainer, batches[1:],
                                        {"K4": steps, "K4b": steps, "G1": gathers * steps}, card)
        g1_launches += counts_fit[route]["G1"]
        del trainer
        torch.cuda.empty_cache()
    log(f"chip_smoke: phases 1-17 done in {time.perf_counter() - t_start:.1f} s")

    # 47-49, run here on phase 8's batches, beside the other kernel phases
    # whose device times torch.profiler reads: training on the fused step,
    # K1's backward (K2b, K1b, G1) against autograd through the plain
    # version, the small steps CPU against card, model_58_4 at full width
    t0 = time.perf_counter()
    k1b_numbers, k1b_err = phase_k1_backward(batches[0])
    log(f"chip_smoke: phase 47 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts48 = phase_small_fused_train()
    log(f"chip_smoke: phase 48 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts49 = phase_fused_train(card, batches[1:], pallas_ms)
    for c in (counts48, counts49):
        launches += c["K1"]
        k2_bwd += c["K2b"]
        g1_launches += c["G1"]
    k1b_launches = counts48["K1b"] + counts49["K1b"]
    log(f"chip_smoke: phase 49 done in {time.perf_counter() - t0:.1f} s")

    # 50-51, here on phase 8's batches too: the JAX package's MPN and graph
    # variants, the small cuts CPU against card, then model_58_4 at full
    # width
    t0 = time.perf_counter()
    variant_counts = phase_small_variants()
    log(f"chip_smoke: phase 50 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    full_counts, variant_numbers = phase_variants(card, batches, pallas_peak)
    del batches
    for c in (variant_counts, full_counts):
        launches += c.get("K1", 0)
        k2_fwd += c.get("K2", 0)
        k2_bwd += c.get("K2b", 0)
        g1_launches += c.get("G1", 0)
        k1b_launches += c.get("K1b", 0)
    variant_k34 = {k: variant_counts.get(k, 0) + full_counts.get(k, 0)
                   for k in ("K3", "K3b", "K4", "K4b")}
    variant_k2_bf16 = variant_numbers["K2 bf16"]
    for way in k2_errs:
        k2_errs[way].append(variant_numbers["K2"][way][0])
    k4_errs.append(variant_numbers["K4"][0])
    log(f"chip_smoke: phase 51 done in {time.perf_counter() - t0:.1f} s")

    # 18. small TTA slice, CPU against card
    phase_small_tta()

    # 19. the eval entry point at full width: w48/640, scales [2.0, 1.0, 0.5]
    # with flip, threshold decode on the card; 8 rendered images of one
    # shape, one batch of 8
    import tempfile

    from pemp_tpu_torch.data.synthetic import eval_scenes

    sizes = [(480, 640), (640, 480)] * 8
    rendered, dataset = eval_scenes(np.random.RandomState(7), sizes)
    with tempfile.TemporaryDirectory() as tmp:
        # the 8 images of 480x640 (one batch): cut from 16 in two shapes for
        # the smoke's time limit when phases 40-41 came
        eval_set = RenderedSet(tmp, *landscape(rendered, dataset))
        cfg = w48_640()
        cfg.merge_from_other({"TEST": {"FLIP_TEST": True, "SCALE_FACTOR": [2.0, 1.0, 0.5]}})
        valid_launches, _, _ = drive_valid("valid w48/640 multi-scale + flip", cfg, eval_set,
                                           1, card, tmp)

        # 20. model_58_4 as its file says: w32/512, one scale, no flip, GAEC
        # on the host through the g++ library built at first use
        cfg = w32_512_train()
        cfg.MODEL.MPN.NODE_THRESHOLD = 0.5   # the file's 1.0: no sigmoid score passes it
        count, times, dt = drive_valid("valid model_58_4 GAEC", cfg, eval_set, 1, card, tmp)
        valid_launches += count
        log(f"valid model_58_4 GAEC: host clustering and its decode {times['cluster']:.3f} s "
            f"of the staged run's {dt:.3f} ({100 * times['cluster'] / dt:.1f} %)")

    # 21. scoring on the card's machine
    phase_scoring()
    launches += valid_launches
    log(f"chip_smoke: phases 1-21 done in {time.perf_counter() - t_start:.1f} s")

    # 22. the training entry point on the small cut, CPU against card
    phase_small_train_entry()

    # 23. the training entry point at full width: model_58_4 through train()
    counts = phase_train_entry(card)
    single_ms = counts["device_ms"]
    k2_fwd += counts["K2"]
    k2_bwd += counts["K2b"]
    g1_launches += counts["G1"]
    log(f"chip_smoke: phases 1-23 done in {time.perf_counter() - t_start:.1f} s")

    # 24. the small Hourglass maps_only slice and the small model_81_1_2
    # slices (fused-step eval, pallas training step; T = 14), CPU against card
    from pemp_tpu_torch.config import small_81_1_2

    t0 = time.perf_counter()
    phase_small_hg()
    cut = small_81_1_2()
    cut.merge_from_other({"MODEL": {"PRETRAINED": "", "GC": {"CC_METHOD": "threshold"},
                                    "MPN": {"NODE_THRESHOLD": 0.1}}})
    phase_small_slice("auto", cut, "small model_81_1_2 slice")
    phase_small_train("auto", small_81_1_2(), "small model_81_1_2 train")
    log(f"chip_smoke: phase 24 done in {time.perf_counter() - t0:.1f} s")

    # 25-27. model_81_1_2 at full width: K1, K2 and K2b at T = 14, the eval
    # entry point, training
    numbers81 = phase_model_81_1_2(card, sizes)
    errs.append(numbers81["K1 err"])
    for way in k2_errs:
        k2_errs[way].append(numbers81["K2 errs"][way])
    launches += numbers81["K1"]
    k2_fwd += numbers81["K2"]
    k2_bwd += numbers81["K2b"]
    g1_launches += numbers81["G1"]

    # 28. the AE-grouping entry point at full width: hg_512 (hg, hg2) and
    # w32/512 with flip (hr) on phase 19's 8 images, one batch (cut from 16
    # for the time limit when phases 40-41 came)
    t0 = time.perf_counter()
    phase_valid_hr(card, *landscape(rendered, dataset))
    log(f"chip_smoke: phase 28 done in {time.perf_counter() - t0:.1f} s")

    # 29-31. the ablation configurations: small cuts CPU against card, the
    # eval entry point and training at full width
    numbers_ab = phase_ablations(card, rendered, dataset)
    launches += numbers_ab["K1"]
    k2_fwd += numbers_ab["K2"]
    k2_bwd += numbers_ab["K2b"]
    g1_launches += numbers_ab["G1"]
    log(f"chip_smoke: phases 1-31 done in {time.perf_counter() - t_start:.1f} s")

    # 32-34. graphs on the GT joints: the small cuts CPU against card,
    # training at full width through train(), the upper bounds
    t0 = time.perf_counter()
    phase_small_gt()
    log(f"chip_smoke: phase 32 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    numbers_gt, errs_gt = phase_gt_train(card)
    for way in k2_errs:
        k2_errs[way] += errs_gt[way]
    k2_fwd += numbers_gt["K2"]
    k2_bwd += numbers_gt["K2b"]
    g1_launches += numbers_gt["G1"]
    log(f"chip_smoke: phase 33 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_upper_bounds(card, rendered, dataset)
    log(f"chip_smoke: phase 34 done in {time.perf_counter() - t0:.1f} s")

    # 35-37. the tag-regression, background-class, group-based and greedy
    # configurations: the small cuts CPU against card, the eval entry point
    # and training at full width
    t0 = time.perf_counter()
    phase_small_zoo()
    log(f"chip_smoke: phase 35 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches += phase_zoo_valid(card, rendered, dataset)
    log(f"chip_smoke: phase 36 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    numbers_zoo, errs_zoo = phase_zoo_train(card)
    for way in k2_errs:
        k2_errs[way] += errs_zoo[way]
    k2_fwd += numbers_zoo["K2"]
    k2_bwd += numbers_zoo["K2b"]
    g1_launches += numbers_zoo["G1"]
    log(f"chip_smoke: phase 37 done in {time.perf_counter() - t0:.1f} s")

    # 38-39. the research zoo: the small cuts CPU against card, the eval
    # entry point and training at full width
    t0 = time.perf_counter()
    numbers_research = phase_small_zoo_research()
    log(f"chip_smoke: phase 38 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    full_research = phase_zoo_research(card, rendered, dataset)
    for counts in (numbers_research, full_research):
        launches += counts["K1"]
        k2_fwd += counts["K2"]
        k2_bwd += counts["K2b"]
        g1_launches += counts["G1"]
    log(f"chip_smoke: phase 39 done in {time.perf_counter() - t0:.1f} s")

    # 40-41. data parallelism: the training entry point under torchrun with
    # NCCL, then two ranks on the one card under gloo against one process
    t0 = time.perf_counter()
    counts = phase_dp_train_entry(card, single_ms)
    k2_fwd += counts["K2"]
    k2_bwd += counts["K2b"]
    g1_launches += counts["G1"]
    log(f"chip_smoke: phase 40 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = phase_dp_two_ranks(card, rendered, dataset)
    launches += counts["K1"]
    k2_fwd += counts["K2"]
    k2_bwd += counts["K2b"]
    g1_launches += counts["G1"]
    log(f"chip_smoke: phase 41 done in {time.perf_counter() - t0:.1f} s")

    # 42-46. the JAX package's tools: overfit at full width and its learning
    # check, the checkpoint converter, the drawings, the graph statistics
    t0 = time.perf_counter()
    counts = phase_overfit(card)
    counts43, _ = phase_overfit_learns()
    for c in (counts, counts43):
        k2_fwd += c["K2"]
        k2_bwd += c["K2b"]
        g1_launches += c["G1"]
    log(f"chip_smoke: phases 42-43 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches += phase_convert(card)["K1"]
    log(f"chip_smoke: phase 44 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches += phase_draw(card, *landscape(rendered, dataset))["K1"]
    log(f"chip_smoke: phase 45 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_graph_tools(card, *landscape(rendered, dataset))
    log(f"chip_smoke: phase 46 done in {time.perf_counter() - t0:.1f} s")

    ms, plain_ms, bound, bound_by = main_numbers
    kernels = [{
        "name": "fused_mpn_step", "route": "cuda",
        "source": "pemp_tpu_torch/csrc/fused_step.cu",
        "replaces": "pemp_tpu/ops/pallas/fused_step.py:252",
        "launches": launches, "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None,
    }]
    rows = (
        ("fused_typed_message_aggregate", "typed_message.cu",
         "pallas/fused_typed_message.py:412", k2_fwd, max(k2_errs["fwd"]), k2_numbers["fwd"]),
        ("fused_typed_message_aggregate_bwd", "typed_message.cu",
         "pallas/fused_typed_message.py:352", k2_bwd, max(k2_errs["bwd"]), k2_numbers["bwd"]),
        ("fused_attn_aggregate", "attn_aggregate.cu", "pallas/fused_typed_message.py:596",
         counts_train["K3"] + counts_eval["hybrid"]["K3"] + variant_k34["K3"],
         max(k3_errs["fwd"]), k3_numbers["fwd"]),
        ("fused_attn_aggregate_bwd", "attn_aggregate.cu", "pallas/fused_typed_message.py:630",
         counts_train["K3b"] + variant_k34["K3b"], max(k3_errs["bwd"]), k3_numbers["bwd"]),
        ("blocked_attn_aggregate", "blocked_attn.cu", "pallas/blocked_attn.py:68",
         counts_eval["einsum"]["K4"] + counts_eval["dots"]["K4"] + counts_fit["einsum"]["K4"]
         + counts_fit["dots"]["K4"] + variant_k34["K4"], max(k4_errs), k4_numbers),
        ("fused_typed_message_aggregate_bf16", "typed_message.cu",
         "pallas/fused_typed_message.py:412", counts_eval["pallas"]["K2"] + variant_k2_bf16,
         k2_bf16_numbers[0],
         k2_bf16_numbers),
        ("blocked_attn_aggregate_bwd", "blocked_attn.cu", "segment.py:172",
         counts_fit["einsum"]["K4b"] + counts_fit["dots"]["K4b"] + variant_k34["K4b"],
         max(k4b_errs), k4b_numbers),
        ("gather_rows_bwd", "gather_rows.cu", "gather_mm.py:79", g1_launches, max(g1_errs),
         g1_numbers),
        ("fused_mpn_step_bwd", "fused_step_bwd.cu", "pallas/fused_step.py:208", k1b_launches,
         k1b_err, k1b_numbers),
    )
    for name, source, replaces, count, err, (_, k_ms, k_plain, k_bound, k_by) in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": f"pemp_tpu_torch/csrc/{source}",
            "replaces": f"pemp_tpu/ops/{replaces}", "launches": count,
            "max_abs_err": err, "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound,
            "bound_by": k_by, "library_ms": g1_library_ms if name == "gather_rows_bwd" else None,
        })
    log(f"chip_smoke: phases 1-51 done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
