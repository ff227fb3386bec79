"""Detection and graph statistics over a keypoint set.

    python -m pemp_tpu_torch.comp_graph_stats --config C [--max-images N] \
        [--device cpu] [KEY VALUE ...]

The counterpart of ``tools/comp_graph_stats.py`` (reference:
src/test/comp_graph_stats.py): each training sample of the ``val`` set
(the training augmentation from ``RandomState(0)``, crowd masks, no image
left out) gives its last scale's GT heatmaps to the graph construction as
score maps, with zero features and tags and the GT joints for labels;
printed are the mean, median, 95th percentile and largest of the
detections, valid edges, label-positive nodes and missed GT joints an
image, and of the detection scores.

``--config`` resolves as the other entry points'. The graph is built on
CUDA unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pemp_tpu_torch.config import load_config, update_config_command
from pemp_tpu_torch.data.datasets import CocoKeypoints
from pemp_tpu_torch.data.targets import HeatmapGenerator, JointsGenerator
from pemp_tpu_torch.data.transforms import transforms_hr_train
from pemp_tpu_torch.graph.constructor import GCConfig, construct_graph_batch
from pemp_tpu_torch.models.pose_estimation import resolve_device


def stats_set(config, dataset_cls=CocoKeypoints):
    """The ``val`` set as tools/comp_graph_stats.py:44-53 builds it
    (``dataset_cls`` a CocoKeypoints, or one whose ``load_raw`` serves
    arrays)."""
    nj = config.DATASET.NUM_JOINTS
    outs = list(config.DATASET.OUTPUT_SIZE)
    return dataset_cls(
        config.DATASET.ROOT, mode="val", filter_empty=False, num_joints=nj,
        transforms=transforms_hr_train(config, rng=np.random.RandomState(0)),
        heatmap_generator=[HeatmapGenerator(s, nj, sigma=max(int(s / 64), 1)) for s in outs],
        joint_generator=[JointsGenerator(30, nj, s, True) for s in outs])


def graph_stats(config, dataset, max_images: int = 50, device="cuda") -> dict:
    """Per image the counts (tools/comp_graph_stats.py:55-72), and every
    valid detection's score: lists under "detections/img", "valid
    edges/img", "label-positive nodes/img", "missed GT joints/img
    (num_non_detected)" and "detection scores"."""
    device = resolve_device(device)
    gc = GCConfig.from_config(config)
    keys = ("detections/img", "valid edges/img", "label-positive nodes/img",
            "missed GT joints/img (num_non_detected)", "detection scores")
    out = {k: [] for k in keys}
    for i in range(min(max_images, len(dataset))):
        _, heatmaps, _, kpts, factors, _ = dataset[i]
        heat = torch.from_numpy(heatmaps[-1].transpose(1, 2, 0)[None]).to(device)
        gb = construct_graph_batch(
            gc, heat, torch.zeros_like(heat[..., :1]), torch.zeros_like(heat),
            joints_gt=torch.from_numpy(kpts)[None].to(device),
            factors=torch.from_numpy(factors)[None].to(device))
        valid = gb.node_valid.cpu().numpy()
        positive = int(gb.node_labels.cpu().numpy()[valid].sum())
        out[keys[0]].append(int(valid.sum()))
        out[keys[1]].append(int(gb.edge_valid.sum()))
        out[keys[2]].append(positive)
        out[keys[3]].append(max(int((kpts[:, :, 2] > 0).sum()) - positive, 0))
        out[keys[4]].extend(gb.joint_scores.cpu().numpy()[valid].tolist())
    return out


def stat_line(name, xs) -> str:
    xs = np.asarray(xs, np.float64)
    return (f"{name}: mean={xs.mean():.2f} median={np.median(xs):.1f} "
            f"p95={np.percentile(xs, 95):.1f} max={xs.max():.1f}")


def report(stats: dict) -> list[str]:
    """tools/comp_graph_stats.py:74-84's lines."""
    lines = [f"over {len(stats['detections/img'])} images:"]
    lines += [stat_line(name, xs) for name, xs in stats.items()]
    for line in lines:
        print(line)
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description="Graph and detection statistics")
    p.add_argument("--config", required=True)
    p.add_argument("--max-images", type=int, default=50)
    p.add_argument("--device", default="cuda")
    args, options = p.parse_known_args(argv)
    config = update_config_command(load_config(args.config), options)
    return report(graph_stats(config, stats_set(config), args.max_images, args.device))


if __name__ == "__main__":
    main()
