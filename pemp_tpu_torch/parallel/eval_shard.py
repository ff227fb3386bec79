"""Evaluation sharded over processes (copy of pemp_tpu.parallel.eval_shard,
with the same file names and JSON).

Each process evaluates an interleaved slice of the image list, writes its
annotations and image ids to a part file in the (shared) log directory,
and process 0 merges every part after a barrier (:func:`gather_parts`).
The rest is plain Python, so the sharding and the merge are testable
without several processes.
"""

from __future__ import annotations

import json
import os

from pemp_tpu_torch.parallel import distributed


def shard_indices(n: int, process_count: int, process_index: int) -> list[int]:
    """Interleaved assignment: process p evaluates images p, p + P, p + 2P,
    ... (interleaving balances the load where image sizes follow the
    dataset's order)."""
    if process_count <= 1:
        return list(range(n))
    return list(range(process_index, n, process_count))


def _part_path(log_dir: str, stem: str, process_index: int) -> str:
    return os.path.join(log_dir, f"{stem}.part{process_index}.json")


def write_part(log_dir: str, stem: str, process_index: int, anns: list, eval_ids: list) -> str:
    """Writes this process's annotations and image ids; returns the path."""
    path = _part_path(log_dir, stem, process_index)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"anns": anns, "eval_ids": [int(i) for i in eval_ids]}, f)
    os.replace(tmp, path)  # atomic: the merge never reads a half-written part
    return path


def merge_parts(log_dir: str, stem: str, process_count: int):
    """Every part concatenated in process order (process 0's side).
    Returns (anns, eval_ids)."""
    anns, eval_ids = [], []
    for p in range(process_count):
        with open(_part_path(log_dir, stem, p)) as f:
            part = json.load(f)
        anns.extend(part["anns"])
        eval_ids.extend(part["eval_ids"])
    return anns, eval_ids


def cleanup_parts(log_dir: str, stem: str, process_count: int) -> None:
    for p in range(process_count):
        try:
            os.remove(_part_path(log_dir, stem, p))
        except OSError:
            pass


def gather_parts(log_dir: str, stem: str, anns: list, eval_ids: list):
    """Every rank's (anns, eval_ids) on rank 0 (tools/valid.py:251-262):
    each rank writes its part, a barrier, then rank 0 merges them in rank
    order and removes them. The other ranks get (None, None)."""
    os.makedirs(log_dir, exist_ok=True)
    write_part(log_dir, stem, distributed.rank(), anns, eval_ids)
    distributed.barrier()
    if not distributed.is_main():
        return None, None
    merged = merge_parts(log_dir, stem, distributed.world())
    cleanup_parts(log_dir, stem, distributed.world())
    return merged
