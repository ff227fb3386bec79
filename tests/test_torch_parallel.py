"""pemp_tpu_torch.parallel without a card: the eval sharding against the
JAX package's (the same slices, the same part files), the launch read from
torchrun's, Slurm's, Open MPI's and PMI's variables, a plain process with
no group, a failed initialisation that raises, and ranks that overrun
their deadline."""

import json
import subprocess
import sys

import pytest
import torch

from pemp_tpu.parallel import eval_shard as jax_shard
from pemp_tpu_torch.parallel import distributed, eval_shard
from pemp_tpu_torch.parallel.distributed import launch_env


@pytest.mark.parametrize("n,count", [(0, 1), (7, 1), (7, 2), (10, 3), (2, 4)])
def test_shard_indices_match_the_jax_package(n, count):
    shards = [eval_shard.shard_indices(n, count, p) for p in range(count)]
    assert shards == [jax_shard.shard_indices(n, count, p) for p in range(count)]
    assert sorted(i for s in shards for i in s) == list(range(n))


def test_part_files_are_the_jax_package_s(tmp_path):
    """Parts written by the port merge with the JAX package's functions and
    the other way round, to the same annotations and ids; cleanup removes
    every part."""
    parts = [([{"image_id": 1, "keypoints": [0.5] * 51, "score": 0.25}], [1, 3]),
             ([], [2]), ([{"image_id": 4, "keypoints": [1.0] * 51, "score": 1.5}], [4])]
    for writer, merger, cleaner in ((eval_shard, jax_shard, jax_shard),
                                    (jax_shard, eval_shard, eval_shard)):
        paths = [writer.write_part(str(tmp_path), "eval_x", p, anns, ids)
                 for p, (anns, ids) in enumerate(parts)]
        assert [json.loads(open(path).read()) for path in paths] == [
            {"anns": anns, "eval_ids": ids} for anns, ids in parts]
        anns, ids = merger.merge_parts(str(tmp_path), "eval_x", len(parts))
        assert anns == [a for p in parts for a in p[0]] and ids == [1, 3, 2, 4]
        cleaner.cleanup_parts(str(tmp_path), "eval_x", len(parts))
        assert not list(tmp_path.iterdir())


def test_gather_parts_without_a_group_keeps_the_lists(tmp_path):
    anns, ids = eval_shard.gather_parts(str(tmp_path), "eval_x", [{"a": 1}], [5])
    assert (anns, ids) == ([{"a": 1}], [5]) and not list(tmp_path.iterdir())


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "3", "MASTER_ADDR": "n0",
      "MASTER_PORT": "1234"},
     {"launcher": "torchrun", "rank": 3, "world": 8, "local_rank": 3, "addr": "n0",
      "port": 1234}),
    # torchrun with one process still makes a group of one
    ({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"},
     {"launcher": "torchrun", "rank": 0, "world": 1, "local_rank": 0, "addr": "localhost",
      "port": 29500}),
    ({"SLURM_PROCID": "5", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
      "SLURM_STEP_NODELIST": "gpu[03-04,07],cpu1"},
     {"launcher": "slurm", "rank": 5, "world": 8, "local_rank": 1, "addr": "gpu03",
      "port": 29500}),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "1", "SLURM_LOCALID": "0"}, None),
    ({"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "2",
      "OMPI_COMM_WORLD_LOCAL_RANK": "1", "MASTER_ADDR": "h", "MASTER_PORT": "9"},
     {"launcher": "openmpi", "rank": 1, "world": 2, "local_rank": 1, "addr": "h", "port": 9}),
    ({"PMI_RANK": "2", "PMI_SIZE": "4", "PMI_LOCAL_RANK": "0", "MASTER_ADDR": "h"},
     {"launcher": "pmi", "rank": 2, "world": 4, "local_rank": 0, "addr": "h",
      "port": 29500}),
])
def test_launch_env(env, want):
    assert launch_env(env) == want


@pytest.mark.parametrize("env,match", [
    ({"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "2",
      "OMPI_COMM_WORLD_LOCAL_RANK": "1"}, "MASTER_ADDR"),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "2", "MASTER_ADDR": "h"}, "SLURM_LOCALID"),
    ({"RANK": "2", "WORLD_SIZE": "2", "MASTER_ADDR": "h"}, "outside"),
])
def test_launch_env_refuses(env, match):
    with pytest.raises(ValueError, match=match):
        launch_env(env)


def test_a_plain_process_has_no_group():
    assert distributed.init("cpu") == torch.device("cpu")     # no launcher's variables
    assert not distributed.active()
    assert (distributed.world(), distributed.rank(), distributed.is_main()) == (1, 0, True)
    x = torch.arange(4.0, requires_grad=True)
    assert distributed.global_sum(x) is x
    assert distributed.global_mean(x).item() == 1.5
    assert distributed.shard_rows({"a": [torch.arange(4)]})["a"][0].tolist() == [0, 1, 2, 3]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.init("cuda", launch={"launcher": "torchrun", "rank": 0, "world": 1,
                                         "local_rank": 0, "addr": "localhost", "port": 1})


_FAILED_INIT = r"""
import sys
from pemp_tpu_torch.parallel import distributed
launch = {"launcher": "torchrun", "rank": 1, "world": 2, "local_rank": 0}
try:
    distributed.init("cpu", launch=launch, init_method="file://" + sys.argv[1], timeout_s=2)
except Exception as e:          # the failure reaches the caller
    print("raised", type(e).__name__)
    sys.exit(0)
print("no error")
sys.exit(1)
"""


def test_a_failed_initialisation_raises(tmp_path):
    """Rank 1 of 2 whose rank 0 never comes: the rendezvous times out and
    raises (the JAX function prints and goes on as one process)."""
    out = subprocess.run([sys.executable, "-c", _FAILED_INIT, str(tmp_path / "store")],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("raised")


def test_ranks_past_their_deadline_are_killed(tmp_path):
    from torch_dp_ranks import sleep

    with pytest.raises(TimeoutError, match="did not end within"):
        distributed.run_ranks(sleep, 2, tmp_path, 60.0, deadline_s=8.0)


def test_a_failing_rank_raises(tmp_path):
    from torch_dp_ranks import entry_point

    with pytest.raises(RuntimeError, match="ranks failed"):
        distributed.run_ranks(entry_point, 2, tmp_path, "valid", ["--bad-flag"],
                              deadline_s=30.0)


def test_dry_run_on_two_ranks():
    """``python -m pemp_tpu_torch.parallel.dryrun 2``: a data-parallel step
    and the sharded eval on two gloo ranks."""
    out = subprocess.run([sys.executable, "-m", "pemp_tpu_torch.parallel.dryrun", "2",
                          "--deadline", "60"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "parameters bit-identical across ranks True" in out.stdout
    assert out.stdout.count("persons shapes [(30, 17, 3)], finite True") == 2
