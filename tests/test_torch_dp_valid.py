"""The eval entry points on two gloo ranks on the CPU against one process:
``valid.main`` (the narrow w48/640 configuration at scales [1.0, 0.5] with
flip, GAEC on the host) and ``valid_hr.main`` (the narrow w32/512 with
flip, the HigherHRNet parser) on tools/make_fake_coco.py's 4 images, with
the seeded weights of tests/test_torch_valid.py and
tests/test_torch_valid_hr.py. Each rank evaluates its interleaved images;
rank 0 merges, scores and writes the same results and report as the one
process, rank 1 returns None, and no part file is left. Rank 0's results
and report are also held against tools/valid.py and tools/valid_hr.py on
the same images and weights, at tests/test_torch_valid.py's tolerances."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from test_torch_tta import OVERRIDES, jax_setup
from test_torch_valid import _run_jax as run_jax_valid
from test_torch_valid_hr import HR, _jax_setup
from test_torch_valid_hr import _run_jax as run_jax_valid_hr

from pemp_tpu_torch import valid, valid_hr
from pemp_tpu_torch.config import load_config, update_config_command
from pemp_tpu_torch.models.ae_group import build_ae_group_model
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.parallel.distributed import run_ranks
from pemp_tpu_torch.train.checkpoint import save_checkpoint
from pemp_tpu_torch.weights import from_jax_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPLIT = "coco_17_full"
DEADLINE_S = 60.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dp_valid")
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_fake_coco.py"), "--root",
                    str(base / "coco"), "--images", "4", "--size", "96"],
                   check=True, capture_output=True)
    coco = ["DATASET.ROOT", str(base / "coco"), "TEST.SPLIT", SPLIT]
    opts = OVERRIDES + ["TEST.SCALE_FACTOR", "[1.0,0.5]", "TEST.FLIP_TEST", "True"] + coco
    _, jmodel, variables = jax_setup(opts, msg_pass_kernel=False)
    cfg = update_config_command(load_config("hrnet/w48_640"), opts)
    model = build_pose_model(cfg, device="cpu", path="valid")
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"], cfg))
    save_checkpoint(str(base / "w48.pt"), model)
    hr_opts = HR[1] + coco
    _, hr_jmodel, hr_vars = _jax_setup(HR[0], hr_opts)
    hr_cfg = update_config_command(load_config(HR[0]), hr_opts)
    hr_model = build_ae_group_model(hr_cfg, device="cpu")
    hr_model.load_state_dict(from_jax_variables(hr_vars["params"],
                                                hr_vars.get("batch_stats", {}), hr_cfg))
    save_checkpoint(str(base / "w32.pt"), hr_model)

    # valid on the einsum route, the JAX package's "auto" off a TPU (as
    # tests/test_torch_valid.py runs it)
    argv = {"valid": ["--config", "hrnet/w48_640", "--out_file", "eval.txt", "--device", "cpu",
                      "--msg-pass", "einsum", *opts, "MODEL.GC.CC_METHOD", "GAEC",
                      "MODEL.PRETRAINED", str(base / "w48.pt")],
            "valid_hr": ["--config", HR[0], "--out_file", "eval.txt", "--device", "cpu",
                         *hr_opts, "MODEL.PRETRAINED", str(base / "w32.pt")]}
    one = {"valid": valid.main(argv["valid"] + ["LOG_DIR", str(base / "one_valid")]),
           "valid_hr": valid_hr.main(argv["valid_hr"] + ["LOG_DIR", str(base / "one_valid_hr")])}
    from torch_dp_ranks import run_jobs

    jobs = [("entry_point", (name, argv[name] + ["LOG_DIR", str(base / f"two_{name}")]))
            for name in ("valid", "valid_hr")]
    ranks = run_ranks(run_jobs, 2, base / "ranks", jobs, deadline_s=DEADLINE_S)
    # what the JAX entry points are given: tools/valid.py with GAEC,
    # tools/valid_hr.py with its default parser
    jax_runs = {
        "valid": lambda monkeypatch, log_dir: run_jax_valid(
            dict(opts=opts, jmodel=jmodel, variables=variables), monkeypatch, log_dir, "GAEC"),
        "valid_hr": lambda monkeypatch, log_dir: run_jax_valid_hr(
            dict(name=HR[0], opts=hr_opts, jmodel=hr_jmodel, variables=hr_vars), monkeypatch,
            log_dir, "hr")}
    return base, one, ranks, jax_runs


def _results(path):
    anns = json.loads(path.read_text())
    return sorted(anns, key=lambda a: (a["image_id"], -a["score"], a["keypoints"]))


@pytest.mark.parametrize("job,name,files", [
    (0, "valid", (f"person_keypoints_{SPLIT}_mpn_results.json",)),
    (1, "valid_hr", ("dt_ae.json", "dt_cc.json")),
])
def test_two_ranks_give_the_single_process_results(runs, monkeypatch, job, name, files):
    base, one, ranks, jax_runs = runs
    assert ranks[1][job] is None
    np.testing.assert_allclose(np.asarray(ranks[0][job], dtype=float),
                               np.asarray(one[name], dtype=float), rtol=0, atol=1e-12)
    single, pair = base / f"one_{name}", base / f"two_{name}"
    # rank 0 wrote what the one process wrote; no part file is left
    assert sorted(p.name for p in pair.iterdir()) == sorted(p.name for p in single.iterdir())
    assert (pair / "eval.txt").read_text().split("Runtime")[0] == (
        single / "eval.txt").read_text().split("Runtime")[0]
    # and what the JAX entry point writes on the same images and weights
    jax_dir = base / f"jax_{name}"
    jax_runs[name](monkeypatch, jax_dir)
    assert (pair / "eval.txt").read_text().split("Runtime")[0] == (
        jax_dir / "eval.txt").read_text().split("Runtime")[0]
    for fname in files:
        for other in (single, jax_dir):
            got, want = _results(pair / fname), _results(other / fname)
            assert len(got) == len(want) > 0
            assert [a["image_id"] for a in got] == [a["image_id"] for a in want]
            np.testing.assert_allclose([a["keypoints"] for a in got],
                                       [a["keypoints"] for a in want], rtol=0, atol=2e-3,
                                       err_msg=str(other))
            np.testing.assert_allclose([a["score"] for a in got], [a["score"] for a in want],
                                       rtol=0, atol=1e-4, err_msg=str(other))
