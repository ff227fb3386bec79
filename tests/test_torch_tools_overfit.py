"""``python -m pemp_tpu_torch.overfit`` against ``tools/overfit.py`` at the
small model_58_4 cut (narrow HigherHRNet at 64x64, batch 2, K = 8, 3 MPN
steps; ``pallas``, on the JAX side through the typed message
kernel's plain reference, as build_pose_model runs it off a TPU), the same
seeded weights: two iterations printing at each, the losses within 5e-3
(as the ``train()`` tests hold them), the eval pass's last edge and node
logits within 2e-4 of the largest of them, the printed metrics equal
wherever no logit under its mask lies within 1e-4 of 0. (Not at
tests/test_overfit.py's smaller cut: Adam's first steps move each weight
by about the learning rate whatever the sign of its gradient, so gradients
within rounding of 0 set the two sides apart, and there, with logits ten
times smaller, by up to 1.5 times this limit after two steps.)"""

import pathlib
import re
import sys
from io import StringIO

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_slice import _seeded_variables
from test_torch_tta import OVERRIDES
from test_torch_valid import _Seeded

from pemp_tpu.config import get_config as jax_get_config
from pemp_tpu.config import update_config as jax_update_config
from pemp_tpu.config import update_config_command as jax_update_config_command
from pemp_tpu.models import build_pose_model as jax_build_pose_model
from pemp_tpu_torch import overfit
from pemp_tpu_torch.config import load_config, update_config_command
from pemp_tpu_torch.models.pose_estimation import build_pose_model
from pemp_tpu_torch.weights import from_jax_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = "hybrid_class_agnostic_end2end/model_58_4"
OPTS = OVERRIDES + ["TRAIN.BATCH_SIZE", "2", "TPU.MSG_PASS", "pallas"]
ITERS = 2


@pytest.fixture(scope="module")
def runs():
    """tools/overfit.py's printed lines and eval outputs, and the port's rows."""
    jcfg = jax_update_config_command(
        jax_update_config(jax_get_config(), f"configs/{CONFIG}.yaml"), OPTS)
    jmodel = jax_build_pose_model(jcfg)          # off a TPU: the kernel's plain reference
    variables = _seeded_variables(jmodel, jnp.zeros((1, 64, 64, 3)), np.random.RandomState(0))

    import pemp_tpu.models

    seen = []
    real_jit = jax.jit

    def recording_jit(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)
        if getattr(fn, "__name__", "") != "eval_step":
            return jitted

        def run(*a):
            out = jitted(*a)
            seen.append(jax.tree_util.tree_map(np.asarray, out[2]))
            return out
        return run

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(pemp_tpu.models, "build_pose_model", lambda cfg: _Seeded(jmodel, variables))
        mp.setattr(jax, "jit", recording_jit)
        # the tool's state starts with fail_count a Python 0, which its first
        # step turns into an array: a second trace and compile of the step
        # (~100 s here). Started as the array, the step compiles once.
        import pemp_tpu.train

        state_cls = pemp_tpu.train.TrainState
        mp.setattr(pemp_tpu.train, "TrainState",
                   lambda **kw: state_cls(**kw, fail_count=jnp.int32(0)))
        mp.syspath_prepend(str(ROOT / "tools"))
        mp.chdir(ROOT)
        mp.setattr(sys, "argv", ["overfit.py", "--config", CONFIG, "--iters", str(ITERS),
                                 "--print-freq", "1", *OPTS])
        import overfit as jax_tool

        buf = StringIO()
        mp.setattr(sys, "stdout", buf)
        jax_tool.main()
    finally:
        mp.undo()
    lines = [line for line in buf.getvalue().splitlines() if line.startswith("iter ")]

    cfg = update_config_command(load_config(CONFIG), OPTS)
    model = build_pose_model(cfg, device="cpu", path="train")
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"],
                                             cfg))
    rows = overfit.overfit(cfg, overfit.overfit_batch(cfg), "cpu", ITERS, 1, model=model)
    return dict(lines=lines, outputs=seen, rows=rows)


def _loss(line):
    return float(re.search(r"loss ([-0-9.naif]+)", line).group(1))


def test_overfit_losses_match(runs):
    assert len(runs["lines"]) == len(runs["rows"]) == ITERS
    assert [r["iter"] for r in runs["rows"]] == list(range(ITERS))
    np.testing.assert_allclose([r["loss"] for r in runs["rows"]],
                               [_loss(line) for line in runs["lines"]], rtol=5e-3)


@pytest.mark.parametrize("it", range(ITERS))
def test_overfit_eval_logits_and_metrics_match(runs, it):
    out, row = runs["outputs"][it], runs["rows"][it]
    near_zero = False
    largest = max(float(np.abs(out["preds"][key][-1]).max()) for key in ("edge", "node"))
    for key, got in (("edge", row["edge_logit"]), ("node", row["node_logit"])):
        want = out["preds"][key][-1]
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * largest, err_msg=key)
        mask = out["masks"][key][-1] if key == "edge" else out["masks"][key]
        near_zero |= bool((np.abs(want)[np.asarray(mask) == 1.0] < 1e-4).any())
    line = runs["lines"][it]
    assert row["line"].split("|")[0].startswith(line.split("|")[0][:10])
    if not near_zero:
        assert row["line"].split("|")[1:] == line.split("|")[1:]


def test_overfit_cli(capsys):
    """The CLI on the CPU at the small cut, seeded weights: one iteration,
    its line printed."""
    rows = overfit.main(["--config", CONFIG, "--iters", "1", "--device", "cpu", *OPTS])
    assert len(rows) == 1 and np.isfinite(rows[0]["loss"])
    assert capsys.readouterr().out.strip().endswith(rows[0]["line"])
