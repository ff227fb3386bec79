"""The AE-grouping entry point, port against JAX package: ``python -m
pemp_tpu_torch.valid_hr`` against ``tools/valid_hr.py`` on a 4-image set
written by tools/make_fake_coco.py, for all three parsers, on the narrow
HigherHRNet (the w32/512 file at 64 pixels with flip) and on the narrow
Hourglass (the hg_512 file, 2 stacks 16 wide, at 512 with long-side
scaling). The same seeded weights reach JAX through its model's ``init``
and the port through a torch checkpoint. Also TTAPipeline's ``maps_only``
on the long canvas at two scales with flip against pemp_tpu.tta."""

import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_slice import _seeded_variables
from test_torch_tta import OVERRIDES

from pemp_tpu.config import get_config as jax_get_config
from pemp_tpu.config import update_config as jax_update_config
from pemp_tpu.config import update_config_command as jax_update_config_command
from pemp_tpu.models.ae_group import build_ae_group_model as jax_build_ae_group_model
from pemp_tpu.tta import TTAPipeline as JaxTTAPipeline
from pemp_tpu_torch import valid_hr
from pemp_tpu_torch.config import load_config, update_config_command
from pemp_tpu_torch.models.ae_group import build_ae_group_model
from pemp_tpu_torch.train.checkpoint import save_checkpoint
from pemp_tpu_torch.tta.multi_scale import TTAPipeline
from pemp_tpu_torch.weights import from_jax_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the narrow cuts, as KEY VALUE pairs: HigherHRNet as config.SMALL at 64
# pixels (its file's flip kept), the Hourglass as config.SMALL_HG
HR = ("hrnet/w32_512", OVERRIDES)
HG = ("hourglass/hg_512", ["MODEL.HG.NSTACK", "2", "MODEL.HG.INPUT_DIM", "16",
                           "DATASET.OUTPUT_SIZE", "[128,128]"])
BACKBONES = {"hrnet": HR, "hourglass": HG}


# (heat, tag) scales of the output heads' weights: seeded random weights
# give HigherHRNet maps of std ~11 and the Hourglass's ~0.4; scaled to ~0.1
# (heat) and ~1 (tags), a share of the peaks passes the 0.1 detection
# threshold and the tag distances straddle the 1.0 matching threshold
HEAD_SCALES = {"hrnet/w32_512": (0.01, 0.1), "hourglass/hg_512": (0.25, 1.0)}


def _jax_setup(name, opts):
    jcfg = jax_update_config_command(
        jax_update_config(jax_get_config(), f"configs/{name}.yaml"), opts)
    jmodel = jax_build_ae_group_model(jcfg)
    size = jcfg.DATASET.INPUT_SIZE
    variables = _seeded_variables(jmodel, jnp.zeros((1, size, size, 3)),
                                  np.random.RandomState(0))
    heat, tag = HEAD_SCALES[name]
    bb, j = variables["params"]["backbone"], jcfg.DATASET.NUM_JOINTS
    if name.startswith("hourglass"):
        heads = [(bb[f"outs_{jcfg.MODEL.HG.NSTACK - 1}"]["conv"], 2 * j)]
    else:
        heads = [(bb["final_layers_0"], 2 * j), (bb["final_layers_1"], j)]
    for head, channels in heads:
        scale = np.array([heat] * j + [tag] * (channels - j)
                         + [1.0] * (head["bias"].shape[0] - channels), np.float32)
        head["kernel"] = head["kernel"] * scale
        head["bias"] = head["bias"] * scale
    return jcfg, jmodel, variables


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    base = tmp_path_factory.mktemp("valid_hr")
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_fake_coco.py"), "--root",
                    str(base / "coco"), "--images", "4", "--size", "96"],
                   check=True, capture_output=True)
    out = {"base": base}
    for backbone, (name, opts) in BACKBONES.items():
        opts = opts + ["DATASET.ROOT", str(base / "coco")]
        _, jmodel, variables = _jax_setup(name, opts)
        cfg = update_config_command(load_config(name), opts)
        model = build_ae_group_model(cfg, device="cpu")
        model.load_state_dict(from_jax_variables(variables["params"],
                                                 variables.get("batch_stats", {}), cfg))
        save_checkpoint(str(base / f"{backbone}.pt"), model)
        out[backbone] = dict(name=name, opts=opts, jmodel=jmodel, variables=variables)
    return out


class _Seeded:
    """The JAX model, its ``init`` giving the seeded variables."""

    def __init__(self, model, variables):
        self._model, self._variables = model, variables

    def __getattr__(self, name):
        return getattr(self._model, name)

    def init(self, *args, **kwargs):
        return self._variables


def _run_jax(setup, monkeypatch, log_dir, parser):
    import pemp_tpu.models.ae_group

    monkeypatch.setattr(pemp_tpu.models.ae_group, "build_ae_group_model",
                        lambda cfg: _Seeded(setup["jmodel"], setup["variables"]))
    monkeypatch.setenv("EVAL_FANOUT", "0")
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import valid_hr as jax_valid_hr

    monkeypatch.setattr(sys, "argv", [
        "valid_hr.py", "--config", setup["name"], "--out_file", "eval.txt", "--parser", parser,
        *setup["opts"], "LOG_DIR", str(log_dir)])
    monkeypatch.chdir(ROOT)
    jax_valid_hr.main()


@pytest.mark.parametrize("parser", ["hr", "hg", "hg2"])
@pytest.mark.parametrize("backbone", ["hrnet", "hourglass"])
def test_valid_hr_matches_tools_valid_hr(sets, monkeypatch, backbone, parser):
    setup, base = sets[backbone], sets["base"]
    jax_dir, port_dir = base / f"jax_{backbone}_{parser}", base / f"port_{backbone}_{parser}"
    _run_jax(setup, monkeypatch, jax_dir, parser)
    stats_ae, stats_cc = valid_hr.main([
        "--config", setup["name"], "--out_file", "eval.txt", "--device", "cpu", "--parser",
        parser, *setup["opts"], "MODEL.PRETRAINED", str(base / f"{backbone}.pt"),
        "LOG_DIR", str(port_dir)])
    assert len(stats_ae) == len(stats_cc) == 10
    for report in ("dt_ae.json", "dt_cc.json"):
        got = json.loads((port_dir / report).read_text())
        want = json.loads((jax_dir / report).read_text())
        assert len(got) == len(want) >= 4, report
        assert [a["image_id"] for a in got] == [a["image_id"] for a in want]
        np.testing.assert_allclose([a["keypoints"] for a in got],
                                   [a["keypoints"] for a in want], atol=2e-3, rtol=0,
                                   err_msg=report)
        np.testing.assert_allclose([a["score"] for a in got], [a["score"] for a in want],
                                   atol=1e-4, rtol=0, err_msg=report)
    text = (port_dir / "eval.txt").read_text()
    assert text.split("Runtime")[0] == (jax_dir / "eval.txt").read_text().split("Runtime")[0]
    assert "kpt_forward" in text


def test_maps_only_long_canvas_matches(sets):
    """TTAPipeline with maps_only on the Hourglass at scales [1.0, 0.5]
    with flip: the canvas is the largest scale's square input at input / 4,
    the reverse map ``long_with_multiscale``; scoremaps and tags within
    1e-4 of their largest."""
    setup = sets["hourglass"]
    opts = setup["opts"] + ["TEST.SCALE_FACTOR", "[1.0,0.5]", "TEST.FLIP_TEST", "True"]
    jcfg = jax_update_config_command(
        jax_update_config(jax_get_config(), f"configs/{setup['name']}.yaml"), opts)
    images = [(np.random.RandomState(i).rand(*hw, 3) * 255).astype(np.uint8)
              for i, hw in enumerate([(80, 100), (100, 72)])]
    want = JaxTTAPipeline(setup["jmodel"], setup["variables"], jcfg,
                          maps_only=True).run_batched(images, batch_size=2)
    cfg = update_config_command(load_config(setup["name"]), opts)
    model = build_ae_group_model(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(setup["variables"]["params"], {}, cfg))
    pipe = TTAPipeline(model, cfg, maps_only=True)
    got = pipe.run_batched(images, batch_size=2)
    for g, w in zip(got, want):
        assert set(g) == {"scoremaps", "tags", "base_size", "canvas_size", "scaling_type"}
        assert g["base_size"] == w["base_size"] == (512, 512)
        assert g["canvas_size"] == w["canvas_size"] == (128, 128)
        assert g["scaling_type"] == w["scaling_type"] == "long_with_multiscale"
        for key in ("scoremaps", "tags"):
            a, b = g[key].numpy(), np.asarray(w[key])
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), key
        assert g["tags"].shape[-1] == 2
    assert pipe.out_ratio == 4.0


def test_valid_hr_refuses():
    with pytest.raises(NotImplementedError, match="DATASET.SCALING_TYPE"):
        valid_hr.main(["--config", "hourglass/hg_512", "--out_file", "x.txt", "--device",
                       "cpu", "DATASET.INPUT_SIZE", "256"])
    with pytest.raises(SystemExit):
        valid_hr.main(["--config", "hrnet/w32_512", "--out_file", "x.txt", "--parser", "x"])
    with pytest.raises(NotImplementedError, match="MODEL.KP"):
        valid_hr.main(["--config", "hrnet/w32_512", "--out_file", "x.txt", "--device", "cpu",
                       "MODEL.KP", "resnet"])


def test_valid_hr_warns_on_random_weights(sets, tmp_path):
    setup = sets["hrnet"]
    with pytest.warns(UserWarning, match="evaluating random weights"):
        valid_hr.main(["--config", setup["name"], "--out_file", "eval.txt", "--device", "cpu",
                       "--max-images", "1", *setup["opts"], "TEST.FLIP_TEST", "False",
                       "LOG_DIR", str(tmp_path)])
    assert "kpt_forward" in (tmp_path / "eval.txt").read_text()


def test_valid_hr_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    """No fallback: without a card the entry point and its model factory
    raise unless given the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        valid_hr.main(["--config", "hrnet/w32_512", "--out_file", "x.txt", *OVERRIDES])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_ae_group_model(load_config("hourglass/hg_512"))
