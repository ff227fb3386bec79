"""``python -m pemp_tpu_torch.comp_graph_stats`` and ``python -m
pemp_tpu_torch.measure_deviations`` against ``tools/comp_graph_stats.py``
and ``tools/measure_deviations.py`` on a 2-image fake set: the same printed
lines, rows and reports. The JAX side is pinned to the asymmetric kNN
layout (``TPU.MSG_PASS pallas``; its ``auto`` builds the symmetric one off
a TPU), the port's default."""

import json
import pathlib
import sys

import pytest

from pemp_tpu_torch import comp_graph_stats, make_fake_coco, measure_deviations

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def fake_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("stats") / "coco"
    make_fake_coco.make_fake_coco(str(root), images=2, size=128)
    return root


def _printed(capsys):
    return capsys.readouterr().out.splitlines()


def test_comp_graph_stats_matches_tools(fake_set, monkeypatch, capsys):
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    monkeypatch.chdir(ROOT)
    import comp_graph_stats as jax_tool

    opts = ["--config", "test/tiny", "--max-images", "2", "DATASET.ROOT", str(fake_set)]
    monkeypatch.setattr(sys, "argv", ["comp_graph_stats.py", *opts, "TPU.MSG_PASS", "pallas"])
    capsys.readouterr()
    jax_tool.main()
    want = _printed(capsys)
    got = comp_graph_stats.main([*opts, "--device", "cpu"])
    assert _printed(capsys) == got == want
    assert len(want) == 6 and want[0] == "over 2 images:"
    assert not want[1].startswith("detections/img: mean=0.00")


def test_measure_deviations_matches_tools(fake_set, tmp_path, monkeypatch, capsys):
    """The four settings' rows and each setting's report file."""
    import pemp_tpu.config

    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import measure_deviations as jax_tool

    get_config = pemp_tpu.config.get_config

    def pinned():
        cfg = get_config()
        cfg.defrost()
        cfg.TPU.MSG_PASS = "pallas"
        cfg.freeze()
        return cfg

    monkeypatch.setattr(pemp_tpu.config, "get_config", pinned)
    args = ["--root", str(fake_set), "--max-images", "2", "--input-size", "128"]
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["measure_deviations.py", *args])
    capsys.readouterr()
    want = jax_tool.main()
    want_lines = [line for line in _printed(capsys) if line.startswith("{")]
    monkeypatch.chdir(tmp_path / "port")
    got = measure_deviations.main([*args, "--device", "cpu"])
    got_lines = [line for line in _printed(capsys) if line.startswith("{")]
    assert got == want and got_lines == want_lines
    assert [json.loads(line) for line in got_lines] == got
    assert [(r["cap_in"], r["k"]) for r in got] == [(32, 40), (-1, 40), (32, 80), (-1, 80)]
    assert got[0]["AP"] > 0.5 and got[0]["mean_edges"] > 0
    for r in got:
        name = f"deviation_{r['cap_in']}_{r['k']}.txt"
        assert ((tmp_path / "port" / "tmp" / name).read_text()
                == (tmp_path / "jax" / "tmp" / name).read_text())
