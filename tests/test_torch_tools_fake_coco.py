"""``python -m pemp_tpu_torch.make_fake_coco`` against
``tools/make_fake_coco.py``: each flavour (coco, testdev, ochuman) writes
the same files, byte for byte (the JSON and the JPEGs)."""

import pathlib
import sys

import pytest

from pemp_tpu_torch import make_fake_coco

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("flavor,extra", [
    ("coco", []), ("coco", ["--mode", "train", "--people", "2"]), ("testdev", []),
    ("ochuman", [])])
def test_make_fake_coco_matches_tools(flavor, extra, tmp_path, monkeypatch, capsys):
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import make_fake_coco as jax_tool

    args = ["--images", "3", "--size", "80", "--flavor", flavor, *extra]
    monkeypatch.setattr(sys, "argv", ["make_fake_coco.py", "--root", str(tmp_path / "jax"),
                                      *args])
    jax_tool.main()
    make_fake_coco.main(["--root", str(tmp_path / "port"), *args])
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(want) == 4 and got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("jax", "port") == out[1]


def test_make_fake_coco_names_pil(tmp_path, monkeypatch):
    """Without PIL (the card's machine) it raises, naming PIL."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="PIL"):
        make_fake_coco.make_fake_coco(str(tmp_path), images=1, size=32)
