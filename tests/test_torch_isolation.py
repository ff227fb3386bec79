"""The port stands alone: pemp_tpu_torch and chip_smoke.py import no jax,
flax or pemp_tpu, neither at import time nor in their source."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "pemp_tpu_torch"
BLOCKED = ("jax", "flax", "pemp_tpu")

_CHILD = r"""
import importlib, pkgutil, sys

BLOCKED = {blocked!r}


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None


sys.meta_path.insert(0, Block())
import pemp_tpu_torch

names = ["pemp_tpu_torch"]
for mod in pkgutil.walk_packages(pemp_tpu_torch.__path__, "pemp_tpu_torch."):
    importlib.import_module(mod.name)
    names.append(mod.name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(len(names), leaked)
"""


def test_package_imports_with_jax_blocked():
    code = _CHILD.format(blocked=BLOCKED, smoke=str(ROOT / "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, leaked = out.stdout.split(" ", 1)
    assert leaked.strip() == "[]"
    modules = {p for p in PACKAGE.rglob("*.py")}
    assert int(count) == len(modules)     # every module of the package was imported


def test_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|pemp_tpu)(\.|\s|$)", re.M)
    files = [*PACKAGE.rglob("*.py"), ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert not offenders


def test_zoo_imports_first_with_jax_blocked():
    """The research zoo's module (models.mpn.zoo, which builds on
    models.mpn.models) imports on its own, first, with jax, flax and
    pemp_tpu blocked, and its models build."""
    code = _CHILD.split("import pemp_tpu_torch")[0].format(blocked=BLOCKED) + (
        "import pemp_tpu_torch.models.mpn.zoo as zoo\n"
        "from pemp_tpu_torch.config import small_train, zoo as preset\n"
        "from pemp_tpu_torch.models.mpn.models import get_mpn_model, mpn_cfg_from_config\n"
        "for name in ('simple', 'two_phase', 'self_attention', 'vanilla2'):\n"
        "    cfg = mpn_cfg_from_config(preset(name, small_train()).MODEL.MPN)\n"
        "    get_mpn_model({**cfg, '_PLAIN_ROUTE': 'segment'})\n"
        "print(len(zoo.ZOO), sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["10", "[]"]


TOOLS = ("overfit", "convert_checkpoint", "comp_graph_stats", "measure_deviations",
         "make_fake_coco", "draw_images")


def test_tools_run_with_jax_blocked(tmp_path):
    """The six tools import first, on their own, with jax, flax and
    pemp_tpu blocked, and ``make_fake_coco`` writes a set there."""
    code = _CHILD.split("import pemp_tpu_torch")[0].format(blocked=BLOCKED) + (
        "import importlib\n"
        f"mods = [importlib.import_module('pemp_tpu_torch.' + n) for n in {TOOLS!r}]\n"
        f"mods[4].main(['--root', {str(tmp_path)!r}, '--images', '1', '--size', '64'])\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "[]"
    assert (tmp_path / "annotations" / "person_keypoints_val2017.json").exists()
