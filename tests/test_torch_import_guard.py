"""loco_asr_tpu_torch imports neither jax nor loco_asr_tpu: every module of
the package imports with jax blocked, loads no loco_asr_tpu module, and no
source of the port (or chip_smoke.py) names either.  Packages the GPU
machine lacks (regex, safetensors, transformers) are blocked as well: the
port may import them only inside the function that needs them."""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "loco_asr_tpu_torch")

_PROBE = """
import importlib, pkgutil, sys
for name in ("jax", "regex", "safetensors", "transformers"):
    sys.modules[name] = None
import loco_asr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(loco_asr_tpu_torch.__path__,
                                               "loco_asr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "loco_asr_tpu" or m.startswith("loco_asr_tpu.")
                     or m == "jax" or m.startswith("jax.")))
print(len(names), leaked)
assert not leaked, leaked
"""


def test_every_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


FORBIDDEN = re.compile(r"^\s*(import jax\b|from jax\b|from loco_asr_tpu[. ]|"
                       r"import loco_asr_tpu\b(?!_torch))", re.M)


def test_no_source_names_jax_or_the_jax_package():
    checked = 0
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            text = f.read()
        assert not FORBIDDEN.search(text), f"{path}: {FORBIDDEN.search(text).group(0)}"
        checked += 1
    assert checked >= 20
