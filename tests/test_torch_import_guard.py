"""loco_asr_tpu_torch imports neither jax nor loco_asr_tpu: every module of
the package (the examples included) imports with jax blocked, loads no
loco_asr_tpu module, and no source of the port (or chip_smoke.py) names
either, in an import or in a command it would run (``-m
loco_asr_tpu.pipelines...``, as a wav.scp pipe is).  Packages the GPU
machine lacks (regex, safetensors, transformers) are blocked as well: the
port may import them only inside the function that needs them; orbax,
tensorstore and zstandard it never imports (its orbax reader is its own).
The wav.scp pipe CLI, ``sph_decode``, stays light: its process loads no
torch."""

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
for name in ("jax", "regex", "safetensors", "transformers", "orbax", "tensorstore",
             "zstandard"):
    sys.modules[name] = None
import loco_asr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(loco_asr_tpu_torch.__path__,
                                               "loco_asr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "loco_asr_tpu" or m.startswith("loco_asr_tpu.")
                     or m == "jax" or m.startswith("jax.")))
print(len(names), leaked, " ".join(names))
assert not leaked, leaked
"""


def test_every_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20
    assert "loco_asr_tpu_torch.examples.04_checkpoint_mapping" in proc.stdout


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


NEVER = re.compile(r"^\s*(import|from)\s+(orbax|tensorstore|zstandard)\b", re.M)


def test_no_source_imports_orbax_tensorstore_or_zstandard():
    checked = 0
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            text = f.read()
        assert not NEVER.search(text), f"{path}: {NEVER.search(text).group(0)}"
        checked += 1
    assert checked >= 20
    assert NEVER.search("    import zstandard\n") and NEVER.search("from orbax import x")


# ops/ importing the parallel layer ("from ..parallel", "loco_asr_tpu_torch.parallel")
OPS_TO_PARALLEL = re.compile(r"^\s*(from|import)\s+(\.\.parallel|loco_asr_tpu_torch\.parallel)\b",
                             re.M)


def test_ops_do_not_import_the_parallel_layer():
    """The layers know nothing of the mesh: ``parallel.partition`` gives
    sharded modules their sharded subclasses instead."""
    checked = 0
    for path in _sources():
        if os.sep + "ops" + os.sep not in path:
            continue
        with open(path, encoding="utf-8") as f:
            text = f.read()
        assert not OPS_TO_PARALLEL.search(text), path
        checked += 1
    assert checked >= 10
    assert OPS_TO_PARALLEL.search("    from ..parallel import tensor_parallel\n")


# a command that runs a module of the JAX package: "python -m loco_asr_tpu.x"
JAX_COMMAND = re.compile(r"-m\s+loco_asr_tpu(?![_\w])")


def test_no_source_runs_a_module_of_the_jax_package():
    checked = 0
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            text = f.read()
        hit = JAX_COMMAND.search(text)
        assert not hit, f"{path}: {text[max(0, hit.start() - 40):hit.end() + 40]!r}"
        checked += 1
    assert checked >= 20
    assert JAX_COMMAND.search("python -m loco_asr_tpu.pipelines.sph_decode -c 1 a.sph |")
    assert not JAX_COMMAND.search("python -m loco_asr_tpu_torch.pipelines.sph_decode -c 1 a.sph |")


_LIGHT_PROBE = """
import runpy, sys
for name in ("torch", "jax", "loco_asr_tpu"):
    sys.modules[name] = None
sys.argv = ["sph_decode", "--help"]
try:
    runpy.run_module("loco_asr_tpu_torch.pipelines.sph_decode", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
from loco_asr_tpu_torch import native
from loco_asr_tpu_torch.ops import audio_io, shorten
print("light")
"""


def test_sph_decode_and_its_readers_import_without_torch():
    proc = subprocess.run([sys.executable, "-c", _LIGHT_PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "light"
