"""The port stands alone: no module of ``windflow_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or any ``windflow_tpu`` module, and a
graph with no device refuses to run without a CUDA card.

The import checks run in a subprocess: this test process already holds
jax (``tests/conftest.py`` imports ``windflow_tpu.mesh``)."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import windflow_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(windflow_tpu_torch.__path__,
                                              "windflow_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401  (its main() only runs as a script)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "windflow_tpu" or m.startswith("windflow_tpu."))
print(len(mods), "BAD" if bad else "OK", bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT)],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n, verdict, *_ = out.stdout.split()
    assert int(n) >= 30 and verdict == "OK", out.stdout


_ALONE = r"""
import importlib, sys
sys.path.insert(0, {root!r})
importlib.import_module({mod!r})
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "windflow_tpu" or m.startswith("windflow_tpu."))
print("BAD" if bad else "OK", bad)
"""


@pytest.mark.parametrize("mod", [
    "windflow_tpu_torch.state.tiered", "windflow_tpu_torch.persistent.cache",
    "windflow_tpu_torch.persistent.db_handle", "windflow_tpu_torch.pytree",
    "windflow_tpu_torch.convert"])
def test_keyed_state_modules_import_alone_without_jax(mod):
    """The keyed-state plane's host modules (JAX-free copies of the JAX
    package's ``state/`` and ``persistent/``) import on their own, in a
    fresh interpreter, without pulling in jax or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c",
                          _ALONE.format(root=ROOT, mod=mod)],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "OK", out.stdout


@pytest.mark.parametrize("mod", [
    "windflow_tpu_torch.checkpoint", "windflow_tpu_torch.checkpoint.store",
    "windflow_tpu_torch.checkpoint.coordinator"])
def test_checkpoint_modules_import_alone_without_jax(mod):
    """The checkpoint plane (the port's own copies of the JAX package's
    JAX-free ``checkpoint/`` modules) imports on its own, in a fresh
    interpreter, without pulling in jax or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c",
                          _ALONE.format(root=ROOT, mod=mod)],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "OK", out.stdout


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_file_names_jax_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "windflow_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "windflow_tpu"), (path, mod)


def test_pipegraph_without_device_needs_cuda(monkeypatch):
    import windflow_tpu_torch as wt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(wt.WindFlowError):
        wt.PipeGraph()
    with pytest.raises(wt.WindFlowError):
        wt.PipeGraph(device="cuda")
    assert wt.PipeGraph(device="cpu").device.type == "cpu"
