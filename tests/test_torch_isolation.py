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
    # 74 modules since sinks/ and the persistent operators
    assert int(n) >= 74 and verdict == "OK", out.stdout


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
    "windflow_tpu_torch.checkpoint.coordinator",
    "windflow_tpu_torch.checkpoint.delta", "windflow_tpu_torch.recycling"])
def test_checkpoint_modules_import_alone_without_jax(mod):
    """The checkpoint plane and staging recycling (the port's own copies
    of the JAX package's JAX-free ``checkpoint/`` modules and
    ``recycling.py``) import on their own, in a fresh interpreter, without
    pulling in jax or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c",
                          _ALONE.format(root=ROOT, mod=mod)],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "OK", out.stdout


@pytest.mark.parametrize("mod", [
    "windflow_tpu_torch.scaling", "windflow_tpu_torch.scaling.repartition",
    "windflow_tpu_torch.scaling.controller",
    "windflow_tpu_torch.scaling.autoscaler",
    "windflow_tpu_torch.supervision",
    "windflow_tpu_torch.supervision.errors",
    "windflow_tpu_torch.supervision.policy",
    "windflow_tpu_torch.supervision.health",
    "windflow_tpu_torch.supervision.supervisor"])
def test_rescale_and_supervision_modules_import_alone_without_jax(mod):
    """The rescale and supervision planes (the port's own copies of the
    JAX package's JAX-free ``scaling/`` and ``supervision/`` modules)
    import on their own, in a fresh interpreter, without pulling in jax
    or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c",
                          _ALONE.format(root=ROOT, mod=mod)],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "OK", out.stdout


@pytest.mark.parametrize("mod", [
    "windflow_tpu_torch.mesh", "windflow_tpu_torch.mesh.core",
    "windflow_tpu_torch.mesh.ffat_mesh", "windflow_tpu_torch.mesh.ops_mesh"])
def test_mesh_modules_import_alone_without_jax(mod):
    """The mesh plane (the port's own ``mesh/``: no JAX collectives, the
    shards stacked on one device) imports on its own, in a fresh
    interpreter, without pulling in jax or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c",
                          _ALONE.format(root=ROOT, mod=mod)],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "OK", out.stdout


@pytest.mark.parametrize("mod", [
    "windflow_tpu_torch.operators.windows",
    "windflow_tpu_torch.operators.window_engine",
    "windflow_tpu_torch.operators.ffat", "windflow_tpu_torch.operators.flatfat",
    "windflow_tpu_torch.operators.join", "windflow_tpu_torch.kafka",
    "windflow_tpu_torch.kafka.connectors",
    "windflow_tpu_torch.kafka.builders_kafka",
    "windflow_tpu_torch.runtime.collectors"])
def test_host_window_join_and_kafka_modules_import_alone_without_jax(mod):
    """The host window engines, the interval join, the collectors and the
    Kafka connectors (the port's own copies of the JAX package's JAX-free
    modules) import on their own, in a fresh interpreter, without pulling
    in jax or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c",
                          _ALONE.format(root=ROOT, mod=mod)],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "OK", out.stdout


@pytest.mark.parametrize("mod", [
    "windflow_tpu_torch.sinks", "windflow_tpu_torch.sinks.transactional",
    "windflow_tpu_torch.persistent",
    "windflow_tpu_torch.persistent.p_basic_ops",
    "windflow_tpu_torch.persistent.p_keyed_windows",
    "windflow_tpu_torch.persistent.builders_persistent",
    "windflow_tpu_torch.operators.source",
    "windflow_tpu_torch.operators.basic_ops"])
def test_exactly_once_and_persistent_modules_import_alone_without_jax(mod):
    """The exactly-once sink plane, the persistent operators and the
    replayable columnar ingest (the port's own copies of the JAX
    package's JAX-free ``sinks/``, ``persistent/`` and source modules)
    import on their own, in a fresh interpreter, without pulling in jax
    or the JAX package; ``sinks.transactional`` reads segments the JAX
    package staged without importing it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c",
                          _ALONE.format(root=ROOT, mod=mod)],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "OK", out.stdout


@pytest.mark.parametrize("mod", [
    "windflow_tpu_torch.native", "windflow_tpu_torch.monitoring.histogram",
    "windflow_tpu_torch.monitoring.tracing",
    "windflow_tpu_torch.monitoring.flightrec",
    "windflow_tpu_torch.monitoring.diagram",
    "windflow_tpu_torch.monitoring.doctor",
    "windflow_tpu_torch.monitoring.monitor",
    "windflow_tpu_torch.monitoring.webclient",
    "windflow_tpu_torch.overload", "windflow_tpu_torch.overload.admission",
    "windflow_tpu_torch.overload.governor",
    "windflow_tpu_torch.parallel.mesh"])
def test_monitoring_overload_and_native_modules_import_alone_without_jax(
        mod):
    """The native runtime, the monitoring plane, the overload plane and
    the parallel shim (the port's own copies of the JAX package's
    JAX-free ``native/``, ``monitoring/``, ``overload/`` and
    ``parallel/`` modules) import on their own, in a fresh interpreter,
    without pulling in jax or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c",
                          _ALONE.format(root=ROOT, mod=mod)],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "OK", out.stdout


def test_native_runtime_source_is_the_ports_own():
    """The port builds its own ``native/wfruntime.cpp`` (not the JAX
    package's file) and never builds next to it."""
    import windflow_tpu_torch.native as nat
    own = os.path.join(ROOT, "windflow_tpu_torch", "native",
                       "wfruntime.cpp")
    jax_src = os.path.join(ROOT, "windflow_tpu", "native", "wfruntime.cpp")
    assert str(nat.SRC) == own and os.path.exists(own)
    assert open(own).read() != open(jax_src).read()
    assert str(nat.BUILD_DIR).startswith(os.path.join(ROOT, "build"))


_CLIENTS_PROBE = r"""
import importlib, pkgutil, sys
tried = []


class Spy:
    # records every attempt to import a Kafka client library
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("confluent_kafka", "kafka"):
            tried.append(name)
        return None


sys.meta_path.insert(0, Spy())
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import windflow_tpu_torch
for m in pkgutil.walk_packages(windflow_tpu_torch.__path__,
                               "windflow_tpu_torch."):
    importlib.import_module(m.name)
import torch_kafka_clients  # noqa: F401
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "windflow_tpu" or m.startswith("windflow_tpu."))
print("BAD" if bad or tried else "OK", bad, tried)
"""


def test_kafka_fakes_import_no_jax_and_the_port_imports_no_client():
    """``tests/torch_kafka_clients.py`` (the fake client modules that
    ``chip_smoke.py`` also uses) imports neither jax nor the JAX package,
    and importing every module of the port tries to import neither
    ``confluent_kafka`` nor ``kafka``: a client is imported only when a
    real broker is used."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _CLIENTS_PROBE.format(
            root=ROOT, tests=os.path.join(ROOT, "tests"))],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
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
