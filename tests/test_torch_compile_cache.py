"""``PipeGraph.with_compile_cache`` on the CPU: where ``kernels/build.py``
builds and looks up the kernel libraries with and without a cache, the
refusals (after ``start()``; a directory that cannot be created), the
process-wide scope, and a build, a reuse and a failed build under a cache
directory with a stand-in for ``nvcc`` (a script that links a stub shared
library with g++: the CUDA build itself is checked on the card only, by
``chip_smoke.py``'s ``observe`` part ``compile_cache``).

The cache setting is process-wide and xdist runs other port files in the
same worker, so a fixture restores it after every test."""

import stat
import textwrap
import types
import uuid

import pytest
import torch

import windflow_tpu_torch as wt
from windflow_tpu_torch.kernels import build


@pytest.fixture(autouse=True)
def restore_cache_dir():
    saved = build._cache_dir
    yield
    build.set_cache_dir(None if saved is None else str(saved))


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in compiler on ``build.nvcc_path``: it links a stub
    library at the ``-o`` path (exit status 1 after ``failing()``) and
    logs each call."""
    log = tmp_path / "nvcc_calls"
    state = types.SimpleNamespace()
    script = tmp_path / "nvcc"
    script.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        echo "$@" >> {log}
        [ -e {tmp_path}/fail ] && {{ echo "error: stub" >&2; exit 1; }}
        out=""; prev=""
        for a in "$@"; do
          [ "$prev" = "-o" ] && out="$a"; prev="$a"
        done
        echo 'int wf_stub(void) {{ return 7; }}' > "$out.c"
        exec g++ -shared -fPIC -x c -o "$out" "$out.c"
        """))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(script))

    def calls():
        return len(log.read_text().splitlines()) if log.exists() else 0

    def failing(on=True):
        flag = tmp_path / "fail"
        flag.touch() if on else flag.unlink(missing_ok=True)

    state.calls, state.failing = calls, failing
    return state


def _forget(name):
    """Unload library ``name`` from the process registry, as a fresh
    process would start."""
    with build._lock:
        build._libs.pop(name, None)
        build.BUILD_INFO.pop(name, None)


def _ran_graph(setup=None, name="cc"):
    g = wt.PipeGraph(name, device="cpu")
    if setup is not None:
        setup(g)
    g.add_source(wt.Source_Builder(
        lambda sh: [sh.push({"v": i}) for i in range(3)]).build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).build())
    g.run()
    return g


def test_with_compile_cache_takes_effect_at_start(tmp_path):
    """Without a cache the builds go to ``build/kernels/``; recording the
    directory changes nothing; ``start()`` creates it and points the
    builds at it."""
    build.set_cache_dir(None)
    assert build.build_dir() == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    d = tmp_path / "a" / "cache"
    g = wt.PipeGraph("cc_start", device="cpu").with_compile_cache(str(d))
    assert build.build_dir() == build.BUILD_DIR and not d.exists()
    g.add_source(wt.Source_Builder(lambda sh: sh.push({"v": 1})).build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).build())
    g.run()
    assert d.is_dir() and build.build_dir() == d


def test_with_compile_cache_after_start_is_refused(tmp_path):
    g = _ran_graph(name="cc_late")
    with pytest.raises(wt.WindFlowError, match="after start"):
        g.with_compile_cache(str(tmp_path / "late"))


def test_uncreatable_cache_dir_raises_at_start(tmp_path):
    """A directory that cannot be created raises ``WindFlowError`` at
    ``start()``, before any worker runs, and the builds stay where they
    were: no quiet fallback."""
    build.set_cache_dir(None)
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    seen = []
    g = wt.PipeGraph("cc_bad", device="cpu").with_compile_cache(
        str(blocker / "cache"))
    g.add_source(wt.Source_Builder(lambda sh: seen.append(1)).build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).build())
    with pytest.raises(wt.WindFlowError, match="cannot create"):
        g.start()
    assert not seen and build.build_dir() == build.BUILD_DIR


def test_cache_is_process_wide(tmp_path):
    """As the JAX package's ``jax.config`` cache: a later graph without
    ``with_compile_cache`` builds in the same directory."""
    d = tmp_path / "shared"
    _ran_graph(lambda g: g.with_compile_cache(str(d)), name="cc_a")
    _ran_graph(name="cc_b")
    assert build.build_dir() == d
    d2 = tmp_path / "other"
    _ran_graph(lambda g: g.with_compile_cache(d2), name="cc_c")
    assert build.build_dir() == d2


def test_build_goes_to_the_cache_and_a_fresh_load_reuses_it(tmp_path,
                                                            fake_nvcc):
    """A library is built into the cache directory once; a process that
    has not loaded it (here: the registry entry dropped) loads that build
    without the compiler (``BUILD_INFO`` seconds 0); another directory
    builds anew. Nothing lands in ``build/kernels/``."""
    tag = f"cc-{uuid.uuid4().hex[:8]}"
    name = f"forest_rebuild-{tag}"
    text = f"// {tag}\n"
    d1, d2 = tmp_path / "c1", tmp_path / "c2"
    try:
        build.set_cache_dir(str(d1))
        lib = build.load_generated(tag, text)
        assert lib.wf_stub() == 7 and fake_nvcc.calls() == 1
        assert build.BUILD_INFO[name]["seconds"] > 0
        (so,) = d1.glob(f"{name}-*.so")
        assert (d1 / so.name.replace(".so", ".cu")).read_text() == text
        _forget(name)
        build.load_generated(tag, text)
        assert fake_nvcc.calls() == 1
        assert build.BUILD_INFO[name]["seconds"] == 0.0
        _forget(name)
        build.set_cache_dir(str(d2))
        build.load_generated(tag, text)
        assert fake_nvcc.calls() == 2 and list(d2.glob(f"{name}-*.so"))
        assert not list(build.BUILD_DIR.glob(f"{name}-*"))
    finally:
        _forget(name)


def test_failed_build_under_the_cache_raises(tmp_path, fake_nvcc):
    """A compiler failure raises with its log and leaves no library in
    the cache nor in ``build/kernels/``."""
    tag = f"cc-{uuid.uuid4().hex[:8]}"
    name = f"forest_rebuild-{tag}"
    d = tmp_path / "c"
    build.set_cache_dir(str(d))
    fake_nvcc.failing()
    try:
        with pytest.raises(wt.WindFlowError, match=r"nvcc failed(.|\n)*error: stub"):
            build.load_generated(tag, f"// {tag}\n")
        assert not list(d.glob("*.so")) and name not in build._libs
        assert not list(build.BUILD_DIR.glob(f"{name}-*"))
    finally:
        _forget(name)


def test_compile_attribution_says_cached_for_a_cache_hit(tmp_path,
                                                         fake_nvcc):
    """K1's compile attribution (``note_k1_use``): the replica whose load
    ran the compiler records ``<library>:nvcc``, one whose load found the
    cached build ``<library>:cached``; a second use is a cache hit of the
    replica, as before."""
    from windflow_tpu_torch.gpu.ffat_gpu import note_k1_use
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    from windflow_tpu_torch.monitoring.stats import StatsRecord
    build.set_cache_dir(str(tmp_path / "c"))
    salt = uuid.uuid4().int % 1000 + 2

    def comb(a, b):
        return {"n": a["n"] + b["n"] * salt}

    dtypes = {"n": torch.int32}
    v = fr.variant(comb, dtypes)
    try:
        sigs = []
        for _ in range(2):
            _forget(v.library)
            rep = types.SimpleNamespace(stats=StatsRecord("w"),
                                        op=types.SimpleNamespace(combine=comb))
            note_k1_use(rep, dtypes)
            note_k1_use(rep, dtypes)
            assert rep.stats.compile_count == 1
            assert rep.stats.compile_cache_hits == 1
            sigs.append(rep.stats.compile_last_signature)
        assert sigs == [f"{v.library}:nvcc", f"{v.library}:cached"]
        assert fake_nvcc.calls() == 1
    finally:
        _forget(v.library)
