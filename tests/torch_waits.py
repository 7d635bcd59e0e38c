"""Bounded waits for the port's tests: a graph run, a thread join or a
commit wait that outlives its limit fails the test instead of holding the
whole test run.

``run_bounded`` and ``wait_end_bounded`` serve both packages (the JAX
package's ``run`` and ``wait_end`` take no limit): the call goes on a
helper thread joined with a timeout, and its exception, if any, is raised
again on the test's thread."""

from __future__ import annotations

import threading

import pytest

RUN_TIMEOUT_S = 120.0
JOIN_TIMEOUT_S = 30.0


def join_bounded(thread: threading.Thread,
                 timeout_s: float = JOIN_TIMEOUT_S, what: str = "") -> None:
    """Join ``thread``; fail the test if it is still alive after
    ``timeout_s`` seconds."""
    thread.join(timeout_s)
    if thread.is_alive():
        pytest.fail(f"{what or thread.name} still running after "
                    f"{timeout_s:.0f}s")


def call_bounded(fn, timeout_s: float, what: str) -> None:
    """``fn()`` on a helper thread within ``timeout_s`` seconds."""
    box = {}

    def body():
        try:
            fn()
        except BaseException as e:  # re-raised on the test's thread
            box["err"] = e

    t = threading.Thread(target=body, daemon=True, name=f"bounded/{what}")
    t.start()
    join_bounded(t, timeout_s, what)
    if "err" in box:
        raise box["err"]


def run_bounded(graph, restore_from=None,
                timeout_s: float = RUN_TIMEOUT_S) -> None:
    """``graph.run(restore_from=...)`` within ``timeout_s`` seconds."""
    call_bounded((lambda: graph.run()) if restore_from is None
                 else (lambda: graph.run(restore_from=restore_from)),
                 timeout_s, f"graph {graph.name!r}")


def wait_end_bounded(graph, timeout_s: float = RUN_TIMEOUT_S) -> None:
    """``graph.wait_end()`` of a started graph within ``timeout_s``."""
    call_bounded(graph.wait_end, timeout_s, f"graph {graph.name!r}")
