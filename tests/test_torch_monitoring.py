"""The port's dashboard reports and dataflow diagram against the JAX
package's: twins of the four monitoring and diagram cases of
``test_kafka_monitoring.py``.

The JAX package's ``WF_TRACING_ENABLED`` / ``WF_DASHBOARD_*`` /
``WF_LOG_DIR`` are the port's ``PipeGraph(dashboard=..., log_dir=...)``;
each test uses a server on port 0 and a graph name of its own."""

import json
import os
import re
import time

import windflow_tpu as wj
import windflow_tpu_torch as wt
from windflow_tpu.monitoring.monitor import _safe_diagram as safe_j
from windflow_tpu_torch.monitoring.monitor import (MonitoringServer,
                                                   _safe_diagram)
from common import GlobalSum, make_ingress_source, make_sum_sink
from torch_waits import run_bounded


def test_monitoring_reports_over_tcp(tmp_path):
    server = MonitoringServer()
    log_dir = str(tmp_path / "logs")
    acc = GlobalSum()
    g = wt.PipeGraph("traced_t", device="cpu",
                     dashboard=(server.host, server.port), log_dir=log_dir)
    g.add_source(wt.Source_Builder(make_ingress_source(2, 50)).build()) \
        .add(wt.Map_Builder(lambda t: t).build()) \
        .add_sink(wt.Sink_Builder(make_sum_sink(acc)).build())
    try:
        run_bounded(g)
        deadline = time.time() + 5
        while time.time() < deadline:
            snap = server.snapshot()
            if "traced_t" in snap["reports"] \
                    and "traced_t" in snap["diagrams"]:
                break
            time.sleep(0.05)
        snap = server.snapshot()
    finally:
        server.close()
    assert "->" in snap["diagrams"]["traced_t"]
    stats = snap["reports"]["traced_t"]
    assert stats["PipeGraph_name"] == "traced_t"
    assert any(o["kind"] == "Map" for o in stats["Operators"])
    # wait_end with a dashboard dumps the stats and the diagram
    dumped = json.load(open(os.path.join(log_dir, "traced_t_stats.json")))
    assert dumped["Threads"] == g.get_num_threads()
    assert "->" in open(os.path.join(log_dir,
                                     "traced_t_diagram.dot")).read()


def _split_graph(pkg, name):
    kw = {"device": "cpu"} if pkg is wt else {}
    g = pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.INGRESS_TIME, **kw)

    def src(shipper):
        for i in range(5):
            shipper.push({"v": i})

    mp = g.add_source(pkg.Source_Builder(src).build())
    mp.split(lambda t: t["v"] % 2, 2)
    mp.select(0).add_sink(pkg.Sink_Builder(lambda t: None).build())
    b1 = mp.select(1)
    b1.add(pkg.Map_Builder(lambda t: t).build())
    b1.add_sink(pkg.Sink_Builder(lambda t: None).build())
    run_bounded(g)
    return g


def _renumbered(dot: str) -> str:
    """Stage ids count across every graph of a process: number them in
    order of appearance."""
    ids = {}
    return re.sub(r"\bs(\d+)\b",
                  lambda m: "s%d" % ids.setdefault(m.group(1), len(ids)),
                  dot)


def test_diagram_svg_render_matches_jax(tmp_path):
    """A split graph: the built-in SVG renderer draws the same boxes and
    branch labels as the JAX package's, the dot sources are equal, and
    ``dump_stats`` writes an SVG (Graphviz's when a ``dot`` binary
    exists)."""
    g = _split_graph(wt, "svg_graph")
    gj = _split_graph(wj, "svg_graph")
    svg = g.to_svg()
    assert svg.startswith("<svg") and svg.count("<rect") == 4
    assert "b1" in svg
    assert svg == gj.to_svg()
    assert _renumbered(g.to_dot()) == _renumbered(gj.to_dot())
    d = tmp_path / "log"
    g.dump_stats(str(d))
    svg_file = d / "svg_graph_diagram.svg"
    assert svg_file.exists() and b"<svg" in svg_file.read_bytes()[:512]


def test_dashboard_rejects_active_svg_content():
    bad = ['<svg><script>fetch("x")</script></svg>',
           '<svg onload="alert(1)"><rect/></svg>',
           '<svg/onload=alert(1)><rect/></svg>',
           '<svg\tonerror=x><rect/></svg>',
           '<svg><foreignObject><body>x</body></foreignObject></svg>',
           '<svg><a href="javascript:alert(1)">x</a></svg>',
           '<svg><a href="java&#115;cript:alert(1)">x</a></svg>',
           '<svg><a href="  data:text/html,x">x</a></svg>',
           '<div>not svg</div>']
    for svg in bad:
        out = _safe_diagram(svg, "digraph g { a -> b }")
        assert out == safe_j(svg, "digraph g { a -> b }")
        assert "<script" not in out and "onload" not in out, svg
        assert out.startswith("<pre>") and "a -&gt; b" in out
    ok = '<svg xmlns="http://www.w3.org/2000/svg"><rect width="5"/></svg>'
    assert _safe_diagram(ok, "") == ok


def test_sanitizer_accepts_own_renderer_output():
    g = wt.PipeGraph("bob's descriptor graph", device="cpu")

    def src(shipper):
        shipper.push({"v": 1})

    g.add_source(wt.Source_Builder(src).with_name("bob's source").build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).with_name("descriptor")
                  .build())
    run_bounded(g)
    svg = g.to_svg()
    assert _safe_diagram(svg, "dot") == svg
