"""Dataflow diagram rendering.

The port's copy of ``windflow_tpu/monitoring/diagram.py``.

The reference renders its PipeGraph with Graphviz — an SVG for the web
dashboard and a PDF at ``wait_end`` (``wf/pipegraph.hpp:525-534,732-734``).
Here rendering is two-tier:

- ``render_graphviz(dot_src, fmt)`` shells out to the ``dot`` binary when
  one is installed (full parity: any format Graphviz supports);
- ``stages_to_svg(stages)`` is a dependency-free layered renderer (longest
  -path layering, one column per depth) so the dashboard always has a real
  picture even on images without Graphviz.
"""

from __future__ import annotations

import html
import shutil
import subprocess
from typing import List, Optional


def render_graphviz(dot_src: str, fmt: str = "svg") -> Optional[bytes]:
    """Render through the ``dot`` binary; None when unavailable/failed."""
    exe = shutil.which("dot")
    if exe is None:
        return None
    try:
        r = subprocess.run([exe, f"-T{fmt}"], input=dot_src.encode(),
                           capture_output=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout if r.returncode == 0 else None


_BOX_W, _BOX_H, _GAP_X, _GAP_Y, _PAD = 156, 46, 64, 26, 28


def stages_to_svg(stages: List, title: str = "") -> str:
    """Layered SVG of the stage DAG (no external dependencies).

    ``stages`` is PipeGraph._stages: each has ``id``, ``describe()``,
    ``ops`` (with ``parallelism``), ``upstreams`` (edges with ``stage`` and
    ``branch``)."""
    depth = {}

    def _depth(s) -> int:
        if s.id in depth:
            return depth[s.id]
        depth[s.id] = 0  # breaks cycles defensively; DAGs have none
        d = 0
        for e in s.upstreams:
            d = max(d, _depth(e.stage) + 1)
        depth[s.id] = d
        return d

    for s in stages:
        _depth(s)
    columns: dict = {}
    for s in stages:
        columns.setdefault(depth[s.id], []).append(s)
    pos = {}
    n_rows = max((len(c) for c in columns.values()), default=1)
    for d, col in sorted(columns.items()):
        for r, s in enumerate(col):
            x = _PAD + d * (_BOX_W + _GAP_X)
            y = _PAD + r * (_BOX_H + _GAP_Y) + (
                (n_rows - len(col)) * (_BOX_H + _GAP_Y)) // 2
            pos[s.id] = (x, y)
    width = _PAD * 2 + (max(columns, default=0) + 1) * (_BOX_W + _GAP_X)
    height = _PAD * 2 + n_rows * (_BOX_H + _GAP_Y)
    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" viewBox="0 0 {width} {height}" '
        f'font-family="monospace" font-size="11">',
        '<defs><marker id="arr" markerWidth="8" markerHeight="8" refX="7" '
        'refY="3" orient="auto"><path d="M0,0 L7,3 L0,6 z" fill="#555"/>'
        "</marker></defs>",
    ]
    # escape only &<> (quote=False): quote escaping would emit &#x27;
    # numeric entities that the dashboard's reject-by-default sanitizer
    # refuses (an apostrophe is legal XML text as-is)
    if title:
        out.append(f'<text x="{_PAD}" y="16" font-size="13" '
                   f'fill="#333">{html.escape(title, quote=False)}</text>')
    for s in stages:  # edges under boxes
        x1, y1 = pos[s.id]
        for e in s.upstreams:
            x0, y0 = pos[e.stage.id]
            ax, ay = x0 + _BOX_W, y0 + _BOX_H // 2
            bx, by = x1, y1 + _BOX_H // 2
            mx = (ax + bx) / 2
            out.append(
                f'<path d="M{ax},{ay} C{mx},{ay} {mx},{by} {bx},{by}" '
                'fill="none" stroke="#555" stroke-width="1.2" '
                'marker-end="url(#arr)"/>')
            if e.branch is not None:
                out.append(f'<text x="{mx - 8}" y="{(ay + by) / 2 - 4}" '
                           f'fill="#a33">b{e.branch}</text>')
    for s in stages:
        x, y = pos[s.id]
        # truncate BEFORE escaping: clipping an entity mid-way would make
        # the standalone .svg invalid XML
        label = html.escape(s.describe()[:22], quote=False)
        par = "|".join(str(o.parallelism) for o in s.ops)
        is_dev = any(getattr(o, "is_gpu", False) for o in s.ops)
        fill = "#e8f0fe" if is_dev else "#f5f5f5"
        refused = getattr(s, "chain_refused", None)
        # chain() fallback diagnostics as a hover tooltip (the dot output
        # carries the same reason as a label line)
        tooltip = ("<title>" + html.escape(f"unchained: {refused}",
                                           quote=False) + "</title>"
                   if refused else "")
        out.append(
            f'<rect x="{x}" y="{y}" width="{_BOX_W}" height="{_BOX_H}" '
            f'rx="7" fill="{fill}" stroke="#888">{tooltip}</rect>')
        out.append(f'<text x="{x + _BOX_W / 2}" y="{y + 19}" '
                   f'text-anchor="middle">{label}</text>')
        out.append(f'<text x="{x + _BOX_W / 2}" y="{y + 36}" '
                   f'text-anchor="middle" fill="#666">({par})</text>')
    out.append("</svg>")
    return "\n".join(out)
