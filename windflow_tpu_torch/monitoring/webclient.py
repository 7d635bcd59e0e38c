"""Interactive dashboard web client (single file, no build step).

The port's copy of ``windflow_tpu/monitoring/webclient.py``.

The reference ships a React app (``dashboard/web_client/``, 36 source
files) talking to a Spring REST server. The equivalent here is a
dependency-free client served by ``MonitoringServer.serve_http``: it polls
``/json`` once per second and renders, without page reloads,

- a graph selector with live mode/threads/dropped badges,
- per-operator tables (parallelism, in/out, ignored, tuples/s, service
  time, device programs, staging pool hits) that update in place,
- a canvas sparkline of each graph's total throughput history (kept
  client-side, 120 samples),
- a second sparkline of the worst sink-side p99 end-to-end latency
  (populated when latency tracing is sampling — PipeGraph(latency_sample=...) /
  with_latency_tracing), plus svc/e2e p99 latency columns,
- rescale-event markers on the p99 sparkline (dashed ticks where
  ``Rescale_events`` advanced) plus a rescale badge with the last
  operator/parallelism/pause — the per-operator ``par`` column is live,
  so a scaling action is visible the moment it lands,
- a degraded badge while the recovery plane runs with excluded devices
  (device-loss failover), with the last restore's ladder depth,
- the dataflow SVG diagram (server-sanitized),
- per-replica drill-down on click,
- event-time health: a watermark-lag column + late-records column with a
  drop badge, late-drop markers on the p99 sparkline (orange ticks where
  ``Late_dropped`` advanced), and a pipeline-doctor verdict banner
  (ranked bottleneck attribution from the server-side diagnosis that
  rides in every ``/json`` snapshot).
"""

CLIENT_HTML = r"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>windflow_tpu_torch dashboard</title>
<style>
 body { font-family: monospace; margin: 18px; background:#fafafa; }
 h1 { font-size: 18px; }
 .badge { display:inline-block; padding:2px 8px; border-radius:10px;
          background:#e8f0fe; margin-right:6px; font-size:11px; }
 .badge.warn { background:#fde8e8; }
 table { border-collapse: collapse; margin: 8px 0; }
 th, td { border: 1px solid #ccc; padding: 3px 8px; font-size: 12px;
          text-align: right; }
 th { background:#f0f0f0; } td.l, th.l { text-align:left; }
 .tabs button { margin-right:4px; font-family:monospace; }
 .tabs button.active { background:#2b6cb0; color:#fff; }
 canvas { border:1px solid #ddd; background:#fff; }
 #diagram svg { max-width:100%; }
 tr.rep { background:#f7fbff; font-size:11px; }
 .muted { color:#777; font-size:11px; }
 #doctor { margin:6px 0; padding:5px 10px; border-radius:6px;
           font-size:12px; background:#e6f4ea; display:none; }
 #doctor.sick { background:#fdecd2; }
</style>
</head>
<body>
<h1>windflow_tpu_torch dashboard <span id="conn" class="muted"></span></h1>
<div class="tabs" id="tabs"></div>
<div id="badges"></div>
<div id="doctor"></div>
<canvas id="spark" width="720" height="80"></canvas>
<div class="muted">total tuples/s (last 120 s)</div>
<canvas id="sparklat" width="720" height="60"></canvas>
<div class="muted">worst p99 end-to-end latency µs (sampled tracing;
flat at 0 when sampling is off) — ⇅ rescale, ✕ late drops</div>
<div id="ops"></div>
<details open id="diagram"><summary>dataflow graph</summary></details>
<script>
"use strict";
let current = null;            // selected graph
let graphList = [], opNames = [];  // index -> name (XSS-safe handlers)
const hist = {};               // graph -> [throughput samples]
const lhist = {};              // graph -> [p99 e2e latency samples]
const rmark = {};              // graph -> [bool: rescale at this sample]
const rseen = {};              // graph -> last Rescale_events count
const dmark = {};              // graph -> [bool: late drops this sample]
const dseen = {};              // graph -> last Late_dropped total
const open = new Set();        // operator names with replica drill-down
function fmt(n){ return (n===undefined||n===null)?"":
  Number(n).toLocaleString("en-US",{maximumFractionDigits:1}); }
function el(id){ return document.getElementById(id); }
// every server-supplied string is untrusted (monitoring TCP port is
// unauthenticated): escape before any innerHTML interpolation
function esc(s){ return String(s).replace(/[&<>"']/g, c =>
  ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c])); }
function render(snap){
  const graphs = Object.keys(snap.reports);
  if (graphs.length && (current===null || !graphs.includes(current)))
    current = graphs[0];
  graphList = graphs;
  el("tabs").innerHTML = graphs.map((g,i) =>
    `<button class="${g===current?'active':''}" onclick="pick(${i})">`+
    `${esc(g)}</button>`).join("");
  if (!current) { el("ops").innerHTML = "<p class=muted>waiting for "+
    "reports…</p>"; return; }
  const st = snap.reports[current];
  el("badges").innerHTML =
    `<span class=badge>${esc(st.Mode)}</span>`+
    `<span class=badge>${esc(st.Time_policy)}</span>`+
    `<span class=badge>threads ${st.Threads|0}</span>`+
    `<span class="badge ${st.Dropped_tuples? 'warn':''}">dropped `+
    `${fmt(st.Dropped_tuples)}</span>`+
    (st.Worker_errors? `<span class="badge warn">crashed `+
    `${Object.keys(st.Worker_errors).length} worker(s)</span>` : "");
  let total = 0, worstP99 = 0, rows = [];
  let tierHot = 0, tierCold = 0, tierMiss = 0, tierOn = false;
  let lateRecs = 0, lateDrop = 0, worstWmLag = 0;
  opNames = (st.Operators||[]).map(o=>o.name);
  (st.Operators||[]).forEach((o, oi) => {
    const r = o.replicas, s = (k)=>r.reduce((a,x)=>a+(x[k]||0),0);
    const m = (k)=>Math.max(...r.map(x=>x[k]||0));
    const tput = s("Throughput_tuples_sec"); total += tput;
    if (r.some(x=>"Tier_hot_keys" in x)) {
      tierOn = true; tierHot += s("Tier_hot_keys");
      tierCold += s("Tier_cold_keys");
      tierMiss = Math.max(tierMiss, m("Tier_miss_rate"));
    }
    worstP99 = Math.max(worstP99, m("Latency_e2e_p99_usec"));
    const wmLagMs = m("Watermark_lag_usec")/1000;
    // idle replicas park their watermark by design; only flag lag where
    // traffic is flowing (mirrors the doctor's stall condition)
    if (!r.every(x=>x.Watermark_idle)) worstWmLag =
      Math.max(worstWmLag, wmLagMs);
    lateRecs += s("Late_records"); lateDrop += s("Late_dropped");
    rows.push(`<tr onclick="tog(${oi})"><td class=l>${esc(o.name)}</td>`+
      `<td class=l>${esc(o.kind)}</td><td>${o.parallelism|0}</td>`+
      `<td>${fmt(s("Inputs_received"))}</td>`+
      `<td>${fmt(s("Outputs_sent"))}</td>`+
      `<td>${fmt(s("Inputs_ignored"))}</td><td>${fmt(tput)}</td>`+
      `<td>${fmt(m("Service_time_usec"))}</td>`+
      `<td>${fmt(m("Latency_service_p99_usec"))}</td>`+
      `<td>${fmt(m("Latency_e2e_p99_usec"))}</td>`+
      `<td>${fmt(wmLagMs)}</td>`+
      `<td>${fmt(s("Late_records"))}`+
      `${s("Late_dropped")?" ("+fmt(s("Late_dropped"))+"✕)":""}</td>`+
      `<td>${fmt(m("Checkpoint_cut_pause_usec"))}</td>`+
      `<td>${fmt(m("Queue_len"))}/${fmt(m("Queue_depth_max"))}</td>`+
      `<td>${fmt(s("Device_programs_run"))}</td>`+
      `<td>${fmt(s("Compile_count"))}/${fmt(s("Compile_cache_hits"))}</td>`+
      `<td>${fmt(s("Staging_pool_hits"))}</td></tr>`);
    if (open.has(o.name))
      for (const x of r)
        rows.push(`<tr class=rep><td class=l>&nbsp;&nbsp;replica `+
          `${x.Replica_id}</td><td class=l>${x.isTerminated?"done":"run"}`+
          `</td><td></td><td>${fmt(x.Inputs_received)}</td>`+
          `<td>${fmt(x.Outputs_sent)}</td><td>${fmt(x.Inputs_ignored)}</td>`+
          `<td>${fmt(x.Throughput_tuples_sec)}</td>`+
          `<td>${fmt(x.Service_time_usec)}</td>`+
          `<td>${fmt(x.Latency_service_p99_usec)}</td>`+
          `<td>${fmt(x.Latency_e2e_p99_usec)}</td>`+
          `<td>${fmt((x.Watermark_lag_usec||0)/1000)}</td>`+
          `<td>${fmt(x.Late_records)}`+
          `${x.Late_dropped?" ("+fmt(x.Late_dropped)+"✕)":""}</td>`+
          `<td>${fmt(x.Checkpoint_cut_pause_usec)}</td>`+
          `<td>${fmt(x.Queue_len)}/${fmt(x.Queue_depth_max)}</td>`+
          `<td>${fmt(x.Device_programs_run)}</td>`+
          `<td title="${esc(x.Compile_last_signature||"")}">`+
          `${fmt(x.Compile_count)}/${fmt(x.Compile_cache_hits)}</td>`+
          `<td>${fmt(x.Staging_pool_hits)}</td></tr>`);
  });
  el("ops").innerHTML =
    `<table><tr><th class=l>operator</th><th class=l>kind</th><th>par</th>`+
    `<th>in</th><th>out</th><th>ignored</th><th>tuples/s</th>`+
    `<th>svc µs</th><th>svc p99</th><th>e2e p99</th>`+
    `<th title="wall-clock time since the watermark last advanced">`+
    `wm lag ms</th>`+
    `<th title="tuples behind the watermark (✕ = dropped past the `+
    `allowed lateness)">late</th>`+
    `<th title="barrier cut pause (state capture + ack) of the last `+
    `checkpoint">cut µs</th><th>queue</th>`+
    `<th>device progs</th><th>compiles/hits</th><th>pool hits</th></tr>`+
    rows.join("")+`</table>`+
    `<div class=muted>click an operator row for per-replica detail; `+
    `queue = occupancy/high-water of the operator's input channel</div>`;
  (hist[current] = hist[current]||[]).push(total);
  if (hist[current].length > 120) hist[current].shift();
  spark(hist[current]);
  (lhist[current] = lhist[current]||[]).push(worstP99);
  if (lhist[current].length > 120) lhist[current].shift();
  // rescale-event markers: a tick on the p99 sparkline wherever the
  // graph's Rescale_events counter advanced between polls, so a scaling
  // action is visible right where its latency effect shows up
  const rs = (st.Rescales||{});
  const ev = rs.Rescale_events|0;
  (rmark[current] = rmark[current]||[]).push(
    ev > (rseen[current]|0));
  rseen[current] = ev;
  if (rmark[current].length > 120) rmark[current].shift();
  const rbadge = ev ? `<span class=badge>rescales ${ev}`+
    (rs.Rescale_last_op ? ` (last: ${esc(rs.Rescale_last_op)} → `+
     `${rs.Rescale_last_to|0}, pause `+
     `${fmt((rs.Rescale_last_pause_s||0)*1e3)}ms)` : "")+`</span>` : "";
  if (rbadge) el("badges").innerHTML += rbadge;
  // supervised-restart badge: restarts so far + last MTTR; warn style
  // while escalated (the graph gave up and surfaced the aggregate error)
  const sv = (st.Supervision||{});
  const rst = sv.Supervision_restarts|0;
  if (rst || sv.Supervision_escalated)
    el("badges").innerHTML +=
      `<span class="badge ${sv.Supervision_escalated?'warn':''}">`+
      `restarts ${rst}`+
      (rst ? ` (MTTR ${fmt((sv.Supervision_last_restart_s||0)*1e3)}ms)`
           : "")+
      (sv.Supervision_escalated ? " — escalated" : "")+`</span>`;
  // degraded-mesh badge: devices the recovery plane excluded after a
  // device loss; warn style until the probe sees them return and a
  // planned restart re-expands the mesh to full shape
  const dg = sv.Recovery_degraded_devices|0;
  if (dg) el("badges").innerHTML +=
    `<span class="badge warn">degraded: ${dg} device(s) excluded`+
    ((sv.Recovery_ladder_depth|0) ?
      ` · ladder depth ${sv.Recovery_ladder_depth|0}` : "")+`</span>`;
  // tiered-keyed-state badge: hot/cold key split of the tiered stores
  // (with_tiering) plus the worst per-replica hot-tier miss rate
  if (tierOn) el("badges").innerHTML +=
    `<span class=badge>tiered: ${fmt(tierHot)} hot / `+
    `${fmt(tierCold)} cold · miss ${(tierMiss*100).toFixed(1)}%</span>`;
  // late-drop markers: a tick on the p99 sparkline wherever the graph's
  // Late_dropped total advanced between polls, plus a warn badge with
  // the running dropped/seen-late split
  (dmark[current] = dmark[current]||[]).push(
    lateDrop > (dseen[current]|0));
  dseen[current] = lateDrop;
  if (dmark[current].length > 120) dmark[current].shift();
  if (lateRecs) el("badges").innerHTML +=
    `<span class="badge ${lateDrop?'warn':''}">late ${fmt(lateRecs)}`+
    (lateDrop? ` (dropped ${fmt(lateDrop)})` : "")+`</span>`;
  if (worstWmLag > 1000) el("badges").innerHTML +=
    `<span class="badge warn">wm lag ${fmt(worstWmLag)}ms</span>`;
  // pipeline-doctor banner: the server diagnoses every report tick; the
  // banner shows the ranked verdict for the selected graph
  const doc = el("doctor"), diag = (snap.doctor||{})[current];
  if (diag) {
    doc.style.display = "block";
    doc.className = diag.healthy ? "" : "sick";
    const finds = (diag.findings||[]).slice(0,3).map(f =>
      `<b>${esc(f.operator)}</b> ${esc(f.verdict)}`+
      (f.by? `&nbsp;→ <b>${esc(f.by)}</b>` : "")+
      ` <span class=muted>[${fmt(f.score)}]</span>`).join(" · ");
    doc.innerHTML = `doctor: ${esc(diag.summary||"")}`+
      (finds? `<br>${finds}` : "");
  } else { doc.style.display = "none"; }
  const dlq = st.Dead_letters|0;
  if (dlq) el("badges").innerHTML +=
    `<span class="badge warn">dead letters ${fmt(dlq)}</span>`;
  // overload-governor badge: ladder state + shed accounting (warn
  // style while actively shedding — the graph is refusing work to
  // hold its latency SLO)
  const ov = (st.Overload||{});
  if (ov.Overload_state_name && (ov.Overload_state|0) > 0
      || (ov.Overload_shed_records|0) > 0)
    el("badges").innerHTML +=
      `<span class="badge ${ov.Overload_shedding?'warn':''}">`+
      `overload: ${esc(ov.Overload_state_name||"?")}`+
      (ov.Overload_shedding
        ? ` (admit ${fmt(ov.Overload_admit_rate_tps)}/s)` : "")+
      ((ov.Overload_shed_records|0) > 0
        ? ` — shed ${fmt(ov.Overload_shed_records)}` : "")+`</span>`;
  sparkLine("sparklat", lhist[current], "#b0452b", "µs", rmark[current],
            dmark[current]);
  const svg = (snap.svgs||{})[current];  // server-sanitized
  el("diagram").innerHTML = "<summary>dataflow graph</summary>"+
    (svg || "<pre>"+esc(snap.diagrams[current]||"")+"</pre>");
}
function spark(h){ sparkLine("spark", h, "#2b6cb0", " t/s"); }
function tickMarks(ctx, c, marks, color, glyph){
  ctx.strokeStyle = color; ctx.lineWidth = 1;
  marks.forEach((m,i)=>{
    if (!m) return;
    const x = i*(c.width/120);
    ctx.beginPath(); ctx.setLineDash([3,3]);
    ctx.moveTo(x, 2); ctx.lineTo(x, c.height-2); ctx.stroke();
    ctx.setLineDash([]);
    ctx.fillStyle = color; ctx.font = "9px monospace";
    ctx.fillText(glyph, Math.min(x+2, c.width-10), c.height-4);
  });
}
function sparkLine(id, h, color, unit, marks, marks2){
  const c = el(id), ctx = c.getContext("2d");
  ctx.clearRect(0,0,c.width,c.height);
  if (!h.length) return;
  const max = Math.max(...h, 1);
  // vertical ticks: rescale events (purple) and late-drop surges (orange)
  if (marks) tickMarks(ctx, c, marks, "#7a5cb0", "⇅");
  if (marks2) tickMarks(ctx, c, marks2, "#d97706", "✕");
  ctx.beginPath(); ctx.strokeStyle = color; ctx.lineWidth = 1.6;
  h.forEach((v,i)=>{
    const x = i*(c.width/120), y = c.height-4-(v/max)*(c.height-12);
    i? ctx.lineTo(x,y) : ctx.moveTo(x,y);
  });
  ctx.stroke();
  ctx.fillStyle="#555"; ctx.font="10px monospace";
  ctx.fillText(fmt(max)+unit, 4, 10);
}
function pick(i){ current = graphList[i]; }
function tog(i){ const n = opNames[i];
  open.has(n)? open.delete(n) : open.add(n); }
async function tick(){
  try {
    const r = await fetch("/json", {cache:"no-store"});
    render(await r.json());
    el("conn").textContent = "";
  } catch (e) { el("conn").textContent = "(disconnected)"; }
}
setInterval(tick, 1000); tick();
</script>
</body>
</html>
"""
