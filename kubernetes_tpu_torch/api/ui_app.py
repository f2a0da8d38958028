"""The client-side dashboard served at /ui.

Reference: pkg/ui/installsupport.go + www/README.md — the apiserver
bundles a client-side JS application (go-bindata'd into datafile.go)
that renders cluster state by calling the public REST API from the
browser. This module plays that role at this framework's scale: ONE
static page (no server-side rendering — the shell below contains no
cluster data) whose script lists nodes/pods/events through /api/v1 and
then LIVE-UPDATES by consuming the chunked watch streams
(/api/v1/watch/..., the same NDJSON wire kubectl's --watch uses),
re-listing on stream loss exactly like a reflector (410-safe:
list -> resourceVersion -> watch).

The previous server-rendered page remains at /ui/server for
curl-style consumption; /ui itself works with the renderer gone.
"""

UI_APP_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>kubernetes_tpu dashboard</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 1.5em; }
 h1 { margin-bottom: 0.2em; }
 #status { color: #666; margin-bottom: 1em; }
 #status .live { color: #0a0; font-weight: bold; }
 #status .down { color: #a00; font-weight: bold; }
 .counts span { margin-right: 1.5em; }
 table { border-collapse: collapse; margin-bottom: 1em; }
 td, th { border: 1px solid #ccc; padding: 3px 10px;
          font-size: 13px; text-align: left; }
 th { background: #f5f5f5; }
 input, select { margin: 0 0.8em 0.6em 0; padding: 2px 6px; }
 .trunc { color: #888; font-size: 12px; }
</style>
</head>
<body>
<h1>kubernetes_tpu</h1>
<div id="status">connecting&hellip;
 (<a href="/swaggerapi">swagger</a>, <a href="/metrics">metrics</a>,
  <a href="/healthz">healthz</a>, <a href="/ui/server">server-rendered</a>)
</div>
<div class="counts" id="counts"></div>
<h2>Pods</h2>
<input id="podFilter" placeholder="filter name/node" />
<select id="phaseFilter"><option value="">all phases</option></select>
<div id="pods"></div>
<h2>Nodes</h2>
<input id="nodeFilter" placeholder="filter name" />
<div id="nodes"></div>
<h2>Events</h2>
<div id="events"></div>
<script>
"use strict";
const MAX_ROWS = 500;
const state = {
  pods: new Map(), nodes: new Map(), events: [],
  streams: {pods: false, nodes: false, events: false},
};
const esc = s => String(s == null ? "" : s)
  .replace(/&/g, "&amp;").replace(/</g, "&lt;").replace(/>/g, "&gt;");
const key = o => (o.metadata.namespace || "") + "/" + o.metadata.name;

function nodeReady(n) {
  for (const c of (n.status && n.status.conditions) || [])
    if (c.type === "Ready") return c.status === "True" ? "Ready" : "NotReady";
  return "Unknown";
}

let renderQueued = false;
function queueRender() {      // coalesce bursts (a 30k-pod bind storm)
  if (renderQueued) return;
  renderQueued = true;
  setTimeout(() => { renderQueued = false; render(); }, 250);
}

function renderTable(el, header, rows, total) {
  let html = "<table><tr>" +
    header.map(h => "<th>" + esc(h) + "</th>").join("") + "</tr>";
  for (const r of rows.slice(0, MAX_ROWS))
    html += "<tr>" + r.map(c => "<td>" + esc(c) + "</td>").join("") + "</tr>";
  html += "</table>";
  if (total > MAX_ROWS)
    html += '<div class="trunc">showing ' + MAX_ROWS + " of " +
            total + "</div>";
  el.innerHTML = html;
}

function render() {
  const phases = {};
  let bound = 0;
  for (const p of state.pods.values()) {
    const ph = (p.status && p.status.phase) || "Unknown";
    phases[ph] = (phases[ph] || 0) + 1;
    if (p.spec && p.spec.nodeName) bound++;
  }
  let ready = 0;
  for (const n of state.nodes.values())
    if (nodeReady(n) === "Ready") ready++;
  document.getElementById("counts").innerHTML =
    "<span>nodes: <b>" + ready + "/" + state.nodes.size +
    "</b> ready</span><span>pods: <b>" + state.pods.size +
    "</b> (" + bound + " bound; " +
    esc(Object.entries(phases).map(([k, v]) => k + ": " + v)
        .join(", ") || "none") + ")</span>";

  const phaseSel = document.getElementById("phaseFilter");
  const have = new Set([...phaseSel.options].map(o => o.value));
  for (const ph of Object.keys(phases))
    if (!have.has(ph)) phaseSel.add(new Option(ph, ph));

  const pf = document.getElementById("podFilter").value.toLowerCase();
  const phf = phaseSel.value;
  const podRows = [];
  let podTotal = 0;
  for (const p of state.pods.values()) {
    const ph = (p.status && p.status.phase) || "Unknown";
    const node = (p.spec && p.spec.nodeName) || "";
    if (phf && ph !== phf) continue;
    if (pf && !(key(p).toLowerCase().includes(pf) ||
                node.toLowerCase().includes(pf))) continue;
    podTotal++;
    if (podRows.length < MAX_ROWS)
      podRows.push([p.metadata.namespace, p.metadata.name, ph,
                    node || "\\u2014"]);
  }
  renderTable(document.getElementById("pods"),
              ["namespace", "name", "phase", "node"], podRows, podTotal);

  const nf = document.getElementById("nodeFilter").value.toLowerCase();
  const nodeRows = [];
  let nodeTotal = 0;
  for (const n of state.nodes.values()) {
    if (nf && !n.metadata.name.toLowerCase().includes(nf)) continue;
    nodeTotal++;
    if (nodeRows.length < MAX_ROWS) {
      // n.status itself may be absent: the wire encoder omits empty
      // fields, and a node can list before its first status write
      const cap = (n.status && n.status.capacity) || {};
      nodeRows.push([n.metadata.name, nodeReady(n),
                     cap.cpu || "", cap.memory || ""]);
    }
  }
  renderTable(document.getElementById("nodes"),
              ["name", "status", "cpu", "memory"], nodeRows, nodeTotal);

  const evRows = state.events.slice(-30).reverse().map(e => [
    e.type, e.reason,
    (e.involvedObject || {}).kind + "/" + (e.involvedObject || {}).name,
    e.message, e.count]);
  renderTable(document.getElementById("events"),
              ["type", "reason", "object", "message", "count"],
              evRows, evRows.length);
  renderStatus();
}

function renderStatus() {
  const live = Object.values(state.streams).every(v => v);
  document.getElementById("status").innerHTML =
    (live ? '<span class="live">&#9679; live</span> watching ' +
            "pods/nodes/events"
          : '<span class="down">&#9679; reconnecting&hellip;</span>') +
    ' (<a href="/swaggerapi">swagger</a>,' +
    ' <a href="/metrics">metrics</a>,' +
    ' <a href="/healthz">healthz</a>,' +
    ' <a href="/ui/server">server-rendered</a>)';
}

function apply(kind, ev) {
  if (kind === "events") {
    if (ev.type !== "DELETED") state.events.push(ev.object);
    if (state.events.length > 200) state.events.splice(0, 100);
    return;
  }
  const m = state[kind];
  if (ev.type === "DELETED") m.delete(key(ev.object));
  else m.set(key(ev.object), ev.object);
}

async function reflect(kind, resource) {
  // a reflector in the browser: LIST for a resourceVersion, then
  // consume the chunked watch; any failure (incl. 410 Expired) falls
  // back to a fresh LIST
  for (;;) {
    let rv;
    try {
      const resp = await fetch("/api/v1/" + resource);
      const body = await resp.json();
      rv = (body.metadata || {}).resourceVersion || "";
      if (kind === "events") state.events = body.items || [];
      else {
        state[kind] = new Map(
          (body.items || []).map(o => [key(o), o]));
      }
      queueRender();
      const watch = await fetch("/api/v1/watch/" + resource +
                                "?resourceVersion=" + rv);
      if (!watch.ok || !watch.body) throw new Error("watch " + watch.status);
      state.streams[kind] = true;
      renderStatus();
      const reader = watch.body.getReader();
      const dec = new TextDecoder();
      let buf = "";
      for (;;) {
        const {done, value} = await reader.read();
        if (done) break;
        buf += dec.decode(value, {stream: true});
        let nl;
        while ((nl = buf.indexOf("\\n")) >= 0) {
          const line = buf.slice(0, nl).trim();
          buf = buf.slice(nl + 1);
          if (!line) continue;          // keep-alive blank
          apply(kind, JSON.parse(line));
          queueRender();
        }
      }
    } catch (e) { /* fall through to re-list */ }
    state.streams[kind] = false;
    renderStatus();
    await new Promise(r => setTimeout(r, 1000));
  }
}

for (const id of ["podFilter", "phaseFilter", "nodeFilter"])
  document.getElementById(id).addEventListener("input", queueRender);
reflect("pods", "pods");
reflect("nodes", "nodes");
reflect("events", "events");
</script>
</body>
</html>
"""
