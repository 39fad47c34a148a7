/* Cordum-TPU operations dashboard: dependency-free SPA over /api/v1.
 *
 * Pages (functional subset of the reference dashboard's 18): overview, jobs,
 * approvals, workflows, runs, dlq, workers, policy, packs, config, settings.
 * Live updates ride the /api/v1/stream WebSocket (API key via
 * Sec-WebSocket-Protocol, as in the reference gateway).
 */
"use strict";

const $ = (sel, el = document) => el.querySelector(sel);
const main = () => $("#page");

// ---------------------------------------------------------------- api
function apiKey() { return localStorage.getItem("cordum_api_key") || ""; }
function principalRole() { return localStorage.getItem("cordum_role") || ""; }

async function api(path, opts = {}) {
  const headers = { "Content-Type": "application/json", ...(opts.headers || {}) };
  if (apiKey()) headers["X-Api-Key"] = apiKey();
  if (principalRole()) headers["X-Principal-Role"] = principalRole();
  const res = await fetch(`/api/v1${path}`, { ...opts, headers });
  let body = null;
  try { body = await res.json(); } catch { /* non-JSON */ }
  if (!res.ok) throw new Error(body?.error || `${res.status} ${res.statusText}`);
  return body;
}

function toast(msg, isErr = false) {
  const box = $("#toast");
  const el = document.createElement("div");
  el.className = "msg" + (isErr ? " err" : "");
  el.textContent = msg;
  box.appendChild(el);
  setTimeout(() => el.remove(), 5000);
}

// ---------------------------------------------------------------- helpers
const STATE_CLASS = {
  SUCCEEDED: "good", RUNNING: "accent", DISPATCHED: "accent", SCHEDULED: "accent",
  PENDING: "warning", APPROVAL_REQUIRED: "warning", THROTTLED: "warning",
  FAILED: "critical", DENIED: "critical", TIMEOUT: "serious", CANCELLED: "serious",
  DLQ: "critical", WAITING_APPROVAL: "warning", waiting_approval: "warning", running: "accent", pending: "warning",
  succeeded: "good", failed: "critical", cancelled: "serious",
};
const badge = (state) =>
  `<span class="badge ${STATE_CLASS[state] || ""}">${esc(state ?? "—")}</span>`;
const esc = (s) => String(s ?? "").replace(/[&<>"']/g, (c) =>
  ({ "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;" }[c]));
const json = (o) => `<pre class="json">${esc(JSON.stringify(o, null, 2))}</pre>`;
const ts = (us) => us ? new Date(us / 1000).toLocaleTimeString() : "—";

function table(headers, rows, onRow) {
  const id = "t" + Math.random().toString(36).slice(2, 8);
  const html = `<table id="${id}"><thead><tr>${headers.map((h) => `<th>${h}</th>`).join("")}</tr></thead>
    <tbody>${rows.map((r, i) => `<tr data-i="${i}">${r.cells.map((c) => `<td>${c}</td>`).join("")}</tr>`).join("") ||
    `<tr class="noclick"><td colspan="${headers.length}" class="muted">none</td></tr>`}</tbody></table>`;
  queueMicrotask(() => {
    if (onRow) $(`#${id}`)?.querySelectorAll("tbody tr[data-i]").forEach((tr) =>
      tr.addEventListener("click", (ev) => {
        if (ev.target.closest("button")) return; // row buttons win
        onRow(rows[+tr.dataset.i], ev);
      }));
  });
  return html;
}

function bind(sel, event, fn) { queueMicrotask(() => $(sel)?.addEventListener(event, fn)); }

// ---------------------------------------------------------------- live stream
let ws = null;
const feed = [];
let feedListeners = [];

function connectWS() {
  try { ws?.close(); } catch { /* noop */ }
  const proto = location.protocol === "https:" ? "wss" : "ws";
  const protocols = apiKey() ? [apiKey()] : undefined;
  ws = new WebSocket(`${proto}://${location.host}/api/v1/stream`, protocols);
  ws.onopen = () => setConn(true);
  ws.onclose = () => { setConn(false); setTimeout(connectWS, 3000); };
  ws.onmessage = (ev) => {
    let doc; try { doc = JSON.parse(ev.data); } catch { return; }
    const flat = { subject: doc.subject, ...(doc.packet || doc) };
    feed.unshift({ at: new Date().toLocaleTimeString(), ...flat });
    if (feed.length > 200) feed.pop();
    feedListeners.forEach((fn) => fn({ subject: doc.subject, ...(doc.packet || doc) }));
  };
}
function setConn(up) {
  const el = $("#conn");
  if (el) el.innerHTML = up
    ? `<span class="badge good">stream live</span>`
    : `<span class="badge serious">stream down</span>`;
}

// ---------------------------------------------------------------- pages
const pages = {};

pages.overview = async () => {
  const [status, workers, jobs, dlq] = await Promise.all([
    api("/status"), api("/workers"), api("/jobs?limit=12"), api("/dlq?limit=1000"),
  ]);
  const nWorkers = workers.count ?? Object.keys(workers.workers || {}).length;
  main().innerHTML = `
    <h1>Overview</h1>
    <div class="tiles">
      <div class="tile"><div class="label">Bus</div>
        <div class="value">${status.bus ? "up" : "DOWN"}</div>
        <div class="sub">${badge(status.bus ? "SUCCEEDED" : "FAILED")}</div></div>
      <div class="tile"><div class="label">State store</div>
        <div class="value">${status.kv ? "up" : "DOWN"}</div>
        <div class="sub">${badge(status.kv ? "SUCCEEDED" : "FAILED")}</div></div>
      <div class="tile"><div class="label">Workers</div><div class="value">${nWorkers}</div>
        <div class="sub">heartbeating</div></div>
      <div class="tile"><div class="label">DLQ depth</div>
        <div class="value">${(dlq.entries || []).length}</div>
        <div class="sub">dead-lettered jobs</div></div>
      <div class="tile"><div class="label">Policy snapshot</div>
        <div class="value mono" style="font-size:14px">${esc(status.policy_snapshot || "—")}</div>
        <div class="sub">safety kernel</div></div>
    </div>
    <h2>Recent jobs</h2>
    ${table(["Job", "Topic", "Tenant", "State"],
      (jobs.jobs || []).map((j) => ({
        id: j.job_id,
        cells: [`<span class="mono">${esc(j.job_id)}</span>`, esc(j.topic), esc(j.tenant_id), badge(j.state)],
      })), (r) => { location.hash = `#/jobs/${r.id}`; })}
    <h2>Live events <span class="muted small">(sys.job.> via WebSocket)</span></h2>
    <div class="card feed" id="feed">${feed.map((f) =>
      `<div><span class="t">${f.at}</span>${esc(f.kind || "?")} ${esc(f.payload?.job_id || "")} ${esc(f.payload?.status || "")}</div>`).join("") || '<div class="muted">waiting for events…</div>'}</div>`;
  feedListeners = [(doc) => {
    const el = $("#feed");
    if (!el) return;
    const d = document.createElement("div");
    d.innerHTML = `<span class="t">${new Date().toLocaleTimeString()}</span>${esc(doc.kind || "?")} ${esc(doc.payload?.job_id || "")} ${esc(doc.payload?.status || "")}`;
    el.prepend(d);
    while (el.children.length > 200) el.lastChild.remove();
  }];
};

pages.jobs = async (jobId) => {
  if (jobId) return jobDetail(jobId);
  const state = sessionStorage.getItem("jobs_state") || "";
  const data = await api(`/jobs?limit=100${state ? `&state=${state}` : ""}`);
  main().innerHTML = `
    <h1>Jobs</h1>
    <div class="row" style="margin-bottom:10px">
      <label>state <select id="stateSel">
        ${["", "PENDING", "SCHEDULED", "DISPATCHED", "RUNNING", "SUCCEEDED", "FAILED",
           "DENIED", "TIMEOUT", "CANCELLED", "APPROVAL_REQUIRED", "DLQ"]
          .map((s) => `<option value="${s}" ${s === state ? "selected" : ""}>${s || "recent"}</option>`).join("")}
      </select></label>
      <span class="grow"></span>
      <button id="submitBtn" class="primary">Submit job…</button>
    </div>
    <div id="submitForm" class="card" style="display:none">
      <div class="row"><label>topic <input id="sTopic" value="job.default" size="24"></label></div>
      <label>payload (JSON)</label><textarea id="sPayload">{"hello": "world"}</textarea>
      <div class="row" style="margin-top:8px"><button id="sGo" class="primary">Submit</button></div>
    </div>
    ${table(["Job", "Topic", "Tenant", "State"],
      (data.jobs || []).map((j) => ({
        id: j.job_id,
        cells: [`<span class="mono">${esc(j.job_id)}</span>`, esc(j.topic), esc(j.tenant_id), badge(j.state)],
      })), (r) => { location.hash = `#/jobs/${r.id}`; })}`;
  bind("#stateSel", "change", (e) => { sessionStorage.setItem("jobs_state", e.target.value); render(); });
  bind("#submitBtn", "click", () => { const f = $("#submitForm"); f.style.display = f.style.display === "none" ? "" : "none"; });
  bind("#sGo", "click", async () => {
    try {
      const payload = JSON.parse($("#sPayload").value || "{}");
      const out = await api("/jobs", { method: "POST", body: JSON.stringify({ topic: $("#sTopic").value, payload }) });
      toast(`submitted ${out.job_id}`);
      location.hash = `#/jobs/${out.job_id}`;
    } catch (e) { toast(e.message, true); }
  });
};

async function jobDetail(jobId) {
  const j = await api(`/jobs/${jobId}?events=true&result=true`);
  const terminal = ["SUCCEEDED", "FAILED", "DENIED", "TIMEOUT", "CANCELLED", "DLQ"].includes(j.state);
  main().innerHTML = `
    <h1 class="row">Job <span class="mono">${esc(jobId)}</span> ${badge(j.state)}
      <span class="grow"></span>
      ${terminal ? "" : `<button id="cancelBtn" class="danger">Cancel</button>`}
    </h1>
    <div class="card"><dl class="kv">
      ${["topic", "tenant_id", "principal_id", "worker_id", "dispatch_subject", "attempts",
         "trace_id", "workflow_id", "run_id", "deny_reason", "approval_reason", "error_message", "error_code"]
        .filter((k) => j[k]).map((k) => `<dt>${k}</dt><dd class="mono">${esc(j[k])}</dd>`).join("")}
    </dl></div>
    ${j.result !== undefined ? `<h2>Result</h2>${json(j.result)}` : ""}
    <h2>Events</h2>
    ${table(["At", "Event", "Detail"], (j.events || []).map((e) => ({
      cells: [ts(e.ts_us ?? e.at_us), esc(e.event),
        `<span class="mono small">${esc(JSON.stringify(Object.fromEntries(Object.entries(e).filter(([k]) => !["event", "ts_us", "at_us"].includes(k)))))}</span>`],
    })))}
    ${j.trace_id ? `<p><a href="#/traces/${esc(j.trace_id)}" class="muted small">trace ${esc(j.trace_id)}</a></p>` : ""}`;
  bind("#cancelBtn", "click", async () => {
    try { await api(`/jobs/${jobId}/cancel`, { method: "POST" }); toast("cancel requested"); render(); }
    catch (e) { toast(e.message, true); }
  });
}

pages.traces = async (traceId) => {
  const t = await api(`/traces/${traceId}`);
  main().innerHTML = `<h1>Trace <span class="mono">${esc(traceId)}</span></h1>
    ${table(["Job", "Topic", "State"], (t.jobs || []).map((j) => ({
      id: j.job_id, cells: [`<span class="mono">${esc(j.job_id)}</span>`, esc(j.topic), badge(j.state)],
    })), (r) => { location.hash = `#/jobs/${r.id}`; })}`;
};

pages.approvals = async () => {
  const data = await api("/approvals");
  main().innerHTML = `
    <h1>Approvals</h1>
    <p class="muted small">Jobs parked by the safety kernel awaiting a human decision.
    Approve re-checks against the current policy and binds to the stored job hash.</p>
    ${table(["Job", "Topic", "Tenant", "Reason", "Snapshot", ""],
      (data.approvals || []).map((a) => ({
        id: a.job_id,
        cells: [`<span class="mono">${esc(a.job_id)}</span>`, esc(a.topic), esc(a.tenant_id),
          esc(a.reason), `<span class="mono small">${esc(a.policy_snapshot)}</span>`,
          `<button data-act="approve" data-id="${esc(a.job_id)}" class="primary">Approve</button>
           <button data-act="reject" data-id="${esc(a.job_id)}" class="danger">Reject</button>`],
      })), (r) => { location.hash = `#/jobs/${r.id}`; })}`;
  queueMicrotask(() => main().querySelectorAll("button[data-act]").forEach((b) =>
    b.addEventListener("click", async (ev) => {
      ev.stopPropagation();
      try {
        await api(`/approvals/${b.dataset.id}/${b.dataset.act}`, { method: "POST" });
        toast(`${b.dataset.act}ed ${b.dataset.id}`); render();
      } catch (e) { toast(e.message, true); }
    })));
};

pages.workflows = async (wfId) => {
  if (wfId) return workflowDetail(wfId);
  const data = await api("/workflows");
  main().innerHTML = `
    <h1>Workflows</h1>
    ${table(["Workflow", "Steps", "Description"], (data.workflows || []).map((w) => ({
      id: w.id ?? w,
      cells: [`<span class="mono">${esc(w.id ?? w)}</span>`, esc(w.steps ?? ""), esc(w.description ?? "")],
    })), (r) => { location.hash = `#/workflows/${r.id}`; })}`;
};

async function workflowDetail(wfId) {
  const wf = await api(`/workflows/${wfId}`);
  main().innerHTML = `
    <h1 class="row">Workflow <span class="mono">${esc(wfId)}</span><span class="grow"></span>
      <button id="runBtn" class="primary">Start run…</button></h1>
    <div id="runForm" class="card" style="display:none">
      <label>input (JSON)</label><textarea id="runInput">{}</textarea>
      <div class="row" style="margin-top:8px"><button id="runGo" class="primary">Start</button></div>
    </div>
    <h2>Steps</h2>
    ${table(["Step", "Type", "Topic", "Depends on", "Condition"],
      Object.entries(wf.steps || {}).map(([sid, s]) => ({
        cells: [`<span class="mono">${esc(sid)}</span>`, esc(s.type || "worker"), esc(s.topic || ""),
          esc((s.depends_on || []).join(", ")), `<span class="mono small">${esc(s.condition || "")}</span>`],
      })))}
    <h2>Definition</h2>${json(wf)}
    <h2>Runs</h2><div id="wfRuns" class="muted">loading…</div>`;
  bind("#runBtn", "click", () => { const f = $("#runForm"); f.style.display = f.style.display === "none" ? "" : "none"; });
  bind("#runGo", "click", async () => {
    try {
      const input = JSON.parse($("#runInput").value || "{}");
      const out = await api(`/workflows/${wfId}/runs`, { method: "POST", body: JSON.stringify({ input }) });
      toast(`run ${out.run_id} started`);
      location.hash = `#/runs/${out.run_id}`;
    } catch (e) { toast(e.message, true); }
  });
  const runs = await api(`/runs?workflow_id=${encodeURIComponent(wfId)}`);
  const ids = runs.runs || [];
  $("#wfRuns").innerHTML = table(["Run"], ids.map((r) => ({
    id: r, cells: [`<span class="mono">${esc(r)}</span>`],
  })), (r) => { location.hash = `#/runs/${r.id}`; });
}

pages.runs = async (runId) => {
  if (runId) return runDetail(runId);
  const data = await api("/runs");
  const ids = (data.runs || []).slice(0, 100);
  const rows = [];
  for (const rid of ids) {
    try {
      const r = await api(`/runs/${rid}`);
      rows.push({ id: rid, cells: [`<span class="mono">${esc(rid)}</span>`, esc(r.workflow_id), badge(r.status), esc(Object.keys(r.steps || {}).length)] });
    } catch { rows.push({ id: rid, cells: [`<span class="mono">${esc(rid)}</span>`, "?", "?", "?"] }); }
  }
  main().innerHTML = `<h1>Runs</h1>
    ${table(["Run", "Workflow", "Status", "Steps"], rows, (r) => { location.hash = `#/runs/${r.id}`; })}`;
};

async function runDetail(runId) {
  const [run, tl] = await Promise.all([
    api(`/runs/${runId}`), api(`/runs/${runId}/timeline`).catch(() => ({ timeline: [] })),
  ]);
  const active = ["pending", "running", "waiting_approval", "PENDING", "RUNNING", "WAITING_APPROVAL"].includes(run.status);
  main().innerHTML = `
    <h1 class="row">Run <span class="mono">${esc(runId)}</span> ${badge(run.status)}
      <span class="grow"></span>
      ${active ? `<button id="cancelRun" class="danger">Cancel</button>` : `<button id="rerun">Rerun</button>`}
    </h1>
    <div class="card"><dl class="kv">
      <dt>workflow</dt><dd class="mono">${esc(run.workflow_id)}</dd>
      <dt>org</dt><dd>${esc(run.org_id || "—")}</dd>
    </dl></div>
    <h2>Steps</h2>
    ${table(["Step", "Status", "Attempt", "Job", "Children", ""],
      Object.entries(run.steps || {}).map(([sid, s]) => ({
        cells: [`<span class="mono">${esc(sid)}</span>`, badge(s.status), esc(s.attempts ?? s.attempt ?? 0),
          s.job_id ? `<a href="#/jobs/${esc(s.job_id)}" class="mono small">${esc(s.job_id)}</a>` : "—",
          esc((s.children || []).length || ""),
          ["waiting_approval", "WAITING_APPROVAL"].includes(s.status)
            ? `<button data-step="${esc(sid)}" class="primary">Approve step</button>` : ""],
      })))}
    <h2>Timeline</h2>
    ${table(["At", "Event", "Step", "Detail"], (tl.timeline || []).map((e) => ({
      cells: [ts(e.ts_us ?? e.at_us), esc(e.event), `<span class="mono">${esc(e.step_id || "")}</span>`,
        `<span class="small muted">${esc(e.detail || e.reason || "")}</span>`],
    })))}
    <h2>Context</h2>${json(run.ctx || run.context || {})}`;
  bind("#cancelRun", "click", async () => {
    try { await api(`/runs/${runId}/cancel`, { method: "POST" }); toast("cancelled"); render(); }
    catch (e) { toast(e.message, true); }
  });
  bind("#rerun", "click", async () => {
    try { const out = await api(`/runs/${runId}/rerun`, { method: "POST", body: "{}" }); toast(`rerun ${out.run_id}`); location.hash = `#/runs/${out.run_id}`; }
    catch (e) { toast(e.message, true); }
  });
  queueMicrotask(() => main().querySelectorAll("button[data-step]").forEach((b) =>
    b.addEventListener("click", async () => {
      try { await api(`/runs/${runId}/steps/${b.dataset.step}/approve`, { method: "POST" }); toast("step approved"); render(); }
      catch (e) { toast(e.message, true); }
    })));
}

pages.dlq = async () => {
  const data = await api("/dlq?limit=200");
  main().innerHTML = `
    <h1>Dead-letter queue</h1>
    ${table(["Job", "Topic", "Reason", "Code", "Last state", "Attempts", ""],
      (data.entries || []).map((e) => ({
        id: e.job_id,
        cells: [`<span class="mono">${esc(e.job_id)}</span>`, esc(e.topic), esc(e.reason),
          `<span class="mono small">${esc(e.reason_code)}</span>`, badge(e.last_state || e.status),
          esc(e.attempts ?? ""),
          `<button data-act="retry" data-id="${esc(e.job_id)}" class="primary">Retry</button>
           <button data-act="delete" data-id="${esc(e.job_id)}" class="danger">Delete</button>`],
      })), (r) => { location.hash = `#/jobs/${r.id}`; })}`;
  queueMicrotask(() => main().querySelectorAll("button[data-act]").forEach((b) =>
    b.addEventListener("click", async (ev) => {
      ev.stopPropagation();
      try {
        if (b.dataset.act === "retry") {
          const out = await api(`/dlq/${b.dataset.id}/retry`, { method: "POST" });
          toast(`retried as ${out.job_id || "new job"}`);
        } else {
          await api(`/dlq/${b.dataset.id}`, { method: "DELETE" });
          toast("deleted");
        }
        render();
      } catch (e) { toast(e.message, true); }
    })));
};

pages.workers = async () => {
  const data = await api("/workers");
  const workers = Object.values(data.workers || {});
  main().innerHTML = `
    <h1>Workers <span class="muted small">${workers.length} heartbeating</span></h1>
    <div class="workers">
      ${workers.map((w) => {
        const duty = Math.round(w.tpu_duty_cycle ?? w.gpu_utilization ?? 0);
        const hbmPct = w.hbm_total_gb ? Math.round(100 * w.hbm_used_gb / w.hbm_total_gb) : null;
        return `<div class="card">
          <div class="row"><b class="mono">${esc(w.worker_id)}</b><span class="grow"></span>
            ${badge(w.devices_healthy === false ? "FAILED" : "RUNNING")}</div>
          <dl class="kv small" style="grid-template-columns:110px 1fr; margin-top:6px">
            <dt>pool</dt><dd>${esc(w.pool)}</dd>
            <dt>device</dt><dd>${esc(w.device_kind || w.type || "—")} ×${esc(w.chip_count ?? 0)}</dd>
            <dt>topology</dt><dd class="mono">${esc(w.slice_topology || "—")}</dd>
            <dt>jobs</dt><dd>${esc(w.active_jobs ?? 0)} / ${esc(w.max_parallel_jobs ?? "∞")}</dd>
            <dt>capabilities</dt><dd>${esc((w.capabilities || []).join(", ") || "—")}</dd>
          </dl>
          <div class="small muted">TPU duty ${duty}%</div>
          <div class="meter ${duty > 85 ? "hot" : ""}"><div style="width:${duty}%"></div></div>
          ${hbmPct !== null ? `<div class="small muted" style="margin-top:6px">HBM ${esc(w.hbm_used_gb?.toFixed?.(1) ?? w.hbm_used_gb)} / ${esc(w.hbm_total_gb)} GB</div>
          <div class="meter ${hbmPct > 85 ? "hot" : ""}"><div style="width:${hbmPct}%"></div></div>` : ""}
        </div>`;
      }).join("") || '<p class="muted">no workers heartbeating</p>'}
    </div>`;
};

pages.policy = async (sub) => {
  const tab = sub || "bundles";
  const tabs = ["bundles", "snapshots", "simulate", "audit"];
  const head = `<h1>Safety policy</h1>
    <div class="tabs">${tabs.map((t) =>
      `<button class="${t === tab ? "active" : ""}" onclick="location.hash='#/policy/${t}'">${t}</button>`).join("")}</div>`;
  if (tab === "bundles") {
    const data = await api("/policy/bundles");
    main().innerHTML = head + table(["Bundle", "Enabled", "Rules"],
      (data.bundles || []).map((b) => ({
        id: b.id ?? b,
        cells: [`<span class="mono">${esc(b.id ?? b)}</span>`, esc(String(b.enabled ?? "")), esc(b.rules ?? "")],
      })), async (r) => {
        const doc = await api(`/policy/bundles/${encodeURIComponent(r.id)}`);
        $("#bundleView").innerHTML = `<h2>${esc(r.id)}</h2>${json(doc)}`;
      }) + `<div id="bundleView"></div>`;
  } else if (tab === "snapshots") {
    const [snaps, captured] = await Promise.all([
      api("/policy/snapshots"), api("/policy/snapshots/captured").catch(() => ({ snapshots: [] })),
    ]);
    main().innerHTML = head +
      `<h2>Kernel snapshots (last 10)</h2>` +
      table(["Snapshot", "Created"], (snaps.snapshots || []).map((s) => ({
        cells: [`<span class="mono">${esc(s.snapshot_id)}</span>`, esc(new Date((s.created_at || 0) * 1000).toLocaleString())],
      }))) +
      `<h2 class="row">Captured <span class="grow"></span><button id="capBtn">Capture now</button></h2>` +
      table(["Snapshot", "Created", ""], (captured.snapshots || []).map((s) => ({
        cells: [`<span class="mono">${esc(s.snapshot_id || s.id)}</span>`,
          esc(new Date((s.created_at || 0) * 1000).toLocaleString()),
          `<button data-roll="${esc(s.snapshot_id || s.id)}" class="danger">Rollback</button>`],
      })));
    bind("#capBtn", "click", async () => {
      try { await api("/policy/snapshots/capture", { method: "POST" }); toast("captured"); render(); }
      catch (e) { toast(e.message, true); }
    });
    queueMicrotask(() => main().querySelectorAll("button[data-roll]").forEach((b) =>
      b.addEventListener("click", async () => {
        try { await api(`/policy/snapshots/${b.dataset.roll}/rollback`, { method: "POST" }); toast("rolled back"); render(); }
        catch (e) { toast(e.message, true); }
      })));
  } else if (tab === "simulate") {
    main().innerHTML = head + `
      <div class="card">
        <p class="muted small">Evaluate a hypothetical request against the live policy (no side effects).</p>
        <div class="row">
          <label>topic <input id="simTopic" value="job.tpu.train"></label>
          <label>tenant <input id="simTenant" value="default" size="10"></label>
          <label>capability <input id="simCap" value="tpu" size="8"></label>
          <label>risk tags <input id="simRisk" value="" size="12"></label>
        </div>
        <div class="row" style="margin-top:8px"><button id="simGo" class="primary">Simulate</button></div>
        <div id="simOut"></div>
      </div>`;
    bind("#simGo", "click", async () => {
      try {
        const out = await api("/policy/simulate", {
          method: "POST",
          body: JSON.stringify({
            topic: $("#simTopic").value, tenant_id: $("#simTenant").value,
            metadata: {
              capability: $("#simCap").value,
              risk_tags: $("#simRisk").value.split(",").map((s) => s.trim()).filter(Boolean),
            },
          }),
        });
        $("#simOut").innerHTML = `<p>${badge(out.decision)} <span class="muted">${esc(out.reason || "")}</span></p>${json(out)}`;
      } catch (e) { toast(e.message, true); }
    });
  } else if (tab === "audit") {
    const data = await api("/policy/audit");
    main().innerHTML = head + table(["At", "Action", "Actor", "Detail"],
      (data.audit || data.entries || []).map((a) => ({
        cells: [esc(new Date((a.at || a.created_at || 0) * 1000).toLocaleString()), esc(a.action),
          esc(a.actor || a.by || ""), `<span class="mono small">${esc(JSON.stringify(a.detail || a.target || ""))}</span>`],
      })));
  }
};

pages.packs = async () => {
  const [packs, catalogs] = await Promise.all([
    api("/packs"), api("/pack-catalogs").catch(() => ({ catalogs: {} })),
  ]);
  const names = Array.isArray(packs.packs) ? packs.packs : Object.keys(packs.packs || {});
  main().innerHTML = `
    <h1>Packs</h1>
    <h2>Installed</h2>
    ${table(["Pack", ""], names.map((p) => ({
      id: p,
      cells: [`<span class="mono">${esc(p)}</span>`,
        `<button data-un="${esc(p)}" class="danger">Uninstall</button>`],
    })), async (r) => {
      const doc = await api(`/packs/${r.id}`);
      $("#packView").innerHTML = `<h2>${esc(r.id)}</h2>${json(doc)}`;
    })}
    <div id="packView"></div>
    <h2>Catalogs</h2>
    ${table(["Catalog", "Path", ""], Object.entries(catalogs.catalogs || {}).map(([name, c]) => ({
      cells: [`<span class="mono">${esc(name)}</span>`, `<span class="mono small">${esc(c.path)}</span>`,
        `<button data-cat="${esc(name)}">Browse</button>`],
    })))}
    <div id="catView"></div>`;
  queueMicrotask(() => {
    main().querySelectorAll("button[data-un]").forEach((b) =>
      b.addEventListener("click", async (ev) => {
        ev.stopPropagation();
        try { await api(`/packs/${b.dataset.un}`, { method: "DELETE" }); toast("uninstalled"); render(); }
        catch (e) { toast(e.message, true); }
      }));
    main().querySelectorAll("button[data-cat]").forEach((b) =>
      b.addEventListener("click", async () => {
        try {
          const data = await api(`/pack-catalogs/${b.dataset.cat}/packs`);
          $("#catView").innerHTML = `<h2>${esc(b.dataset.cat)}</h2>` +
            table(["Pack", "Version", ""], (data.packs || []).map((p) => ({
              cells: [`<span class="mono">${esc(p.id)}</span>`, esc(p.version || ""),
                `<button data-inst="${esc(p.id)}" data-from="${esc(b.dataset.cat)}" class="primary">Install</button>`],
            })));
          main().querySelectorAll("button[data-inst]").forEach((ib) =>
            ib.addEventListener("click", async () => {
              try {
                await api(`/pack-catalogs/${ib.dataset.from}/install/${ib.dataset.inst}`, { method: "POST" });
                toast(`installed ${ib.dataset.inst}`); render();
              } catch (e) { toast(e.message, true); }
            }));
        } catch (e) { toast(e.message, true); }
      }));
  });
};

pages.config = async () => {
  const eff = await api("/config/effective").catch((e) => ({ error: e.message }));
  main().innerHTML = `
    <h1>Config</h1>
    <h2>Effective (system scope, shallow-merged)</h2>${json(eff)}
    <div class="card">
      <h2 style="margin-top:0">Read / write a scoped document</h2>
      <div class="row">
        <label>scope <select id="cfgScope">${["system", "org", "team", "workflow", "step"]
          .map((s) => `<option>${s}</option>`).join("")}</select></label>
        <label>doc id <input id="cfgId" value="default"></label>
        <button id="cfgGet">Load</button>
        <button id="cfgPut" class="primary">Save</button>
      </div>
      <textarea id="cfgDoc" style="margin-top:8px">{}</textarea>
    </div>`;
  bind("#cfgGet", "click", async () => {
    try {
      const doc = await api(`/config/${$("#cfgScope").value}/${$("#cfgId").value}`);
      $("#cfgDoc").value = JSON.stringify(doc.data ?? doc, null, 2);
    } catch (e) { toast(e.message, true); }
  });
  bind("#cfgPut", "click", async () => {
    try {
      const data = JSON.parse($("#cfgDoc").value);
      await api(`/config/${$("#cfgScope").value}/${$("#cfgId").value}`,
        { method: "PUT", body: JSON.stringify({ data }) });
      toast("saved");
    } catch (e) { toast(e.message, true); }
  });
};

pages.settings = async () => {
  main().innerHTML = `
    <h1>Settings</h1>
    <div class="card">
      <div class="row"><label>API key <input id="setKey" type="password" value="${esc(apiKey())}" size="30"></label></div>
      <div class="row" style="margin-top:8px"><label>role header (X-Principal-Role)
        <select id="setRole"><option value="">(none)</option><option ${principalRole() === "admin" ? "selected" : ""}>admin</option></select></label></div>
      <div class="row" style="margin-top:10px"><button id="setSave" class="primary">Save</button></div>
      <p class="muted small">Stored in this browser only. The stream reconnects with the new key.</p>
    </div>
    <div class="card">
      <div class="row"><label>theme
        <select id="setTheme">${["auto", "light", "dark"].map((t) =>
          `<option ${((localStorage.getItem("cordum_theme") || "auto") === t) ? "selected" : ""}>${t}</option>`).join("")}</select></label></div>
    </div>`;
  bind("#setSave", "click", () => {
    localStorage.setItem("cordum_api_key", $("#setKey").value.trim());
    localStorage.setItem("cordum_role", $("#setRole").value);
    toast("saved"); connectWS(); render();
  });
  bind("#setTheme", "change", (e) => {
    localStorage.setItem("cordum_theme", e.target.value);
    applyTheme();
  });
};

function applyTheme() {
  const t = localStorage.getItem("cordum_theme") || "auto";
  if (t === "auto") delete document.documentElement.dataset.theme;
  else document.documentElement.dataset.theme = t;
}

// ---------------------------------------------------------------- router
const NAV = [
  ["overview", "Overview"], ["jobs", "Jobs"], ["approvals", "Approvals"],
  ["workflows", "Workflows"], ["runs", "Runs"], ["dlq", "DLQ"],
  ["workers", "Workers"], ["policy", "Policy"], ["packs", "Packs"],
  ["config", "Config"], ["settings", "Settings"],
];

async function render() {
  const [page, arg] = location.hash.replace(/^#\//, "").split("/", 2);
  const name = pages[page] ? page : "overview";
  document.querySelectorAll("nav a").forEach((a) =>
    a.classList.toggle("active", a.dataset.page === name));
  feedListeners = [];
  try {
    await pages[name](arg ? decodeURIComponent(arg) : undefined);
  } catch (e) {
    main().innerHTML = `<h1>${esc(name)}</h1><div class="card">
      <p>${badge("FAILED")} ${esc(e.message)}</p>
      <p class="muted small">Check the API key under Settings.</p></div>`;
  }
}

function boot() {
  $("#nav-links").innerHTML = NAV.map(([p, label]) =>
    `<a href="#/${p}" data-page="${p}">${label}</a>`).join("");
  applyTheme();
  window.addEventListener("hashchange", render);
  connectWS();
  render();
}
boot();
