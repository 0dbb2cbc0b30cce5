/* ISCC-Search TPU web frontend: lookup/search + aggregator ingestion dashboard.
 *
 * Safety rule: every piece of response data enters the DOM through the h()
 * hyperscript helper below (createElement + textContent). No innerHTML with
 * interpolated data anywhere (XSS-safe rendering, reference-parity:
 * the reference frontend's iscc_search/server/static/js/app.js:1-2).
 */

"use strict";

const PAGE_MODE = document.body.dataset.mode || "standard";
const POLL_MS = 10000;
const HISTORY_LEN = 16; // asset-count snapshots -> up to 15 ingest delta bars

const ui = {
  index: null, // selected index name
  fetchedAt: null, // epoch ms of the last /status fetch
  assetSamples: [], // asset-count history for the sparkline
  firstAssets: null, // session baseline for the "+N this session" chip
  agoNodes: [], // [{node, epochMs}] relative-time cells to re-render
};

/* ---- hyperscript: the only way data reaches the DOM ---- */

function h(tag, attrs, ...children) {
  const node = document.createElement(tag);
  for (const [key, val] of Object.entries(attrs || {})) {
    if (key === "class") node.className = val;
    else if (key === "dataset") Object.assign(node.dataset, val);
    else if (key.startsWith("on")) node.addEventListener(key.slice(2), val);
    else node.setAttribute(key, val);
  }
  for (const child of children.flat()) {
    if (child === null || child === undefined) continue;
    node.append(child.nodeType ? child : document.createTextNode(String(child)));
  }
  return node;
}

function swap(id, ...children) {
  const node = document.getElementById(id);
  if (!node) return null;
  node.replaceChildren(...children.flat().filter(Boolean));
  return node;
}

/* ---- API access (key kept in sessionStorage, sent as X-API-Key) ---- */

function getKey() {
  try {
    return sessionStorage.getItem("iscc-search-key") || "";
  } catch {
    return ""; // storage unavailable (sandboxed iframe etc.)
  }
}

function setKey(value) {
  try {
    value ? sessionStorage.setItem("iscc-search-key", value) : sessionStorage.removeItem("iscc-search-key");
  } catch {
    // best effort: key works for in-flight requests, just won't persist
  }
}

async function call(path, options = {}) {
  const headers = Object.assign({}, options.headers);
  const key = getKey();
  if (key) headers["X-API-Key"] = key;
  const res = await fetch(path, Object.assign({}, options, { headers }));
  if (res.status === 401) {
    const panel = document.getElementById("keyPanel");
    if (panel) {
      panel.open = true;
      panel.classList.add("needs-key");
    }
    throw new Error("Unauthorized — set your API key below.");
  }
  let body = null;
  try {
    body = await res.json();
  } catch {
    // non-JSON error body; fall through with statusText
  }
  if (!res.ok) {
    // 422 validation errors carry detail as a LIST of messages
    let detail = res.statusText;
    if (body && typeof body.detail === "string") detail = body.detail;
    else if (body && Array.isArray(body.detail)) detail = body.detail.join("; ");
    const err = new Error(detail);
    err.status = res.status;
    throw err;
  }
  return body;
}

/* ---- formatting ---- */

const fmtScore = (s) => (typeof s === "number" ? s.toFixed(4) : "0.0000");
const fmtInt = (n) => (n || 0).toLocaleString();

function fmtMB(mb) {
  if (mb >= 1024) return [(mb / 1024).toFixed(mb >= 10240 ? 0 : 1), "GB"];
  if (mb < 1) return ["< 1", "MB"];
  return [mb.toFixed(1), "MB"];
}

function ago(epochMs) {
  const s = Math.max(0, Math.round((Date.now() - epochMs) / 1000));
  if (s < 5) return "just now";
  if (s < 120) return s + "s ago";
  if (s < 7200) return Math.round(s / 60) + "m ago";
  if (s < 172800) return Math.round(s / 3600) + "h ago";
  return Math.round(s / 86400) + "d ago";
}

/* ---- result rendering ---- */

function gatewayAnchor(url) {
  if (typeof url !== "string" || !/^https?:\/\//i.test(url)) return null;
  return h("a", { href: url, target: "_blank", rel: "noopener noreferrer" }, "gateway ↗");
}

function matchCard(match, withChunks) {
  const children = [
    h("div", { class: "match-top" },
      h("span", { class: "mono" }, match.iscc_id),
      h("span", { class: "score" }, fmtScore(match.score))),
  ];
  const meta = match.metadata || {};
  if (meta.name) children.push(h("div", { class: "muted" }, meta.name));
  const link = gatewayAnchor(meta.gateway);
  if (link) children.push(h("div", { class: "muted" }, link));
  for (const [type, info] of Object.entries(match.types || {})) {
    if (withChunks && info && typeof info === "object") {
      children.push(h("div", { class: "pill" }, `${type} · ${info.matches}/${info.queried} @ ${fmtScore(info.score)}`));
      for (const chunk of info.chunks || []) {
        children.push(h("div", { class: "chunk-line" },
          `offset ${chunk.offset} · size ${chunk.size} · ${fmtScore(chunk.score)}`));
      }
    } else {
      children.push(h("span", { class: "pill" }, `${type}: ${fmtScore(info)}`));
    }
  }
  return h("div", { class: "match" }, children);
}

function assetCard(entry) {
  const rows = [h("div", { class: "mono" }, entry.iscc_id)];
  if (entry.iscc_code) rows.push(h("div", { class: "mono muted" }, entry.iscc_code));
  for (const unit of entry.units || []) rows.push(h("div", { class: "mono unit" }, unit));
  for (const [key, val] of Object.entries(entry.metadata || {})) {
    const link = key === "gateway" ? gatewayAnchor(val) : null;
    rows.push(h("div", { class: "muted" }, link || `${key}: ${val}`));
  }
  return [h("h3", null, "Indexed asset"), h("div", { class: "match" }, rows)];
}

function resultNodes(result) {
  const out = [];
  const globals = result.global_matches || [];
  const chunks = result.chunk_matches || [];
  if (globals.length) {
    out.push(h("h3", null, `Global matches (${globals.length})`));
    out.push(globals.map((m) => matchCard(m, false)));
  }
  if (chunks.length) {
    out.push(h("h3", null, `Chunk matches (${chunks.length})`));
    out.push(chunks.map((m) => matchCard(m, true)));
  }
  if (!out.length) out.push(h("p", { class: "muted" }, "No matches found."));
  return out;
}

function showRaw(data) {
  const details = document.getElementById("rawPanel");
  if (!details) return;
  details.classList.remove("hidden");
  document.getElementById("rawBody").textContent = JSON.stringify(data, null, 2);
}

/* ---- lookup / search flow ---- */

async function lookup(value) {
  if (!ui.index) {
    swap("results", h("p", { class: "err" }, "No index available to search."));
    return;
  }
  swap("results", h("p", { class: "muted" }, `Searching ${value} …`));
  try {
    if (/^ISCC:M[A-Z2-7]+$/i.test(value)) {
      // ISCC-ID: exact asset lookup; similarity over an opaque ID is futile
      try {
        const entry = await call(`/indexes/${ui.index}/assets/${encodeURIComponent(value)}`);
        swap("results", assetCard(entry));
        showRaw(entry);
        return;
      } catch (err) {
        if (err.status !== 404) throw err;
        throw new Error("No asset with this ISCC-ID in the index.");
      }
    }
    const result = await call(`/indexes/${ui.index}/search?limit=20`, {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ iscc_code: value }),
    });
    swap("results", resultNodes(result));
    showRaw(result);
  } catch (err) {
    swap("results", h("p", { class: "err" }, err.message));
  }
}

/* ---- standard mode: index table ---- */

function chooseIndex(name) {
  ui.index = name;
  for (const row of document.getElementById("indexRows").children) {
    row.classList.toggle("selected", row.dataset.name === name);
  }
}

async function renderIndexTable() {
  try {
    const indexes = await call("/indexes");
    const rows = indexes.map((idx) =>
      h("tr", {
        class: "selectable",
        dataset: { name: idx.name },
        tabindex: 0,
        role: "button",
        onclick: () => chooseIndex(idx.name),
        onkeydown: (ev) => { if (ev.key === "Enter" || ev.key === " ") { ev.preventDefault(); chooseIndex(idx.name); } },
      },
        h("td", { class: "mono" }, idx.name),
        h("td", { class: "num" }, fmtInt(idx.assets)),
        h("td", { class: "num", title: Object.entries(idx.sizes || {}).map(([c, mb]) => `${c} ${fmtMB(mb).join(" ")}`).join(" · ") },
          fmtMB(idx.size || 0).join(" "))));
    if (!rows.length) {
      rows.push(h("tr", null, h("td", { class: "muted", colspan: 3 }, "No indexes yet — create one via the API (see /docs)")));
    }
    swap("indexRows", rows);
    if (indexes.length) chooseIndex(indexes[0].name);
  } catch (err) {
    swap("indexRows", h("tr", null, h("td", { class: "err", colspan: 3 }, err.message)));
  }
}

/* ---- aggregator dashboard ---- */

function sparkBars(assets) {
  if (ui.firstAssets === null) ui.firstAssets = assets;
  ui.assetSamples.push(assets);
  if (ui.assetSamples.length > HISTORY_LEN) ui.assetSamples.shift();
  const deltas = ui.assetSamples.slice(1).map((v, i) => Math.max(0, v - ui.assetSamples[i]));
  const peak = Math.max(1, ...deltas);
  const bars = deltas.map((d, i) =>
    h("span", {
      class: "spark-bar" + (i === deltas.length - 1 ? " latest" : ""),
      style: `height:${Math.round((d / peak) * 100)}%`,
    }));
  swap("sparkline", deltas.length >= 2 ? bars : []);
  const grown = assets - ui.firstAssets;
  swap("assetsDelta", grown > 0
    ? h("span", { class: "good" }, h("span", { class: "dot ok" }), ` +${fmtInt(grown)} this session`)
    : "");
}

function hubRow(hub) {
  const pollMs = hub.last_poll ? hub.last_poll * 1000 : null;
  const agoCell = h("td", { class: "num" }, pollMs ? ago(pollMs) : "never");
  if (pollMs) ui.agoNodes.push({ node: agoCell, epochMs: pollMs });
  const counts = hub.counts || {};
  const skipped = Object.entries(counts)
    .filter(([reason, n]) => reason !== "ok" && n > 0)
    .map(([reason, n]) => `${reason} ${fmtInt(n)}`)
    .join(", ");
  return h("tr", { class: hub.ok ? "" : "row-err" },
    h("td", { class: "mono" }, "#" + String(hub.hub_id).padStart(4, "0")),
    h("td", { class: "mono" }, hub.url.replace(/^https?:\/\//, "")),
    h("td", { class: "num" }, fmtInt(hub.cursor)),
    h("td", { class: "num" }, fmtInt(counts.ok)),
    h("td", { class: "num muted" }, skipped || "—"),
    agoCell,
    h("td", null,
      h("span", { class: hub.ok ? "good" : "bad" },
        h("span", { class: "dot " + (hub.ok ? "ok" : "err") }),
        " " + (hub.ok ? "healthy" : hub.error || "error"))));
}

function renderDashboard(status) {
  const info = status.index || {};
  const hubs = status.hubs || [];
  swap("statAssets", fmtInt(info.assets));
  sparkBars(info.assets || 0);
  const [sizeVal, sizeUnit] = fmtMB(info.size || 0);
  swap("statSize", sizeVal + " ", h("span", { class: "unit" }, sizeUnit));
  const healthy = hubs.filter((hub) => hub.ok).length;
  swap("statHubs", String(healthy));
  swap("hubsDetail", hubs.length
    ? (healthy === hubs.length
        ? h("span", { class: "good" }, h("span", { class: "dot ok" }), " all healthy")
        : h("span", { class: "bad" }, h("span", { class: "dot err" }), ` ${hubs.length - healthy} erroring`))
    : h("span", { class: "muted" }, "no hubs polled yet"));
  const totalSeq = hubs.reduce((sum, hub) => sum + (hub.cursor || 0), 0);
  swap("statSeq", fmtInt(totalSeq));

  ui.agoNodes = [];
  swap("hubRows", hubs.length
    ? hubs.map(hubRow)
    : h("tr", null, h("td", { class: "muted", colspan: 7 }, "No hubs polled yet")));
}

function tickRelativeTimes() {
  if (ui.fetchedAt === null) return;
  swap("liveAge", "updated " + ago(ui.fetchedAt));
  for (const { node, epochMs } of ui.agoNodes) node.textContent = ago(epochMs);
}

/* ---- /status polling ---- */

async function refreshStatus() {
  const status = await call("/status");
  swap("versionLabel", "v" + status.version);
  if (PAGE_MODE === "aggregator") {
    const network = (status.network || "testnet").toUpperCase();
    swap("modeBadge", h("span", { class: "chip net-" + network.toLowerCase() }, "IDP AGGREGATOR · " + network));
    ui.index = status.index && status.index.name ? status.index.name : ui.index;
    ui.fetchedAt = Date.now();
    renderDashboard(status);
    tickRelativeTimes();
  }
}

function pollLoop() {
  if (!document.hidden) refreshStatus().catch(() => {}); // transient blips retry next tick
  setTimeout(pollLoop, POLL_MS);
}

/* ---- wiring ---- */

function initKeyPanel() {
  const input = document.getElementById("keyInput");
  if (!input) return;
  input.value = getKey();
  input.addEventListener("input", () => {
    setKey(input.value.trim());
    document.getElementById("keyPanel").classList.remove("needs-key");
  });
  input.addEventListener("change", () => {
    if (PAGE_MODE !== "aggregator") renderIndexTable(); // retry a 401'd listing
  });
}

document.addEventListener("DOMContentLoaded", () => {
  const form = document.getElementById("lookupForm");
  if (form) {
    form.addEventListener("submit", (ev) => {
      ev.preventDefault();
      const value = document.getElementById("lookupInput").value.trim();
      if (value) lookup(value);
    });
  }
  initKeyPanel();
  if (PAGE_MODE === "aggregator") {
    pollLoop();
    setInterval(() => { if (!document.hidden) tickRelativeTimes(); }, 1000);
  } else {
    renderIndexTable();
    refreshStatus().catch(() => {});
  }
});
