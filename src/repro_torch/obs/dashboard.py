"""Self-contained sweep dashboard: one static HTML file from run artifacts.

``python -m repro_torch.obs.dashboard run.manifest.json -o report.html`` (or
``run_grid(dashboard_path=...)`` / the sweep CLI ``--dashboard``) renders
everything a sweep writes — the manifest, the per-cell results JSON, the
span trace, the metrics snapshot, fired alerts, and any BENCH_*.json
sitting next to the manifest — into a single offline-viewable report:

  * inline-SVG sparklines of every ring channel per cell (from the
    ``obs.history`` block :func:`repro_torch.obs.report.compact_history`
    embeds), with fired-alert tick windows highlighted on the affected
    channel,
  * the span-trace phase waterfall (error-flagged spans marked),
  * the metrics snapshot and fired-alert tables,
  * a BENCH criteria table (pass/fail per artifact).

Stdlib only — no matplotlib, no JS frameworks, no network: the file
works on a CI artifact download with zero dependencies.  Light and dark
render from the same CSS custom properties (OS preference via
``prefers-color-scheme``, explicit override via ``data-theme``).

A copy of ``repro/obs/dashboard.py``.
"""
from __future__ import annotations

import argparse
import html
import json
import os
from typing import Sequence

__all__ = ["render_dashboard", "main"]

# sparkline geometry (viewBox units)
_W, _H, _PAD = 240, 44, 3

# severity -> (status color, icon); status colors are fixed across
# light/dark per the palette (never themed), and always paired with
# the icon + text label so color never carries meaning alone
_SEVERITY = {"info": ("var(--ink-2)", "i"),
             "warn": ("#fab219", "⚠"),        # warning
             "page": ("#d03b3b", "●")}        # critical

_CSS = """
:root {
  color-scheme: light;
  --surface: #fcfcfb; --page: #f9f9f7;
  --ink: #0b0b0b; --ink-2: #52514e; --muted: #898781;
  --grid: #e1e0d9; --axis: #c3c2b7; --border: rgba(11,11,11,0.10);
  --series: #2a78d6; --band: rgba(208,59,59,0.14);
  --good: #0ca30c; --crit: #d03b3b;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) {
    color-scheme: dark;
    --surface: #1a1a19; --page: #0d0d0d;
    --ink: #ffffff; --ink-2: #c3c2b7; --muted: #898781;
    --grid: #2c2c2a; --axis: #383835; --border: rgba(255,255,255,0.10);
    --series: #3987e5; --band: rgba(208,59,59,0.22);
  }
}
:root[data-theme="dark"] {
  color-scheme: dark;
  --surface: #1a1a19; --page: #0d0d0d;
  --ink: #ffffff; --ink-2: #c3c2b7; --muted: #898781;
  --grid: #2c2c2a; --axis: #383835; --border: rgba(255,255,255,0.10);
  --series: #3987e5; --band: rgba(208,59,59,0.22);
}
* { box-sizing: border-box; }
body { margin: 0; padding: 24px; background: var(--page); color: var(--ink);
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  font-size: 14px; line-height: 1.45; }
h1 { font-size: 20px; margin: 0 0 4px; }
h2 { font-size: 16px; margin: 28px 0 8px; }
h3 { font-size: 14px; margin: 18px 0 6px; color: var(--ink-2); }
.sub { color: var(--ink-2); margin: 0 0 16px; }
section { background: var(--surface); border: 1px solid var(--border);
  border-radius: 8px; padding: 16px; margin: 16px 0; }
table { border-collapse: collapse; width: 100%; }
th { text-align: left; color: var(--ink-2); font-weight: 600;
  border-bottom: 1px solid var(--axis); padding: 4px 10px 4px 0; }
td { border-bottom: 1px solid var(--grid); padding: 4px 10px 4px 0;
  font-variant-numeric: tabular-nums; }
.sparks { display: grid; grid-template-columns: repeat(auto-fill, minmax(260px, 1fr));
  gap: 10px; }
.spark { border: 1px solid var(--grid); border-radius: 6px; padding: 6px 8px; }
.spark .name { color: var(--ink-2); font-size: 12px; }
.spark .val { float: right; color: var(--muted); font-size: 12px;
  font-variant-numeric: tabular-nums; }
svg { display: block; width: 100%; height: auto; }
.badge { display: inline-block; border: 1px solid var(--border);
  border-radius: 10px; padding: 0 8px; font-size: 12px; white-space: nowrap; }
.pass { color: var(--good); } .fail { color: var(--crit); }
.wf-label { font-size: 11px; fill: var(--ink-2); }
.wf-dur { font-size: 11px; fill: var(--muted); }
.cellhead { color: var(--muted); font-size: 12px; }
"""


def _esc(v) -> str:
    return html.escape(str(v), quote=True)


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return f"{v:.4g}"
    return _esc(v)


def _sparkline(series: Sequence[float], bands: list[tuple[int, int]],
               n_buckets: int) -> str:
    """One inline-SVG sparkline: single series (no legend — the tile
    names it), thin line, no axes beyond a baseline, alert tick windows
    as translucent bands behind the line."""
    n = len(series)
    if n == 0:
        return "<svg viewBox='0 0 240 44'></svg>"
    xs = [float(v) if v is not None else 0.0 for v in series]
    lo, hi = min(xs), max(xs)
    span = (hi - lo) or 1.0
    w, h, pad = _W, _H, _PAD
    step = (w - 2 * pad) / max(n - 1, 1)

    def x(i):
        return pad + i * step

    def y(v):
        return h - pad - (v - lo) / span * (h - 2 * pad)

    parts = [f"<svg viewBox='0 0 {w} {h}' preserveAspectRatio='none' "
             f"role='img'>"]
    for b0, b1 in bands:
        b0 = max(0, min(b0, n_buckets - 1))
        b1 = max(b0, min(b1, n_buckets - 1))
        parts.append(f"<rect x='{x(b0):.1f}' y='0' "
                     f"width='{max(x(b1) - x(b0), 2.0):.1f}' height='{h}' "
                     f"fill='var(--band)'/>")
    parts.append(f"<line x1='{pad}' y1='{h - pad}' x2='{w - pad}' "
                 f"y2='{h - pad}' stroke='var(--axis)' stroke-width='1'/>")
    pts = " ".join(f"{x(i):.1f},{y(v):.1f}" for i, v in enumerate(xs))
    parts.append(f"<polyline points='{pts}' fill='none' "
                 f"stroke='var(--series)' stroke-width='1.5' "
                 f"stroke-linejoin='round'/>")
    parts.append("</svg>")
    return "".join(parts)


def _severity_badge(sev: str) -> str:
    color, icon = _SEVERITY.get(sev, _SEVERITY["info"])
    return (f"<span class='badge' style='color:{color}'>"
            f"{icon} {_esc(sev)}</span>")


def _alert_rows(alerts: list[dict]) -> str:
    rows = []
    for a in alerts:
        win = ("&#8212;" if a.get("first_tick") is None else
               f"{a['first_tick']}&#8211;{a['last_tick']}")
        tenant = f" tenant={a['tenant']}" if "tenant" in a else ""
        rows.append(
            "<tr>"
            f"<td>{_esc(a.get('cell', ''))}</td>"
            f"<td>{_esc(a.get('rule', ''))}{tenant}</td>"
            f"<td>{_esc(a.get('channel', ''))}</td>"
            f"<td>{_esc(a.get('detector', ''))}</td>"
            f"<td>{_severity_badge(a.get('severity', 'info'))}</td>"
            f"<td>{_fmt(a.get('peak_stat', ''))}</td>"
            f"<td>{_fmt(a.get('threshold', ''))}</td>"
            f"<td>{win}</td></tr>")
    return "".join(rows)


def _cell_section(rec: dict, alerts: list[dict]) -> str:
    obs = rec.get("obs") or {}
    hist = obs.get("history") or {}
    channels = hist.get("channels") or {}
    stride = int(hist.get("stride", 1)) or 1
    ticks = int(hist.get("ticks", 0))
    name = rec.get("name", "?")
    out = [f"<h3>cell <code>{_esc(name)}</code> "
           f"<span class='cellhead'>({ticks} ticks, stride {stride})"
           f"</span></h3>"]
    if not channels:
        out.append("<p class='sub'>no ring history embedded "
                   "(obs disabled for this cell)</p>")
        return "".join(out)
    by_channel: dict[str, list[tuple[int, int]]] = {}
    for a in alerts:
        if a.get("first_tick") is None:
            continue
        by_channel.setdefault(a.get("channel", ""), []).append(
            (int(a["first_tick"]) // stride, int(a["last_tick"]) // stride))
    n_buckets = max((len(v) for v in channels.values()), default=0)
    out.append("<div class='sparks'>")
    for ch, series in channels.items():
        last = series[-1] if series else 0
        out.append(
            "<div class='spark'>"
            f"<span class='name'>{_esc(ch)}</span>"
            f"<span class='val'>last {_fmt(last)}</span>"
            f"{_sparkline(series, by_channel.get(ch, []), n_buckets)}"
            "</div>")
    out.append("</div>")
    return "".join(out)


def _waterfall(trace: dict, max_spans: int = 48) -> str:
    evs = [e for e in trace.get("traceEvents", [])
           if e.get("ph") == "X" and isinstance(e.get("dur"), (int, float))]
    if not evs:
        return "<p class='sub'>no trace artifact found</p>"
    evs.sort(key=lambda e: e["ts"])
    if len(evs) > max_spans:
        keep = sorted(evs, key=lambda e: -e["dur"])[:max_spans]
        dropped = len(evs) - max_spans
        evs = sorted(keep, key=lambda e: e["ts"])
    else:
        dropped = 0
    t0 = min(e["ts"] for e in evs)
    t1 = max(e["ts"] + e["dur"] for e in evs)
    total = (t1 - t0) or 1.0
    row_h, label_w, w = 18, 190, 760
    h = row_h * len(evs) + 6
    parts = [f"<svg viewBox='0 0 {w} {h}'>"]
    for i, e in enumerate(evs):
        y = 3 + i * row_h
        bx = label_w + (e["ts"] - t0) / total * (w - label_w - 60)
        bw = max(e["dur"] / total * (w - label_w - 60), 1.5)
        err = isinstance(e.get("args"), dict) and e["args"].get("error")
        fill = "var(--crit)" if err else "var(--series)"
        label = e["name"] + (f" ⚠ {e['args']['error']}" if err else "")
        parts.append(f"<text x='0' y='{y + 12}' class='wf-label'>"
                     f"{_esc(label[:30])}</text>")
        parts.append(f"<rect x='{bx:.1f}' y='{y + 2}' width='{bw:.1f}' "
                     f"height='{row_h - 6}' rx='2' fill='{fill}'/>")
        parts.append(f"<text x='{bx + bw + 4:.1f}' y='{y + 12}' "
                     f"class='wf-dur'>{e['dur'] / 1e3:.1f}ms</text>")
    parts.append("</svg>")
    note = (f"<p class='sub'>showing the {max_spans} longest of "
            f"{len(evs) + dropped} spans</p>" if dropped else "")
    return note + "".join(parts)


def _metrics_table(metrics: dict) -> str:
    if not metrics:
        return "<p class='sub'>no metrics snapshot in manifest</p>"
    rows = []
    for name, snap in sorted(metrics.items()):
        if snap.get("type") == "histogram":
            val = (f"n={snap['count']} sum={_fmt(snap['sum'])} "
                   f"min={_fmt(snap.get('min'))} max={_fmt(snap.get('max'))}")
        else:
            val = _fmt(snap.get("value"))
        rows.append(f"<tr><td><code>{_esc(name)}</code></td>"
                    f"<td>{_esc(snap.get('type', ''))}</td>"
                    f"<td>{val}</td></tr>")
    return ("<table><tr><th>metric</th><th>type</th><th>value</th></tr>"
            + "".join(rows) + "</table>")


def _bench_table(bench_docs: dict) -> str:
    if not bench_docs:
        return "<p class='sub'>no BENCH_*.json artifacts found</p>"
    rows = []
    for fname, doc in sorted(bench_docs.items()):
        crit = doc.get("criteria", {})
        for key, ok in sorted(crit.items()):
            mark = ("<span class='pass'>✓ pass</span>" if ok
                    else "<span class='fail'>✗ FAIL</span>")
            rows.append(f"<tr><td>{_esc(fname)}</td>"
                        f"<td><code>{_esc(key)}</code></td>"
                        f"<td>{mark}</td></tr>")
    if not rows:
        return "<p class='sub'>bench artifacts carry no criteria</p>"
    return ("<table><tr><th>artifact</th><th>criterion</th><th>status</th>"
            "</tr>" + "".join(rows) + "</table>")


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def render_dashboard(manifest, out_path: str, *, results: dict | None = None,
                     trace: dict | None = None,
                     bench_docs: dict | None = None) -> str:
    """Render the report HTML to ``out_path`` and return the path.

    ``manifest`` is a manifest dict or a path to one; artifact paths in
    the manifest resolve relative to the manifest's directory (the
    layout a CI artifact download preserves).  ``results`` / ``trace``
    / ``bench_docs`` override artifact loading for in-process use.
    """
    base_dir = "."
    if isinstance(manifest, str):
        base_dir = os.path.dirname(os.path.abspath(manifest))
        with open(manifest) as f:
            manifest = json.load(f)

    def _artifact(key):
        p = (manifest.get("artifacts") or {}).get(key)
        if not p:
            return None
        cands = [p, os.path.join(base_dir, os.path.basename(p))]
        for c in cands:
            doc = _read_json(c)
            if doc is not None:
                return doc
        return None

    if results is None:
        results = _artifact("results")
    if trace is None:
        trace = _artifact("trace") or {}
    if bench_docs is None:
        bench_docs = {}
        try:
            names = sorted(os.listdir(base_dir))
        except OSError:
            names = []
        for fname in names:
            if fname.startswith("BENCH_") and fname.endswith(".json") \
                    and not any(s in fname for s in
                                (".manifest", ".sweep", ".trace")):
                doc = _read_json(os.path.join(base_dir, fname))
                if isinstance(doc, dict):
                    bench_docs[fname] = doc

    cells = (results or {}).get("cells") or manifest.get("cells") or []
    alerts = manifest.get("alerts") or []
    if not alerts:
        alerts = [a for rec in cells
                  for a in ((rec.get("obs") or {}).get("alerts") or [])]

    body = []
    run_id = manifest.get("run_id", manifest.get("created", ""))
    body.append(f"<h1>sweep report <code>{_esc(run_id)}</code></h1>")
    body.append(f"<p class='sub'>engine {_esc(manifest.get('engine', '?'))}"
                f" &middot; {len(cells)} cells &middot; wall "
                f"{_fmt(manifest.get('wall_s', 0))}s &middot; "
                f"{len(alerts)} fired alerts</p>")

    body.append("<section id='alerts'><h2>fired alerts</h2>")
    if alerts:
        body.append("<table><tr><th>cell</th><th>rule</th><th>channel</th>"
                    "<th>detector</th><th>severity</th><th>peak</th>"
                    "<th>threshold</th><th>tick window</th></tr>"
                    + _alert_rows(alerts) + "</table>")
    else:
        body.append("<p class='sub'>✓ no alerts fired</p>")
    body.append("</section>")

    body.append("<section id='cells'><h2>ring channels per cell</h2>")
    for rec in cells:
        cell_alerts = [a for a in alerts
                       if a.get("cell", "") in ("", rec.get("name"))]
        body.append(_cell_section(rec, cell_alerts))
    if not cells:
        body.append("<p class='sub'>no cell records found</p>")
    body.append("</section>")

    body.append("<section id='trace'><h2>span waterfall</h2>"
                + _waterfall(trace or {}) + "</section>")
    body.append("<section id='metrics'><h2>metrics snapshot</h2>"
                + _metrics_table(manifest.get("metrics") or {})
                + "</section>")
    body.append("<section id='bench'><h2>bench criteria</h2>"
                + _bench_table(bench_docs) + "</section>")

    doc = ("<!doctype html><html lang='en'><head><meta charset='utf-8'>"
           "<meta name='viewport' content='width=device-width,"
           "initial-scale=1'>"
           "<title>sweep report</title>"
           f"<style>{_CSS}</style></head><body>"
           + "".join(body) + "</body></html>")
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path


def main(argv: Sequence[str] | None = None) -> str:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.dashboard",
        description="Render a static HTML report from a sweep manifest.")
    ap.add_argument("manifest", help="path to a run manifest JSON")
    ap.add_argument("-o", "--out", default="report.html")
    ns = ap.parse_args(argv)
    path = render_dashboard(ns.manifest, ns.out)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
