"""Process-wide metrics registry: counters / gauges / histograms with
JSONL and Prometheus-textfile export.

Deliberately tiny (stdlib only, no client-library dependency): the
point is ONE place where driver-level telemetry accumulates — compile
times, chunk walls, benchmark timer samples — so manifests and bench
artifacts can snapshot it instead of every module keeping ad-hoc
stopwatch variables.

A copy of ``repro/obs/metrics.py``.
"""
from __future__ import annotations

import json
import math
import re
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "REGISTRY", "registry", "series_key"]


class Counter:
    """Monotone event count."""

    kind = "counter"

    def __init__(self, family: str = "", labels: dict | None = None):
        self.value = 0.0
        self.family = family
        self.labels = dict(labels or {})

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v

    def snapshot(self) -> dict:
        d = {"type": self.kind, "value": self.value}
        if self.labels:
            d["labels"] = dict(self.labels)
        return d


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, family: str = "", labels: dict | None = None):
        self.value = 0.0
        self.family = family
        self.labels = dict(labels or {})

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        d = {"type": self.kind, "value": self.value}
        if self.labels:
            d["labels"] = dict(self.labels)
        return d


class Histogram:
    """Streaming count / sum / min / max summary (no buckets: the
    exporters emit ``_count`` / ``_sum`` / ``_min`` / ``_max`` series,
    which is what the bench criteria and manifests actually consume)."""

    kind = "histogram"

    def __init__(self, family: str = "", labels: dict | None = None):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.family = family
        self.labels = dict(labels or {})

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def snapshot(self) -> dict:
        d = {"type": self.kind, "count": self.count, "sum": self.total,
             "min": (None if self.count == 0 else self.min),
             "max": (None if self.count == 0 else self.max)}
        if self.labels:
            d["labels"] = dict(self.labels)
        return d


def series_key(name: str, labels: dict | None) -> str:
    """Canonical ``family{k="v",...}`` series identity (sorted label
    order, so kwargs order never creates duplicate series)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Thread-safe series -> metric map (get-or-create per kind).

    A *family* is the bare metric name; a *series* is family + labels
    (``counter("alerts.fired", rule="oom-burst", severity="page")``).
    Unlabeled calls keep their historical single-series behavior.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._help: dict[str, str] = {}

    def _get(self, name: str, cls, labels: dict):
        labels = {k: str(v) for k, v in labels.items()}
        key = series_key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(family=name, labels=labels)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {key!r} is a {m.kind}, not a "
                                f"{cls.kind}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, Counter, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, Gauge, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(name, Histogram, labels)

    def set_help(self, name: str, text: str) -> None:
        """Register the ``# HELP`` line for a metric family."""
        with self._lock:
            self._help[name] = text

    def snapshot(self) -> dict:
        with self._lock:
            return {name: m.snapshot()
                    for name, m in sorted(self._metrics.items())}

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- exporters -----------------------------------------------------
    def write_jsonl(self, path: str, **extra) -> None:
        """Append one timestamped snapshot line (metrics-over-time logs:
        each sweep / bench run appends, nothing is overwritten)."""
        rec = {"ts": time.time(), "metrics": self.snapshot(), **extra}
        with open(path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")

    def write_textfile(self, path: str) -> None:
        """Prometheus textfile-collector exposition format.

        ``# HELP`` / ``# TYPE`` are emitted ONCE per metric *family*
        (labeled series of one family share a single header block, as
        the exposition format requires — a repeated TYPE line is a
        parse error for promtool), label values are escaped per the
        format (backslash, double quote, newline), and histograms
        expand to ``_count`` / ``_sum`` / ``_min`` / ``_max`` samples.
        """
        with self._lock:
            items = sorted(self._metrics.items(),
                           key=lambda kv: (kv[1].family, kv[0]))
            helps = dict(self._help)
        lines: list[str] = []
        seen: set[str] = set()
        for key, m in items:
            pname = _prom_name(m.family or key)
            snap = m.snapshot()
            if m.family not in seen:
                seen.add(m.family)
                help_text = helps.get(m.family, m.family or key)
                lines.append(f"# HELP {pname} {_escape_help(help_text)}")
                ptype = "summary" if snap["type"] == "histogram" else snap["type"]
                lines.append(f"# TYPE {pname} {ptype}")
            lbl = _prom_labels(m.labels)
            if snap["type"] == "histogram":
                lines.append(f"{pname}_count{lbl} {snap['count']}")
                lines.append(f"{pname}_sum{lbl} {_prom_val(snap['sum'])}")
                for k in ("min", "max"):
                    if snap[k] is not None:
                        lines.append(f"{pname}_{k}{lbl} {_prom_val(snap[k])}")
            else:
                lines.append(f"{pname}{lbl} {_prom_val(snap['value'])}")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


def _prom_name(name: str) -> str:
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return out if re.match(r"^[a-zA-Z_:]", out) else "_" + out


def _escape_label(v: str) -> str:
    """Label-value escaping per the exposition format."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP text escapes backslash and newline (but not quotes)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{re.sub(r"[^a-zA-Z0-9_]", "_", k)}="{_escape_label(str(v))}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _prom_val(v: float) -> str:
    return repr(float(v))


# the process-wide default registry (what the engines / benches use)
REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return REGISTRY
