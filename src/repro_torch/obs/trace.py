"""Host-side span tracing: Chrome trace-event / Perfetto JSON.

A :class:`Tracer` collects "X" (complete) events — name, category,
start timestamp, duration — from :func:`span` context managers placed
around sweep-driver phases (trace build, jit compile, chunk execute,
ring drain, per-combo cohorts).  :func:`tracing` installs a global
tracer for a ``with`` region and writes the JSON on exit; when no
tracer is installed every ``span`` is a shared no-op, so the
instrumentation costs one dict lookup on the disabled path.

Load the output in ``chrome://tracing`` or https://ui.perfetto.dev.

A copy of ``repro/obs/trace.py``; the profiler hook is
``torch.profiler.record_function``.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

__all__ = ["Tracer", "span", "tracing", "current_tracer",
           "validate_trace", "profiler_annotation"]

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_tracer: Tracer | None = None


class Tracer:
    """Accumulates Chrome trace events (``ts``/``dur`` in microseconds
    relative to the tracer's epoch, per the trace-event spec)."""

    def __init__(self):
        self._epoch = time.perf_counter_ns()
        self._lock = threading.Lock()
        self.events: list[dict] = []

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._epoch) / 1e3

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "sweep", args: dict | None = None):
        t0 = self._now_us()
        error: str | None = None
        try:
            yield
        except BaseException as e:
            # close the span with an error tag and re-raise: the phase
            # still shows up in the waterfall (flagged), and the tracer
            # state stays consistent for whatever spans come after
            error = type(e).__name__
            raise
        finally:
            ev = {"name": name, "cat": cat, "ph": "X", "ts": t0,
                  "dur": self._now_us() - t0, "pid": os.getpid(),
                  "tid": threading.get_ident()}
            if args or error:
                ev["args"] = dict(args or {})
                if error:
                    ev["args"]["error"] = error
            with self._lock:
                self.events.append(ev)

    def instant(self, name: str, cat: str = "sweep",
                args: dict | None = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "ts": self._now_us(),
              "s": "p", "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def to_json(self) -> dict:
        with self._lock:
            evs = sorted(self.events, key=lambda e: e["ts"])
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


def current_tracer() -> Tracer | None:
    return _tracer


def span(name: str, cat: str = "sweep", args: dict | None = None):
    """Span against the installed tracer, or a shared no-op context."""
    t = _tracer
    return t.span(name, cat, args) if t is not None else _NULL


@contextlib.contextmanager
def tracing(path: str | None = None):
    """Install a global :class:`Tracer` for the ``with`` body; write the
    trace JSON to ``path`` on exit (even on error).  Yields the tracer.
    Nested ``tracing`` regions are refused — spans are process-global."""
    global _tracer
    t = Tracer()
    with _lock:
        if _tracer is not None:
            raise RuntimeError("a tracer is already installed")
        _tracer = t
    try:
        yield t
    finally:
        with _lock:
            _tracer = None
        if path is not None:
            t.save(path)


def profiler_annotation(name: str):
    """Optional ``torch.profiler`` hook: returns a ``record_function``
    range so obs spans also show up in torch profiler traces, or a no-op
    context when the profiler is unavailable."""
    try:
        import torch.profiler
        return torch.profiler.record_function(name)
    except Exception:
        return contextlib.nullcontext()


def validate_trace(doc) -> list[str]:
    """Schema check for a loaded (or stringified) trace document.

    Returns a list of problems (empty == valid):
      * top level is an object bearing a ``traceEvents`` list,
      * every event has name/ph/ts/pid/tid; ``X`` events have numeric
        ``dur >= 0``,
      * ``B``/``E`` events are properly nested per (pid, tid),
      * event ``ts`` are monotone non-decreasing in file order.
    """
    problems: list[str] = []
    if isinstance(doc, (str, bytes)):
        try:
            doc = json.loads(doc)
        except json.JSONDecodeError as e:
            return [f"not valid JSON: {e}"]
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["top level must be an object with a traceEvents list"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents must be a list"]
    stacks: dict[tuple, list[str]] = {}
    last_ts = None
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        missing = [k for k in ("name", "ph", "ts", "pid", "tid")
                   if k not in ev]
        if missing:
            problems.append(f"event {i}: missing {missing}")
            continue
        ts = ev["ts"]
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i}: non-numeric ts")
            continue
        if last_ts is not None and ts < last_ts:
            problems.append(f"event {i}: ts not monotone "
                            f"({ts} < {last_ts})")
        last_ts = ts
        ph = ev["ph"]
        key = (ev["pid"], ev["tid"])
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: X event needs dur >= 0")
        elif ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.setdefault(key, [])
            if not stack:
                problems.append(f"event {i}: E without matching B")
            else:
                stack.pop()
    for key, stack in stacks.items():
        if stack:
            problems.append(f"unclosed B events on {key}: {stack}")
    return problems
