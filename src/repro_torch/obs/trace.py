"""SigTrace: a low-overhead Chrome Trace Event recorder.

One process-wide :class:`Tracer` collects timeline events from the
serving / streaming / backend instrumentation hooks and exports them in
the Chrome Trace Event Format (the ``{"traceEvents": [...]}`` JSON that
``chrome://tracing`` and Perfetto load directly).  Design constraints,
in order:

  * **zero-cost when off** — every instrumentation site in the hot
    paths guards itself with ``if obs.ENABLED:`` (one module-attribute
    load + branch); nothing here is even called while tracing is
    disabled.  Timestamps are taken with ``time.perf_counter_ns`` and
    events are plain dicts appended under a lock, so an *enabled*
    tracer stays host-side cheap and never touches device arrays.
  * **lanes, not threads** — ``tid`` identifies a logical component
    (``CoScheduler``, ``SignalService``, ``DecodeWave``, ``Streaming``,
    one lane per served graph), mapped to stable small integers and
    named via ``M`` metadata events, so a serving tick reads as
    parallel swimlanes in the viewer regardless of the host threading.
  * **well-formed by construction** — block spans are recorded as
    ``X`` *complete* events (begin timestamp + duration captured at
    exit), so a crash mid-span can at worst lose the span, never
    unbalance the stream; the explicit :meth:`Tracer.begin` /
    :meth:`Tracer.end` API exists for spans that cannot wrap a block
    and is validated by :func:`validate_trace`.

Event vocabulary used by the instrumentation (see
``docs/observability.md`` for the walkthrough of one serving tick):

  ``X``  spans    tick / bucket_fill / core_call / prefill /
                  decode_step / stream_tick / stream_core
  ``i``  instants compile (per-bucket, with the backend's
                  ``lowering_report`` route counts), admit
  ``C``  counters occupancy (dsp/llm cycle split), queue_depth,
                  plan_cache hit rate per backend
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Tracer", "get_tracer", "reset_tracer", "validate_trace",
           "TraceError"]

_PID = 1                       # one process == one trace-viewer process row


class Tracer:
    """Thread-safe in-memory Chrome Trace Event recorder."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._lanes: Dict[str, int] = {}
        self._t0 = time.perf_counter_ns()
        self._begin_stacks: Dict[int, List[str]] = {}

    # -- time ---------------------------------------------------------------
    @staticmethod
    def now() -> int:
        """Raw monotonic nanoseconds (pass back to :meth:`complete`)."""
        return time.perf_counter_ns()

    def _ts(self, ns: int) -> float:
        """Trace timestamp: microseconds since tracer start (clamped at
        0 for spans begun before the tracer existed — e.g. a hook that
        read its start stamp just as tracing was being enabled)."""
        return max(0.0, (ns - self._t0) / 1e3)

    # -- lanes --------------------------------------------------------------
    def lane(self, label: str) -> int:
        """Stable tid for a component label (allocated on first use)."""
        tid = self._lanes.get(label)
        if tid is None:
            with self._lock:
                tid = self._lanes.setdefault(label, len(self._lanes) + 1)
        return tid

    # -- event emitters -----------------------------------------------------
    def _append(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def complete(self, lane: str, name: str, t0_ns: int,
                 args: Optional[dict] = None, cat: str = "repro") -> None:
        """Record an ``X`` complete event begun at ``t0_ns`` (a value
        from :meth:`now`) and ending now."""
        t1 = time.perf_counter_ns()
        ev = {"ph": "X", "pid": _PID, "tid": self.lane(lane),
              "name": name, "cat": cat, "ts": self._ts(t0_ns),
              "dur": max(0.0, (t1 - t0_ns) / 1e3)}
        if args:
            ev["args"] = args
        self._append(ev)

    def begin(self, lane: str, name: str,
              args: Optional[dict] = None, cat: str = "repro") -> None:
        tid = self.lane(lane)
        ev = {"ph": "B", "pid": _PID, "tid": tid, "name": name,
              "cat": cat, "ts": self._ts(time.perf_counter_ns())}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)
            self._begin_stacks.setdefault(tid, []).append(name)

    def end(self, lane: str, args: Optional[dict] = None,
            cat: str = "repro") -> None:
        tid = self.lane(lane)
        with self._lock:
            stack = self._begin_stacks.get(tid, [])
            if not stack:
                raise TraceError(f"end() without begin() on lane {lane!r}")
            name = stack.pop()
            ev = {"ph": "E", "pid": _PID, "tid": tid, "name": name,
                  "cat": cat, "ts": self._ts(time.perf_counter_ns())}
            if args:
                ev["args"] = args
            self._events.append(ev)

    def span(self, lane: str, name: str, args: Optional[dict] = None,
             cat: str = "repro"):
        """Context manager recording one ``X`` span around a block."""
        return _Span(self, lane, name, args, cat)

    def instant(self, lane: str, name: str,
                args: Optional[dict] = None, cat: str = "repro") -> None:
        ev = {"ph": "i", "pid": _PID, "tid": self.lane(lane),
              "name": name, "cat": cat, "s": "t",
              "ts": self._ts(time.perf_counter_ns())}
        if args:
            ev["args"] = args
        self._append(ev)

    def counter(self, name: str, values: Dict[str, float],
                cat: str = "repro") -> None:
        """Record a ``C`` counter sample; each key in ``values`` becomes
        one series on the counter track ``name``."""
        self._append({"ph": "C", "pid": _PID, "tid": self.lane("counters"),
                      "name": name, "cat": cat,
                      "ts": self._ts(time.perf_counter_ns()),
                      "args": {k: float(v) for k, v in values.items()}})

    # -- export -------------------------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._begin_stacks.clear()
            self._t0 = time.perf_counter_ns()

    def _metadata_events(self) -> List[dict]:
        meta = [{"ph": "M", "pid": _PID, "tid": 0, "ts": 0,
                 "name": "process_name", "args": {"name": "repro"}}]
        for label, tid in sorted(self._lanes.items(), key=lambda kv: kv[1]):
            meta.append({"ph": "M", "pid": _PID, "tid": tid, "ts": 0,
                         "name": "thread_name", "args": {"name": label}})
            meta.append({"ph": "M", "pid": _PID, "tid": tid, "ts": 0,
                         "name": "thread_sort_index",
                         "args": {"sort_index": tid}})
        return meta

    def to_dict(self) -> dict:
        with self._lock:
            events = list(self._events)
        return {"traceEvents": self._metadata_events() + events,
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the trace JSON to ``path`` and return the path."""
        import os
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


class _Span:
    __slots__ = ("tracer", "lane", "name", "args", "cat", "_t0")

    def __init__(self, tracer, lane, name, args, cat):
        self.tracer, self.lane, self.name = tracer, lane, name
        self.args, self.cat = args, cat

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.tracer.complete(self.lane, self.name, self._t0,
                             self.args, self.cat)
        return False


# --------------------------------------------------------------------------
# Process-wide tracer
# --------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def get_tracer() -> Tracer:
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer()
    return _TRACER


def reset_tracer() -> Tracer:
    """Drop the process tracer (tests; a fresh t0 and empty event list)."""
    global _TRACER
    _TRACER = Tracer()
    return _TRACER


# --------------------------------------------------------------------------
# Validation (shared by tests and the CI artifact check)
# --------------------------------------------------------------------------

class TraceError(ValueError):
    pass


def validate_trace(path_or_dict) -> dict:
    """Validate a Chrome Trace Event JSON file (or already-loaded dict).

    Checks the invariants the instrumentation promises: the container
    shape, per-``tid`` balanced ``B``/``E`` nesting, non-negative ``X``
    durations, per-``tid`` monotonic timestamps in record order for
    non-``X`` phases, and non-negative counter values.  Returns summary
    stats (event counts per phase, lanes) on success; raises
    :class:`TraceError` otherwise.
    """
    if isinstance(path_or_dict, dict):
        doc = path_or_dict
    else:
        with open(path_or_dict) as f:
            doc = json.load(f)
    if "traceEvents" not in doc or not isinstance(doc["traceEvents"], list):
        raise TraceError("missing traceEvents list")
    per_tid_stack: Dict[int, List[str]] = {}
    per_tid_last_ts: Dict[int, float] = {}
    phases: Dict[str, int] = {}
    lanes = set()
    for i, ev in enumerate(doc["traceEvents"]):
        ph = ev.get("ph")
        phases[ph] = phases.get(ph, 0) + 1
        if ph == "M":
            continue
        for field in ("pid", "tid", "ts", "name"):
            if field not in ev:
                raise TraceError(f"event {i} missing {field!r}: {ev}")
        tid = ev["tid"]
        ts = float(ev["ts"])
        lanes.add(tid)
        if ts < 0:
            raise TraceError(f"event {i} has negative ts: {ev}")
        if ph == "X":
            if float(ev.get("dur", -1)) < 0:
                raise TraceError(f"X event {i} missing/negative dur: {ev}")
        else:
            # non-X events are recorded at their own timestamp, so per
            # tid they must be non-decreasing in record order (X spans
            # are stamped at *begin* but appended at *end*, which is
            # why they are exempt).
            last = per_tid_last_ts.get(tid)
            if last is not None and ts < last:
                raise TraceError(
                    f"event {i} ts {ts} < previous {last} on tid {tid}")
            per_tid_last_ts[tid] = ts
        if ph == "B":
            per_tid_stack.setdefault(tid, []).append(ev["name"])
        elif ph == "E":
            stack = per_tid_stack.get(tid, [])
            if not stack:
                raise TraceError(f"E event {i} without matching B: {ev}")
            stack.pop()
        elif ph == "C":
            for k, v in ev.get("args", {}).items():
                if not isinstance(v, (int, float)) or v < 0:
                    raise TraceError(
                        f"counter {ev['name']!r} series {k!r} has "
                        f"non-numeric/negative value {v!r}")
    unbalanced = {t: s for t, s in per_tid_stack.items() if s}
    if unbalanced:
        raise TraceError(f"unbalanced B events: {unbalanced}")
    return {"events": sum(v for k, v in phases.items() if k != "M"),
            "phases": phases, "lanes": sorted(lanes)}
