"""SigTrace observability: chrome-tracing + metrics for the SigStream stack.

Three pieces (see ``docs/observability.md``):

  * :mod:`repro_torch.obs.trace`   — per-tick Chrome Trace Event recorder
    (spans / instants / counter tracks, pid/tid lanes per component),
    exported as ``chrome://tracing`` / Perfetto-loadable JSON;
  * :mod:`repro_torch.obs.metrics` — process-wide counters / gauges /
    p50-p95-p99 histograms fed by hooks in the serving, streaming and
    backend layers;
  * :mod:`repro_torch.obs.report`  — the post-run latency / occupancy /
    cache-hit-rate summary built from those metrics.

**The switch.**  Everything is off by default and *zero-cost when off*:
every instrumentation site in the hot paths is guarded by

    if obs.ENABLED:
        obs.complete("SignalService", "bucket_fill", t0, args={...})

— one module-attribute load and one branch, no allocation, no calls.
:func:`enable` / :func:`disable` flip the flag; :func:`enable_from_env`
honors ``REPRO_TRACE`` (``1``/``true`` to enable, any other non-empty
value is used as the trace-export path) so benches and services can be
traced without touching code.  Instrumentation never changes computed
arrays — hooks record host-side integers (shapes, counts, clock reads)
only, outside the compiled programs.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from .trace import (Tracer, get_tracer, reset_tracer, validate_trace,
                    TraceError)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, reset_registry)
from .report import REPORT_SCHEMA_VERSION, build_report, render_report

__all__ = ["ENABLED", "enable", "disable", "enabled", "enable_from_env",
           "reset", "now", "tracer", "metrics",
           "complete", "instant", "counter_track", "span",
           "Tracer", "get_tracer", "reset_tracer", "validate_trace",
           "TraceError", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "get_registry", "reset_registry",
           "REPORT_SCHEMA_VERSION", "build_report", "render_report",
           "default_trace_path"]

# THE hot-path switch: instrumentation sites read this module attribute
# and branch — nothing below runs while it is False.
ENABLED = False

_DEFAULT_TRACE_PATH = "artifacts/repro_trace.json"
_trace_path: Optional[str] = None


def enable(trace_path: Optional[str] = None) -> None:
    """Turn instrumentation on.  ``trace_path`` (optional) is where
    :func:`default_trace_path` / bench shutdown hooks export the trace."""
    global ENABLED, _trace_path
    get_tracer()            # anchor the trace clock before the first hook
    ENABLED = True
    if trace_path is not None:
        _trace_path = trace_path


def disable() -> None:
    global ENABLED
    ENABLED = False


def enabled() -> bool:
    return ENABLED


def reset() -> None:
    """Disable AND drop all recorded state (fresh tracer + registry)."""
    disable()
    reset_tracer()
    reset_registry()


def enable_from_env(env: str = "REPRO_TRACE") -> bool:
    """Enable instrumentation when ``$REPRO_TRACE`` is set: ``1`` /
    ``true`` / ``yes`` enable with the default export path; ``0`` /
    ``false`` / empty leave it off; anything else is taken as the
    export path.  Returns whether instrumentation is now enabled."""
    val = os.environ.get(env, "").strip()
    if not val or val.lower() in ("0", "false", "no"):
        return ENABLED
    if val.lower() in ("1", "true", "yes"):
        enable()
    else:
        enable(trace_path=val)
    return True


def default_trace_path() -> str:
    """Where to export the trace: the ``enable()`` argument, the
    ``REPRO_TRACE`` path, or ``artifacts/repro_trace.json``."""
    return _trace_path or _DEFAULT_TRACE_PATH


# -- hook helpers (call ONLY under ``if obs.ENABLED:``) ---------------------

now = time.perf_counter_ns


def tracer() -> Tracer:
    return get_tracer()


def metrics() -> MetricsRegistry:
    return get_registry()


def complete(lane: str, name: str, t0_ns: int, **args) -> None:
    """Record an X span begun at ``t0_ns`` (from :func:`now`)."""
    get_tracer().complete(lane, name, t0_ns, args or None)


def instant(lane: str, name: str, **args) -> None:
    get_tracer().instant(lane, name, args or None)


def counter_track(name: str, **values) -> None:
    get_tracer().counter(name, values)


def span(lane: str, name: str, **args):
    """Context-manager span (user code / non-hot paths)."""
    return get_tracer().span(lane, name, args or None)
