"""Post-run serving report: latency / occupancy / cache / route summary.

:func:`build_report` renders the metrics registry (plus, when given, a
``CoScheduler``'s occupancy view and the signal plan-cache counters)
into one JSON-serializable dict; :func:`render_report` formats it as the
text block the serving bench prints after a sweep.  The latency
percentiles come from the same histograms the instrumentation hooks
fed, so the printed p50/p95 per graph match
``registry.histogram(...).percentile(...)`` by construction — the
report is a *view*, it never re-measures.

The report dict carries a ``schema_version`` so the trajectory tooling
(``benchmarks/trajectory.py``, the ``BENCH_PR*.json`` files) can evolve
the shape without breaking old entries.
"""

from __future__ import annotations

from typing import Optional

from .metrics import MetricsRegistry, get_registry

__all__ = ["REPORT_SCHEMA_VERSION", "build_report", "render_report"]

REPORT_SCHEMA_VERSION = 1

_LAT_PREFIX = "service.latency_us."


def build_report(scheduler=None, registry: Optional[MetricsRegistry] = None,
                 dsp_target: Optional[float] = None,
                 signals=None) -> dict:
    """Summarize a serving run.

    ``scheduler`` (a :class:`~repro_torch.serving.CoScheduler`, optional)
    contributes the DSP/LLM occupancy split; ``dsp_target`` records the
    cost_balanced target next to it.  ``signals`` (a
    :class:`~repro_torch.serving.SignalService`, optional) contributes its
    SigSched dispatch counters — cross-graph hit rate, wave splits,
    deferrals, promotions.  Everything else comes from the metrics
    registry snapshot and the signal plan cache.
    """
    reg = registry or get_registry()
    snap = reg.snapshot()

    latency: dict = {}
    for name, summ in snap["histograms"].items():
        if not name.startswith(_LAT_PREFIX):
            continue
        tail = name[len(_LAT_PREFIX):]
        if "/" in tail:
            graph, out = tail.split("/", 1)
            latency.setdefault(graph, {"outputs": {}})
            latency[graph].setdefault("outputs", {})[out] = summ
        else:
            latency.setdefault(tail, {"outputs": {}}).update(summ)

    backend: dict = {}
    for name, v in snap["counters"].items():
        if name.startswith("backend."):
            _, be, key = name.split(".", 2)
            backend.setdefault(be, {})[key] = v

    from ..signal import plan_cache_info
    cache = plan_cache_info()["by_backend"]
    for b in cache.values():
        tot = b["hits"] + b["misses"]
        b["hit_rate"] = b["hits"] / tot if tot else 0.0

    rep = {
        "schema_version": REPORT_SCHEMA_VERSION,
        "latency_us": latency,
        "plan_cache": cache,
        "backend_routes": backend,
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "histograms": {k: v for k, v in snap["histograms"].items()
                       if not k.startswith(_LAT_PREFIX)},
    }
    if scheduler is not None:
        occ = scheduler.occupancy()
        rep["occupancy"] = dict(occ)
        if dsp_target is not None:
            rep["occupancy"]["dsp_target"] = float(dsp_target)
            rep["occupancy"]["dsp_error"] = abs(occ["dsp_share"]
                                                - float(dsp_target))
    if signals is None and scheduler is not None:
        signals = getattr(scheduler, "signals", None)
    sig = getattr(signals, "scheduler", None) if signals is not None \
        else None
    if sig is not None:
        sched = dict(sig.stats)
        d = sched.get("dispatches", 0)
        sched["cross_graph_hit_rate"] = \
            sched.get("cross_graph_batches", 0) / d if d else 0.0
        sched["row_budget"] = sig.row_budget
        sched["backlog_rows"] = sig.backlog_rows()
        rep["scheduler"] = sched
    return rep


def _fmt_lat(summ: dict) -> str:
    return (f"n={summ.get('count', 0):<6} p50={summ.get('p50', 0.0):>10.1f} "
            f"p95={summ.get('p95', 0.0):>10.1f} "
            f"p99={summ.get('p99', 0.0):>10.1f} "
            f"mean={summ.get('mean', 0.0):>10.1f}")


def render_report(rep: dict) -> str:
    """Human-readable text form of :func:`build_report`'s dict."""
    lines = ["== serving report (schema v%d) ==" % rep["schema_version"]]
    lines.append("-- request latency, admission->emit (us) --")
    for graph, entry in sorted(rep.get("latency_us", {}).items()):
        if "count" in entry:
            lines.append(f"  {graph:<24} {_fmt_lat(entry)}")
        for out, summ in sorted(entry.get("outputs", {}).items()):
            lines.append(f"  {graph + '/' + out:<24} {_fmt_lat(summ)}")
    occ = rep.get("occupancy")
    if occ:
        lines.append("-- occupancy (perf-model cycles) --")
        lines.append(f"  dsp={occ['dsp_cycles']} llm={occ['llm_cycles']} "
                     f"dsp_share={occ['dsp_share']:.3f}"
                     + (f" target={occ['dsp_target']:.3f} "
                        f"error={occ['dsp_error']:.3f}"
                        if "dsp_target" in occ else ""))
    sched = rep.get("scheduler")
    if sched:
        lines.append("-- SigSched dispatch --")
        lines.append(
            f"  dispatches={sched['dispatches']} "
            f"cross_graph={sched['cross_graph_batches']} "
            f"(hit_rate={sched['cross_graph_hit_rate']:.3f}) "
            f"wave_splits={sched['wave_splits']}")
        lines.append(
            f"  deferrals={sched['deferrals']} "
            f"promotions={sched['bucket_promotions']} "
            f"starvation_picks={sched['starvation_picks']} "
            f"backlog_rows={sched['backlog_rows']}")
    lines.append("-- plan cache (per backend) --")
    for be, b in sorted(rep.get("plan_cache", {}).items()):
        lines.append(f"  {be:<12} entries={b['entries']:<5} "
                     f"hits={b['hits']:<6} misses={b['misses']:<6} "
                     f"hit_rate={b['hit_rate']:.3f}")
    routes = rep.get("backend_routes", {})
    if routes:
        lines.append("-- lowering routes (per compile, cumulative) --")
        for be, keys in sorted(routes.items()):
            kv = " ".join(f"{k}={v}" for k, v in sorted(keys.items()))
            lines.append(f"  {be:<12} {kv}")
    hists = rep.get("histograms", {})
    if hists:
        lines.append("-- distributions --")
        for k, summ in sorted(hists.items()):
            lines.append(f"  {k:<28} n={summ['count']:<6} "
                         f"p50={summ['p50']:.3f} p95={summ['p95']:.3f} "
                         f"max={summ['max']:.3f}")
    counters = {k: v for k, v in rep.get("counters", {}).items()
                if not k.startswith("backend.")}
    if counters:
        lines.append("-- counters --")
        for k, v in sorted(counters.items()):
            lines.append(f"  {k:<36} {v}")
    gauges = rep.get("gauges", {})
    if gauges:
        lines.append("-- gauges (last value) --")
        for k, v in sorted(gauges.items()):
            lines.append(f"  {k:<36} {v:.3f}")
    return "\n".join(lines)
