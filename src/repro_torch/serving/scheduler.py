"""SigSched: the batching / dispatch brain of :class:`SignalService`.

The PyTorch port of the JAX package's ``serving/scheduler.py``: the same
decisions, tick by tick — it is host code over integer perf-model
cycles, so the two packages dispatch the same rids in the same order
with the same ``stats``.

The paper's system claim is one computing array serving DSP and DNN
work without interference; the serving-tick analogue is deciding, every
tick, WHICH padded bucket wave the array runs next.  The legacy tick
dispatched the oldest ``(graph, bucket)`` group in arrival order —
correct, but it compiled and launched identical core programs once per
registered graph name, and a large loose-deadline wave head-of-line
blocked a deadline-critical small one.  :class:`SigSched` replaces that
pick with three optimizations, none of which changes what a request
computes (scheduling changes only *when* work runs; every wave still
executes through the service's masked/padded bucket path):

* **Cross-graph batching** — requests group by the *structural
  fingerprint* of their compiled program
  (:meth:`repro_torch.core.exec_ir.ExecProgram.fingerprint` combined
  with the backend's ``cache_key``), not by registry name.  Two graphs
  that lower to the same core program stack into ONE call per tick;
  members whose registered params differ execute per-row-batched (a
  call whose params carry a leading row axis: each row's own weights,
  one launch of each kernel) or, where the params trees do not stack,
  as per-params split calls (:meth:`SignalService._stackable`).  ``stats["cross_graph_batches"]``
  counts mixed waves and the ``SigSched`` trace lane records them.
* **Deadline-aware bucket choice** — group picking is EDF over the
  queued groups with slack computed against
  :func:`repro_torch.core.perf_model.step_cost_estimate`: an under-full
  group whose every member has slack beyond ``defer_margin`` × its wave
  cost waits a tick (bounded by ``max_defers``) to join a fuller wave;
  slack-rich small-bucket requests *promote* into a fuller same-program
  larger-bucket wave (they pad up — the same results, one fewer
  launch); and the EDF pick carries a cost-aware anti-starvation
  tie-break: a group passed over ``starvation_ticks`` times preempts
  the EDF choice when the urgent group's slack covers the starved
  group's cost (unconditionally after ``4×starvation_ticks``), so
  ``deadline=inf`` traffic cannot starve under sustained finite-
  deadline load.
* **Preemptible bucket batches** — a wave above ``row_budget`` rows
  executes ``row_budget`` rows per tick through a resumable
  :class:`WaveState` (remaining requests keep their own masks /
  true lengths); urgent newcomers interleave between chunks instead of
  waiting out the whole batch.  On a meshed service the budget aligns
  up to the shard width (``SignalMesh.align_row_budget``), so only the
  remainder chunk carries pad rows.

With the default configuration (``row_budget=None``, no finite
deadlines in the queue) dispatch reduces exactly to the legacy
FIFO-oldest-group pick.

Everything here is host-side bookkeeping over the service's live queue;
the service's :meth:`SignalService._execute_wave` does the actual
padding, masking, execution and trimming.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple, TYPE_CHECKING

import numpy as np

from .. import obs

if TYPE_CHECKING:                                    # pragma: no cover
    from .signal_service import SignalRequest, SignalService

__all__ = ["SigSched", "WaveState", "ExecGroup"]


@dataclasses.dataclass
class WaveState:
    """A claimed, partially-executed bucket wave: the resumable remainder
    of a batch that exceeded the scheduler's row budget.  ``requests``
    holds the rows not yet executed, in dispatch order — each keeps its
    own true length, so every chunk recomputes its valid-frame masks
    exactly as an unsplit wave would.  Claimed requests are OUT of the
    service queue (no other pick can double-dispatch them) but still
    count as pending until their chunk runs."""
    key: Tuple
    length: int
    requests: List["SignalRequest"]
    total_rows: int
    executed_rows: int = 0
    chunks: int = 0

    @property
    def earliest_deadline(self) -> float:
        return min((r.deadline for r in self.requests), default=math.inf)

    @property
    def oldest_seq(self) -> int:
        return min((r.seq for r in self.requests), default=-1)


@dataclasses.dataclass
class ExecGroup:
    """One dispatchable unit this tick: a fresh queue group (requests
    sharing an execution key) or the remainder of a claimed wave."""
    key: Tuple
    length: int
    requests: List["SignalRequest"]
    per_row_cost: int
    wave: Optional[WaveState] = None

    @property
    def earliest_deadline(self) -> float:
        return min((r.deadline for r in self.requests), default=math.inf)

    @property
    def oldest_seq(self) -> int:
        return min((r.seq for r in self.requests), default=-1)

    def wave_cost(self, rows: Optional[int] = None) -> int:
        n = len(self.requests) if rows is None else rows
        return self.per_row_cost * max(1, n)


class SigSched:
    """Deadline-aware, cross-graph-batched, preemptible dispatch.

    ``row_budget`` caps rows executed per tick for one wave (``None``:
    unsplit — the legacy behaviour); on a meshed service the effective
    budget aligns up to the shard width.  ``cross_graph`` groups
    requests by compiled-program fingerprint instead of graph name.
    ``defer_slack`` enables the wait-a-tick heuristic for under-full
    all-slack groups (at most ``max_defers`` consecutive deferrals per
    group; slack must exceed ``defer_margin`` × the group's wave cost).
    ``promote`` moves slack-rich requests into fuller same-program
    larger-bucket waves.  ``starvation_ticks`` arms the cost-aware
    anti-starvation override of the EDF pick.

    ``edf=False`` disables every deadline/fingerprint feature at once —
    dispatch becomes the pure legacy FIFO pick (the bench's
    scheduler-off baseline)."""

    def __init__(self, service: "SignalService",
                 row_budget: Optional[int] = None,
                 cross_graph: bool = True,
                 defer_slack: bool = True,
                 max_defers: int = 1,
                 defer_margin: float = 2.0,
                 promote: bool = True,
                 starvation_ticks: int = 8,
                 edf: bool = True):
        if row_budget is not None and row_budget < 1:
            raise ValueError("row_budget must be >= 1 (or None)")
        if max_defers < 0 or starvation_ticks < 1:
            raise ValueError("max_defers >= 0 and starvation_ticks >= 1")
        self.service = service
        self.row_budget = row_budget
        self.cross_graph = bool(cross_graph)
        self.defer_slack = bool(defer_slack)
        self.max_defers = int(max_defers)
        self.defer_margin = float(defer_margin)
        self.promote = bool(promote)
        self.starvation_ticks = int(starvation_ticks)
        self.edf = bool(edf)
        self._waves: List[WaveState] = []
        self._defers: Dict[Tuple, int] = {}
        self._passed: Dict[Tuple, int] = {}
        self.stats = {"dispatches": 0, "cross_graph_batches": 0,
                      "wave_splits": 0, "deferrals": 0,
                      "bucket_promotions": 0, "starvation_picks": 0}

    # -- bookkeeping the service reads ---------------------------------------
    def backlog_rows(self) -> int:
        """Rows claimed into partially-executed waves (out of the
        service queue, still pending)."""
        return sum(len(w.requests) for w in self._waves)

    def drop_graph(self, name: str) -> List["SignalRequest"]:
        """Purge claimed-wave rows of a re-registered graph (the queue
        analogue lives in :meth:`SignalService.register`).  Returns the
        dropped requests so the service can error them."""
        dropped: List["SignalRequest"] = []
        for w in list(self._waves):
            stale = [r for r in w.requests if r.graph == name]
            if stale:
                dropped.extend(stale)
                w.requests = [r for r in w.requests if r.graph != name]
                if not w.requests:
                    self._waves.remove(w)
        return dropped

    # -- grouping -------------------------------------------------------------
    def exec_key(self, req: "SignalRequest") -> Tuple:
        """The request's execution-identity key: the fingerprint of its
        compiled bucket program (cross-graph mode) or the legacy
        ``(graph, length)`` pair.  Cached on the request — exec keys
        are stable for a submitted request's lifetime."""
        key = getattr(req, "_exec_key", None)
        if key is None:
            name, length = self.service.group_key(req)
            key = self._exec_key_for(name, length)
            req._exec_key = key
        return key

    def _exec_key_for(self, name: str, length: int) -> Tuple:
        if self.cross_graph and self.edf is not False:
            fp = self.service.exec_fingerprint(name, length)
            if fp is not None:
                return ("fp", fp, length)
        return ("graph", name, length)

    def _collect_groups(self) -> List[ExecGroup]:
        svc = self.service
        by_key: Dict[Tuple, List] = {}
        for r in svc._queue:
            by_key.setdefault(self.exec_key(r), []).append(r)
        groups = []
        for key, rs in by_key.items():
            length = key[-1]
            per_row = svc.group_cost((rs[0].graph, length))
            groups.append(ExecGroup(key=key, length=length, requests=rs,
                                    per_row_cost=per_row))
        for w in self._waves:
            per_row = svc.group_cost((w.requests[0].graph, w.length))
            groups.append(ExecGroup(key=w.key, length=w.length,
                                    requests=w.requests,
                                    per_row_cost=per_row, wave=w))
        return groups

    # -- slack-aware bucket promotion -----------------------------------------
    def _promote_slack(self, groups: List[ExecGroup], now: float) -> None:
        """Move finite-deadline requests from under-full small-bucket
        groups into fuller, larger-bucket groups running the SAME
        compiled program family, when their slack covers the bigger
        bucket's cost with margin.  Promotion is a per-tick view change
        only (requests stay queued with their original key); it becomes
        real if the enlarged group dispatches this tick."""
        svc = self.service
        fresh = sorted((g for g in groups if g.wave is None),
                       key=lambda g: g.length)
        for g in fresh:
            if len(g.requests) >= svc.batch_size:
                continue
            # only masked/bucketed requests can pad up a bucket; an
            # exact-length request (non-maskable graph, or overflow past
            # the pinned buckets) computes WRONG results at any other
            # length and must never move.
            movers = [r for r in g.requests if r.deadline < math.inf
                      and getattr(r, "_bucketed", False)]
            if not movers:
                continue
            for t in fresh:
                if (t is g or t.length <= g.length or not t.requests
                        or len(t.requests) <= len(g.requests)
                        or len(t.requests) >= svc.batch_size):
                    continue
                moved = []
                for r in movers:
                    if len(t.requests) + len(moved) >= svc.batch_size:
                        break
                    if self._exec_key_for(r.graph, t.length) != t.key:
                        continue
                    rows_after = len(t.requests) + len(moved) + 1
                    need = self.defer_margin * t.per_row_cost * rows_after
                    if r.deadline - now < need:
                        continue
                    moved.append(r)
                if moved:
                    for r in moved:
                        g.requests.remove(r)
                        t.requests.append(r)
                        r._promoted_length = t.length
                    # a row moves at most once per tick: anything already
                    # promoted into t must not be offered to later targets
                    movers = [r for r in movers if r not in moved]
                if not movers:
                    break

    # -- the pick -------------------------------------------------------------
    def _should_defer(self, g: ExecGroup, now: float) -> bool:
        if not self.defer_slack or g.wave is not None:
            return False
        if len(g.requests) >= self.service.batch_size:
            return False
        if self._defers.get(g.key, 0) >= self.max_defers:
            return False
        cost = g.wave_cost()
        slack = min(r.deadline for r in g.requests) - now - cost
        return slack > self.defer_margin * max(1, cost)

    def _anti_starvation(self, groups: List[ExecGroup], edf: ExecGroup,
                         now: float) -> ExecGroup:
        starved = [g for g in groups if g is not edf
                   and self._passed.get(g.key, 0) >= self.starvation_ticks]
        if not starved:
            return edf
        victim = min(starved, key=lambda g: g.oldest_seq)
        waited = self._passed[victim.key]
        edf_slack = edf.earliest_deadline - now - edf.wave_cost()
        if waited >= 4 * self.starvation_ticks \
                or edf_slack >= victim.wave_cost():
            self.stats["starvation_picks"] += 1
            if obs.ENABLED:
                obs.instant("SigSched", "starvation_pick",
                            waited=waited, key=str(victim.key[:2]))
            return victim
        return edf

    def _choose(self, groups: List[ExecGroup],
                now: float) -> Optional[ExecGroup]:
        if not groups:
            return None
        finite = any(g.earliest_deadline < math.inf for g in groups)
        if not self.edf or not finite:
            # legacy FIFO: the oldest request's group runs (claimed
            # waves included — their rows are the oldest by definition).
            chosen = min(groups, key=lambda g: g.oldest_seq)
        else:
            pool = list(groups)
            chosen = None
            while pool:
                cand = min(pool, key=lambda g: (g.earliest_deadline,
                                                g.oldest_seq))
                pick = self._anti_starvation(groups, cand, now)
                if pick is not cand:
                    chosen = pick
                    break
                if self._should_defer(cand, now):
                    self._defers[cand.key] = \
                        self._defers.get(cand.key, 0) + 1
                    self.stats["deferrals"] += 1
                    if obs.ENABLED:
                        obs.instant("SigSched", "defer",
                                    rows=len(cand.requests),
                                    bucket=cand.length)
                    pool.remove(cand)
                    continue
                chosen = cand
                break
            if chosen is None:
                return None          # every group chose to wait a tick
        for g in groups:
            if g is not chosen and g.requests:
                self._passed[g.key] = self._passed.get(g.key, 0) + 1
        self._passed.pop(chosen.key, None)
        self._defers.pop(chosen.key, None)
        return chosen

    def preview_pick(self) -> Optional[Tuple[Tuple[str, int], str]]:
        """The ``(legacy group key, order)`` dispatch would pick right
        now, for policies that drive :meth:`SignalService.make_pick`
        directly (the LatencyAwarePolicy contract).  Runs the same EDF
        + anti-starvation selection as :meth:`dispatch` — including the
        aging counters, so a group repeatedly passed over in previews
        still earns its starvation override — but never defers (a
        policy asking "what would you run" needs an answer, not a
        wait)."""
        groups = self._collect_groups()
        if not groups:
            return None
        now = float(self.service.est_cycles)
        finite = any(g.earliest_deadline < math.inf for g in groups)
        if not self.edf or not finite:
            chosen = min(groups, key=lambda g: g.oldest_seq)
        else:
            cand = min(groups, key=lambda g: (g.earliest_deadline,
                                              g.oldest_seq))
            chosen = self._anti_starvation(groups, cand, now)
        for g in groups:
            if g is not chosen and g.requests:
                self._passed[g.key] = self._passed.get(g.key, 0) + 1
        self._passed.pop(chosen.key, None)
        rep = chosen.requests[0]
        order = "deadline" if chosen.earliest_deadline < math.inf \
            else "fifo"
        return self.service.group_key(rep), order

    # -- dispatch --------------------------------------------------------------
    def _effective_budget(self) -> Optional[int]:
        svc = self.service
        if svc.mesh is not None:
            return svc.mesh.align_row_budget(self.row_budget)
        return self.row_budget

    def dispatch(self) -> Dict[int, np.ndarray]:
        """Execute (at most) one wave chunk and return ``{rid: out}``
        for the rows that completed.  An empty dict means an idle or
        deferred tick."""
        svc = self.service
        if not svc._queue and not self._waves:
            return {}
        _t0 = obs.now() if obs.ENABLED else 0
        now = float(svc.est_cycles)
        groups = self._collect_groups()
        if self.promote and self.edf:
            self._promote_slack(groups, now)
            groups = [g for g in groups if g.requests]
        chosen = self._choose(groups, now)
        if chosen is None:
            return {}
        budget = self._effective_budget()

        wave = chosen.wave
        if wave is None:
            reqs = list(chosen.requests)
            if chosen.earliest_deadline < math.inf:
                reqs.sort(key=lambda r: (r.deadline, r.seq))
            else:
                reqs.sort(key=lambda r: r.seq)
            reqs = reqs[: svc.batch_size]
            if budget is not None and len(reqs) > budget:
                # claim the full wave out of the queue; execute the
                # first chunk now, the rest on later ticks.
                for r in reqs:
                    svc._queue.remove(r)
                wave = WaveState(key=chosen.key, length=chosen.length,
                                 requests=reqs, total_rows=len(reqs))
                self._waves.append(wave)
            else:
                return self._run_chunk(chosen, reqs, split=False,
                                       now=now, t0=_t0)

        chunk = wave.requests[: budget] if budget is not None \
            else list(wave.requests)
        wave.requests = wave.requests[len(chunk):]
        wave.executed_rows += len(chunk)
        wave.chunks += 1
        if wave.requests:
            self.stats["wave_splits"] += 1
        else:
            self._waves.remove(wave)
        group = ExecGroup(key=wave.key, length=wave.length,
                          requests=chunk,
                          per_row_cost=chosen.per_row_cost, wave=wave)
        return self._run_chunk(group, chunk, split=True, now=now, t0=_t0)

    def _run_chunk(self, group: ExecGroup, reqs: List["SignalRequest"],
                   split: bool, now: float, t0: int) -> Dict:
        svc = self.service
        graphs = {r.graph for r in reqs}
        cross = len(graphs) > 1
        promoted = sum(1 for r in reqs
                       if getattr(r, "_promoted_length", None)
                       == group.length
                       and svc.group_key(r)[1] != group.length)
        self.stats["dispatches"] += 1
        if cross:
            self.stats["cross_graph_batches"] += 1
        if promoted:
            self.stats["bucket_promotions"] += promoted
        if obs.ENABLED:
            m = obs.metrics()
            for r in reqs:
                if r.deadline < math.inf:
                    m.histogram("sched.slack_cycles").record(
                        r.deadline - now)
            if cross:
                m.counter("sched.cross_graph_batches").inc()
            m.counter("sched.dispatches").inc()
            if split:
                m.counter("sched.wave_chunks").inc()
            obs.tracer().counter("scheduler", {
                "wave_splits": self.stats["wave_splits"],
                "cross_graph_batches": self.stats["cross_graph_batches"],
                "deferrals": self.stats["deferrals"],
                "bucket_promotions": self.stats["bucket_promotions"]})
        results = svc._execute_wave(reqs, group.length)
        if obs.ENABLED:
            w = group.wave
            obs.complete(
                "SigSched", "dispatch", t0,
                bucket=group.length, rows=len(reqs),
                graphs=sorted(graphs), cross_graph=cross,
                promoted=promoted,
                chunk=(w.chunks if w is not None else 1),
                remaining_rows=(len(w.requests) if w is not None else 0))
        return results
