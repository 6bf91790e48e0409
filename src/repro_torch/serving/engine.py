"""Batched serving engine: continuous-batching-lite request loop over the
model bundles' prefill/decode steps — the port's counterpart of the JAX
package's ``serving/engine.py``.

Requests (prompt token lists) are left-padded into a fixed batch;
finished slots are refilled from the queue (slot-level continuous
batching); decode is one step for the whole batch.  Optional int8/int4
weight quantization via :mod:`repro_torch.serving.quantized`
(storage-only).  Prefill and decode run under ``torch.no_grad()``: every
prefill's attention layers launch the flash-attention kernel on the
card, which has no backward pass.

:class:`DecodeWave` is the incremental form used by the LLM+DSP
:class:`~repro_torch.serving.signal_service.CoScheduler`: prefill once,
then one decode step per ``step()`` call, so a scheduler can interleave
other work between token steps.  It also carries the continuous-batching
hooks — per-request completion tracking (:meth:`DecodeWave.pop_done`)
and mid-flight admission (:meth:`DecodeWave.admit`, greedy decode only)
— plus a per-step cost estimate (:meth:`ServingEngine.decode_step_cost`)
for cost-aware scheduling policies.

Differences from the JAX package: the decode step runs eagerly (no
``jit``); a step reads its tokens back in one ``.tolist()``; sampling
(``temperature > 0``) draws from a ``torch.Generator`` seeded 0 on the
engine's device, re-seeded at every prefill as the JAX package re-seeds
``PRNGKey(0)`` — the same distribution, another stream.  Greedy decoding
gives the JAX package's tokens.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.zoo import ModelBundle
from ..tree import tree_map

__all__ = ["Request", "ServingEngine", "DecodeWave"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    deadline: float = math.inf     # scheduler hint (latency_aware policy)

    def slack(self, now: float) -> float:
        """Cycles of headroom before this request's deadline at virtual
        time ``now`` (``inf`` for deadline-less requests) — the quantity
        slack-aware scheduling compares against perf-model step costs
        (:mod:`repro_torch.serving.scheduler` uses the same convention for
        DSP requests)."""
        return self.deadline - now


class ServingEngine:
    def __init__(self, bundle: ModelBundle, batch_size: int = 4,
                 temperature: float = 0.0, quant_bits: int = 0):
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.batch_size = batch_size
        self.temperature = temperature
        self.quant_bits = quant_bits
        self._decode = bundle.decode_step
        self.params = None
        self.device: Optional[torch.device] = None

    def load(self, params, device=DEFAULT_DEVICE):
        """Take ``params`` (the bundle's tree) onto ``device`` — the card
        by default, raising on a host without one — storage-quantized
        when ``quant_bits`` is set."""
        self.device = resolve_device(device)
        params = tree_map(lambda t: t.to(self.device), params)
        if self.quant_bits:
            from .quantized import dequantize_tree, quantize_tree
            q, s = quantize_tree(params, self.quant_bits)
            params = dequantize_tree(q, s)
        self.params = params

    def _generator(self) -> torch.Generator:
        """The sampling stream of one prefill: seeded 0 on the engine's
        device (the JAX package's ``PRNGKey(0)``)."""
        return torch.Generator(device=self.device).manual_seed(0)

    # -- single-batch generation (prefill once, decode loop) ---------------
    def prefill_prompts(self, prompts: List[List[int]], max_new: int):
        """Left-pad ``prompts`` into one batch and prefill.  Returns
        ``(logits, cache, plen)``.  Shared by :meth:`generate` and
        :class:`DecodeWave` so their token streams stay identical."""
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        toks = np.zeros((b, plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, -len(p):] = p          # left-pad (simple)
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        if self.cfg.input_kind == "encdec":
            batch["embeds"] = torch.zeros(
                (b, self.cfg.enc_seq, self.cfg.d_model), dtype=torch.float32,
                device=self.device)
        with torch.no_grad():
            logits, cache = self.bundle.prefill(self.params, batch,
                                                max_len=plen + max_new)
        return logits, cache, plen

    def _step(self, cache, cur: torch.Tensor):
        with torch.no_grad():
            return self._decode(self.params, cache, {"tokens": cur[:, None]})

    def generate(self, prompts: List[List[int]], max_new: int = 16,
                 rng: Optional[torch.Generator] = None) -> List[List[int]]:
        assert len(prompts) <= self.batch_size
        b = len(prompts)
        logits, cache, _ = self.prefill_prompts(prompts, max_new)
        outs: List[List[int]] = [[] for _ in range(b)]
        rng = rng if rng is not None else self._generator()
        cur = self._sample(logits[:, -1], rng)
        for step in range(max_new):
            for o, t in zip(outs, cur.tolist()):
                o.append(t)
            logits, cache = self._step(cache, cur)
            cur = self._sample(logits[:, -1], rng)
        return outs

    def _sample(self, logits: torch.Tensor,
                rng: torch.Generator) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=rng)[:, 0].to(
            torch.int32)

    # -- queue serving with slot refill ------------------------------------
    def serve(self, requests: List[Request]) -> Dict[int, List[int]]:
        queue = list(requests)
        results: Dict[int, List[int]] = {}
        while queue:
            wave = queue[: self.batch_size]
            queue = queue[self.batch_size:]
            outs = self.generate([r.prompt for r in wave],
                                 max_new=max(r.max_new for r in wave))
            for r, o in zip(wave, outs):
                results[r.rid] = o[: r.max_new]
        return results

    # -- scheduler hooks ----------------------------------------------------
    def decode_step_cost(self, batch: Optional[int] = None) -> int:
        """Estimated accelerator cycles for one batched decode step (see
        :func:`repro_torch.core.perf_model.decode_step_cost`); cost-aware
        CoScheduler policies weigh this against DSP batch costs.  The
        analytic model is pure in (cfg, batch), so results are memoized
        per batch size (the scheduler asks every tick)."""
        b = batch or self.batch_size
        cache = getattr(self, "_step_cost_cache", None)
        if cache is None:
            cache = self._step_cost_cache = {}
        if b not in cache:
            from ..core.perf_model import decode_step_cost
            cache[b] = decode_step_cost(self.cfg, b)
        return cache[b]


class DecodeWave:
    """Incremental equivalent of :meth:`ServingEngine.generate` for one
    wave of requests: prefill once, then one decode step per
    :meth:`step` call.  For a fixed member set the produced tokens are
    identical to ``generate`` (same prefill shapes, same sampling
    stream).

    Continuous-batching hooks:

    * :meth:`pop_done` — harvest requests that reached their ``max_new``
      so the scheduler can report them before the wave finishes;
    * :meth:`admit` — join new requests mid-flight.  Admission re-prefills
      the merged wave over each active request's prompt + generated
      prefix; greedy decode (temperature 0) is context-deterministic, so
      every request continues exactly as if it had run alone *modulo
      left-padding*: requests whose padded prefix lengths change relative
      positions may diverge for position-sensitive models, which is the
      same caveat batched ``generate`` already has.  Sampling
      (temperature > 0) would restart the sampling stream, so admission
      requires greedy decode.
    """

    def __init__(self, engine: ServingEngine, reqs: List[Request]):
        self.engine = engine
        self.reqs = list(reqs)
        self.outs: List[List[int]] = [[] for _ in self.reqs]
        self._reported: set = set()           # rids harvested early
        self._prefill()

    def _prefill(self) -> None:
        if not self.reqs:
            raise ValueError("DecodeWave needs at least one request")
        _t0 = obs.now() if obs.ENABLED else 0
        engine = self.engine
        prompts = [list(r.prompt) + o for r, o in zip(self.reqs, self.outs)]
        self.max_new = max(r.max_new - len(o)
                           for r, o in zip(self.reqs, self.outs))
        logits, self.cache, plen = engine.prefill_prompts(prompts,
                                                          self.max_new)
        self.prefill_tokens = plen            # for scheduler cost accounting
        self.rng = engine._generator()
        self.cur = engine._sample(logits[:, -1], self.rng)
        self.steps = 0
        if obs.ENABLED:
            obs.complete("DecodeWave", "prefill", _t0,
                         size=len(self.reqs), prefill_tokens=plen)
            m = obs.metrics()
            m.counter("engine.prefills").inc()
            m.gauge("engine.decode_occupancy").set(
                len(self.reqs) / max(1, engine.batch_size))

    @property
    def done(self) -> bool:
        return self.steps >= self.max_new

    @property
    def size(self) -> int:
        return len(self.reqs)

    def free_slots(self, capacity: Optional[int] = None) -> int:
        """Slots a scheduler may fill via :meth:`admit`: unused capacity
        plus members that already reached their own ``max_new``."""
        cap = capacity if capacity is not None else self.engine.batch_size
        finished = sum(1 for r, o in zip(self.reqs, self.outs)
                       if len(o) >= r.max_new)
        return max(0, cap - len(self.reqs)) + finished

    def step(self) -> None:
        _t0 = obs.now() if obs.ENABLED else 0
        live = 0
        toks = self.cur.tolist()              # one device-to-host copy
        for r, o, t in zip(self.reqs, self.outs, toks):
            if len(o) < r.max_new:
                o.append(t)
                live += 1
        self.steps += 1
        if self.done:
            return
        logits, self.cache = self.engine._step(self.cache, self.cur)
        self.cur = self.engine._sample(logits[:, -1], self.rng)
        if obs.ENABLED:
            obs.complete("DecodeWave", "decode_step", _t0,
                         step=self.steps, size=len(self.reqs), live=live)
            m = obs.metrics()
            m.counter("engine.decode_steps").inc()
            # occupancy = rows still generating / engine batch capacity
            m.gauge("engine.decode_occupancy").set(
                live / max(1, self.engine.batch_size))

    def pop_done(self) -> Dict[int, List[int]]:
        """Harvest requests that reached their ``max_new`` and were not
        harvested before.  Members stay in the batch (their rows keep
        decoding until the wave ends or :meth:`admit` re-prefills) — this
        only lets the scheduler report results early."""
        out: Dict[int, List[int]] = {}
        for r, o in zip(self.reqs, self.outs):
            if len(o) >= r.max_new and r.rid not in self._reported:
                out[r.rid] = o[: r.max_new]
                self._reported.add(r.rid)
        return out

    def admit(self, reqs: List[Request]) -> Dict[int, List[int]]:
        """Mid-flight admission: merge ``reqs`` into the wave.  Finished
        members are harvested (returned, as in :meth:`pop_done`) and
        their slots freed; the merged wave re-prefills over prompt +
        generated prefix and decoding resumes.  Greedy decode only."""
        if self.engine.temperature > 0.0:
            raise ValueError("mid-flight admission requires greedy decode "
                             "(temperature == 0)")
        if not reqs:
            return self.pop_done()            # nothing to join: no re-prefill
        if obs.ENABLED:
            obs.instant("DecodeWave", "admit", joined=len(reqs),
                        size=len(self.reqs))
            obs.metrics().counter("engine.admissions").inc(len(reqs))
        finished: Dict[int, List[int]] = {}
        keep_r, keep_o = [], []
        for r, o in zip(self.reqs, self.outs):
            if len(o) >= r.max_new:
                if r.rid not in self._reported:
                    finished[r.rid] = o[: r.max_new]
                    self._reported.add(r.rid)
            else:
                keep_r.append(r)
                keep_o.append(o)
        self.reqs = keep_r + list(reqs)
        self.outs = keep_o + [[] for _ in reqs]
        self._prefill()
        return finished

    def results(self) -> Dict[int, List[int]]:
        return {r.rid: o[: r.max_new]
                for r, o in zip(self.reqs, self.outs)}

    # -- checkpoint / restore ------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Plain-data snapshot of the wave's request-level progress.
        Deliberately excludes the KV cache: :meth:`from_snapshot`
        re-prefills over each request's prompt + generated prefix, the
        same mechanism :meth:`admit` uses, with the same greedy-decode
        requirement and the same determinism-modulo-left-padding caveat.
        That keeps checkpoints small and device-free."""
        if self.engine.temperature > 0.0:
            raise ValueError("DecodeWave snapshots require greedy decode "
                             "(temperature == 0): restore re-prefills, "
                             "which would restart the sampling stream")
        return {
            "reqs": [{"rid": r.rid, "prompt": list(r.prompt),
                      "max_new": r.max_new, "deadline": r.deadline}
                     for r in self.reqs],
            "outs": [list(o) for o in self.outs],
            "reported": sorted(self._reported),
        }

    @classmethod
    def from_snapshot(cls, engine: ServingEngine,
                      snap: Dict[str, Any]) -> "DecodeWave":
        """Rebuild a wave from :meth:`snapshot` on ``engine`` and resume
        decoding where it left off (re-prefill over prompt + prefix)."""
        wave = cls.__new__(cls)
        wave.engine = engine
        wave.reqs = [Request(rid=r["rid"], prompt=list(r["prompt"]),
                             max_new=r["max_new"], deadline=r["deadline"])
                     for r in snap["reqs"]]
        wave.outs = [list(o) for o in snap["outs"]]
        wave._reported = set(snap["reported"])
        wave._prefill()
        return wave
