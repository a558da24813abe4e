"""Continuous-batching request scheduler over the paged serving engine.

vLLM-style control loop, sized down to this repo's engine: a FIFO request
queue, admission gated on free packed blocks (the pool measures capacity
in *compressed* bytes, so a tighter container admits more concurrent
requests), prefill/decode interleaving (each ``step()`` first admits
arrived requests — one prefill each — then advances every running slot by
one batched decode step), slot recycling (a finished request frees its
blocks and its slot in the same step; the next pending request takes them
without recompiling anything), and recompute-preemption (when the pool
cannot supply a running request's next block, the youngest other request
is evicted, its blocks freed, and it re-enters the queue with its
already-emitted tokens folded into the prompt — emitted tokens are never
retracted).

On top of that sits the fault-tolerance layer (this PR's subject):

* **Deadlines / cancellation** — a request past its (absolute) deadline
  or cancelled by the client frees its blocks immediately, whether
  pending or running; misses/cancellations are counted, and partial
  output is kept in ``results``.
* **Bounded queue + load shedding** — with ``max_pending`` set, arrived
  requests beyond the bound are *explicitly* shed (newest first, never a
  preempted/recovering request) and recorded as such — no silent drops.
* **Block integrity + recovery** — before every decode the engine's
  per-block checksums are verified over all allocated blocks; mismatched
  blocks are quarantined in the pool and the owning request recovers by
  recompute-from-prompt (the same emitted-token folding preemption uses,
  so its stream is token-identical to a fault-free run). A NaN/Inf logit
  guard catches corruption the checksum cannot see (integrity disabled,
  or decodable-but-wrong planes): the offending slot's blocks are
  quarantined and the request recovers the same way. ``max_recoveries``
  bounds repeated failures; beyond it a request is marked ``failed``
  rather than looping.
* **Preemption-storm guard** — ``storm_guard=True`` makes admission
  reserve the blocks running slots need for their next burst horizon
  (new work cannot steal a running request's growth and trigger
  admit→preempt thrash), and ``recompute_budget`` caps re-prefill tokens
  per step so recompute-preemption can never dominate a step. Oldest
  requests always finish: eviction stays youngest-first.
* **Graceful degradation** — with a ``PressureController`` attached
  (serve/precision.py), admissions while free pool *bytes* sit below the
  low watermark are downshifted to the engine's narrower
  ``degraded_container`` geometry: prompt KV is requantized at prefill
  and the slot's blocks are priced at the narrower per-block byte rate,
  so pressure admits more work instead of shedding it.

Tokens stream per request: every emitted token fires ``on_token(uid,
token, done)`` (scheduler-wide and per-request callbacks) the step it is
produced. Terminal bookkeeping (``finished``/``results``/token history)
is LRU-bounded by ``history_limit`` unless ``retain_history=True`` — a
long-running server no longer accumulates per-uid token lists forever.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs as obs_mod
from repro_torch.serve.engine import PagedEngine
from repro_torch.serve.pool import TRASH_BLOCK, blocks_for

OnToken = Callable[[Any, int, bool], None]


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival`` is in the caller's clock
    (the trace simulator drives a virtual clock); ``on_token`` streams
    this request's tokens as they are produced. ``deadline`` (optional)
    is an *absolute* time in the same clock: past it the request is
    expired and its blocks freed, wherever it is in the pipeline."""

    uid: Any
    prompt: np.ndarray          # (S,) int32 token ids
    max_new: int
    arrival: float = 0.0
    on_token: Optional[OnToken] = None
    deadline: Optional[float] = None
    requeued: bool = False      # internal: re-entered the queue after
    #                             preemption/recovery (never shed)


@dataclasses.dataclass
class RequestResult:
    """Terminal record for one request (``Scheduler.results``)."""

    status: str                 # ok | expired | cancelled | shed | failed
    tokens: np.ndarray          # every token emitted (partial if not ok)
    container: str              # geometry the final residency stored KV at
    recoveries: int = 0
    drafted: int = 0            # speculative drafts proposed for this uid
    draft_accepted: int = 0     # drafts the full-width verify confirmed


@dataclasses.dataclass
class _Running:
    req: Request
    slot: int
    admit_seq: int
    n_ctx: int                  # tokens whose KV is in the pool (prompt')
    last_tok: int               # most recent emitted token (next step's input)
    narrow: bool = False        # admitted downshifted (degraded geometry)
    emitted: List[int] = dataclasses.field(default_factory=list)


class SchedulerStats:
    """Read-only compat view over the obs metrics registry.

    The counters themselves now live in ``repro_torch.obs`` (labeled,
    Prometheus-exportable); this struct keeps the attribute surface every
    existing test/bench/report reads. Each attribute is a property summing
    the backing family, so ``sched.stats.shed`` and the metrics export can
    never disagree — and the terminal-outcome identity (ok + expired +
    cancelled + shed + failed == submitted) is structural, because every
    terminal path increments exactly one ``serve_requests_total{outcome}``
    series inside ``Scheduler._record``.
    """

    # attribute -> serve_requests_total outcome label
    _OUTCOMES = {"finished": "ok", "deadline_misses": "expired",
                 "shed": "shed", "cancelled": "cancelled",
                 "failed": "failed"}
    # attribute -> unlabeled counter family
    _COUNTERS = {"preemptions": "serve_preemptions_total",
                 "decode_steps": "serve_decode_steps_total",
                 "emitted_tokens": "serve_tokens_total",
                 "recoveries": "serve_recoveries_total",
                 "corrupt_blocks": "serve_corrupt_blocks_total",
                 "nan_guard_trips": "serve_nan_guard_trips_total",
                 "alloc_failures": "serve_alloc_failures_total",
                 "recompute_tokens": "serve_recompute_tokens_total",
                 "downshifted": "serve_downshifted_total",
                 "submitted": "serve_submitted_total",
                 "drafted": "serve_drafted_total",
                 "draft_accepted": "serve_draft_accepted_total",
                 "draft_rejected": "serve_draft_rejected_total",
                 "spec_rounds": "serve_spec_rounds_total"}

    def __init__(self, registry: obs_mod.MetricsRegistry):
        self._reg = registry

    def __getattr__(self, name: str):
        reg = object.__getattribute__(self, "_reg")
        outcome = SchedulerStats._OUTCOMES.get(name)
        if outcome is not None:
            fam = reg.counter("serve_requests_total", labels=("outcome",))
            return int(fam.total(outcome=outcome))
        fam_name = SchedulerStats._COUNTERS.get(name)
        if fam_name is not None:
            return int(reg.counter(fam_name).value)
        if name == "admitted":
            fam = reg.counter("serve_admitted_total", labels=("geometry",))
            return int(fam.total())
        raise AttributeError(name)

    def as_dict(self) -> Dict[str, int]:
        return {k: getattr(self, k)
                for k in (*self._OUTCOMES, *self._COUNTERS, "admitted")}

    def __repr__(self) -> str:
        return f"SchedulerStats({self.as_dict()})"


class Scheduler:
    def __init__(self, engine: PagedEngine,
                 on_token: Optional[OnToken] = None, *,
                 max_pending: Optional[int] = None,
                 history_limit: int = 1024,
                 retain_history: bool = False,
                 max_recoveries: int = 3,
                 recompute_budget: Optional[int] = None,
                 storm_guard: bool = False,
                 pressure: Optional[Any] = None,
                 obs: Optional[obs_mod.Obs] = None):
        if pressure is not None and engine.degraded_container is None:
            raise ValueError("a PressureController needs an engine built "
                             "with degraded_container set")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.engine = engine
        self.on_token = on_token
        self.max_pending = max_pending
        self.history_limit = int(history_limit)
        self.retain_history = bool(retain_history)
        self.max_recoveries = int(max_recoveries)
        self.recompute_budget = recompute_budget
        self.storm_guard = bool(storm_guard)
        self.pressure = pressure
        self.pending: "deque[Request]" = deque()
        self.running: Dict[int, _Running] = {}
        self.free_slots = list(range(engine.max_slots - 1, -1, -1))
        self.finished: Dict[Any, np.ndarray] = {}
        self.results: Dict[Any, RequestResult] = {}
        # Telemetry substrate. Every scheduler owns an Obs (a fresh one
        # unless injected), and points the engine/pool at it: benches and
        # tests run several schedulers over one warm engine and expect
        # per-run counters, so the engine records into whichever scheduler
        # drives it last.
        self.obs = obs if obs is not None else obs_mod.Obs()
        engine.obs = self.obs
        engine.pool.obs = self.obs
        reg = self.obs.registry
        self._c_submitted = reg.counter(
            "serve_submitted_total", "requests accepted by submit()")
        self._c_requests = reg.counter(
            "serve_requests_total", "terminal request outcomes",
            labels=("outcome",))
        self._c_admitted = reg.counter(
            "serve_admitted_total", "admissions by served geometry",
            labels=("geometry",))
        self._c_preempt = reg.counter(
            "serve_preemptions_total", "recompute-preemptions")
        self._c_decode = reg.counter(
            "serve_decode_steps_total", "engine decode steps (burst tokens)")
        self._c_tokens = reg.counter(
            "serve_tokens_total", "tokens emitted to clients")
        self._c_recov = reg.counter(
            "serve_recoveries_total", "recompute-from-prompt recoveries")
        self._c_recomp = reg.counter(
            "serve_recompute_tokens_total",
            "prompt tokens re-prefilled after requeue")
        self._c_allocfail = reg.counter(
            "serve_alloc_failures_total",
            "allocator refusals after a granted admission")
        self._c_corrupt = reg.counter(
            "serve_corrupt_blocks_total", "checksum mismatches detected")
        self._c_nan = reg.counter(
            "serve_nan_guard_trips_total", "non-finite logit guard trips")
        self._c_downshift = reg.counter(
            "serve_downshifted_total",
            "admissions downshifted to the degraded geometry")
        self._c_drafted = reg.counter(
            "serve_drafted_total",
            "speculative draft tokens proposed (prefix-precision reads)")
        self._c_draft_acc = reg.counter(
            "serve_draft_accepted_total",
            "draft tokens the full-width verify pass confirmed")
        self._c_draft_rej = reg.counter(
            "serve_draft_rejected_total",
            "draft tokens rejected at verify (state rolled back)")
        self._c_spec_rounds = reg.counter(
            "serve_spec_rounds_total",
            "speculative draft+verify rounds dispatched")
        self._h_ttft = reg.histogram(
            "serve_ttft_seconds", "submit-to-first-token wall time",
            unit="s")
        self._h_tok = reg.histogram(
            "serve_token_latency_seconds",
            "per-token wall time within a scheduler step", unit="s")
        self._h_step = reg.histogram(
            "serve_step_seconds", "scheduler step wall time", unit="s")
        self.stats = SchedulerStats(reg)
        self._submit_ts: Dict[Any, float] = {}   # uid -> perf_counter at
        #                                          submit (TTFT, first
        #                                          residency only)
        self._queued_spans: Dict[Any, Any] = {}  # uid -> open queued span
        self._step_i = 0
        self._admit_seq = 0
        # Per-uid emission history: survives recompute-preemption
        # (_Running.emitted only tracks the current residency — its length
        # is what the requeued max_new is discounted by). Entries move
        # into `results` at terminal time, so the live dict only ever
        # holds in-flight requests.
        self._history: Dict[Any, List[int]] = {}
        self._recoveries: Dict[Any, int] = {}
        # uid -> [drafted, accepted] speculative bookkeeping; survives
        # requeue like _history, moves into RequestResult at terminal time.
        self._spec_acc: Dict[Any, List[int]] = {}
        self._terminal: "deque[Any]" = deque()  # completion order (LRU)

    # -- queue -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Validate and enqueue. Malformed requests raise here, with the
        field named, instead of failing deep inside prefill; requests the
        pool can *never* hold raise RuntimeError up front."""
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(f"request {req.uid!r}: prompt must be a "
                             f"non-empty 1-D token array, got shape "
                             f"{prompt.shape}")
        if int(req.max_new) < 1:
            raise ValueError(f"request {req.uid!r}: max_new must be >= 1, "
                             f"got {req.max_new}")
        if req.deadline is not None:
            d = float(req.deadline)
            if not math.isfinite(d) or d <= req.arrival:
                raise ValueError(
                    f"request {req.uid!r}: absurd deadline {req.deadline} "
                    f"(must be finite and after arrival {req.arrival})")
        pool = self.engine.pool
        n0 = int(prompt.size)
        if (n0 >= self.engine.max_len
                or blocks_for(n0 + 1, pool.block_l)
                > min(pool.num_blocks, pool.max_logical)):
            raise RuntimeError(
                f"pool of {pool.num_blocks} blocks / max_len "
                f"{self.engine.max_len} cannot ever admit a request of "
                f"{n0} prompt tokens")
        self.pending.append(req)
        self._c_submitted.inc()
        self._submit_ts.setdefault(req.uid, time.perf_counter())
        tracer = self.obs.tracer
        if tracer is not None:
            lane = str(req.uid)
            tracer.instant("submit", lane, prompt_tokens=n0,
                           max_new=int(req.max_new))
            self._queued_spans[req.uid] = tracer.begin("queued", lane)

    def cancel(self, uid: Any) -> bool:
        """Client cancellation: frees the request's blocks *now* (running)
        or removes it from the queue (pending). Partial output is kept in
        ``results``. Returns False for unknown/already-terminal uids."""
        for st in list(self.running.values()):
            if st.req.uid == uid:
                self._retire(st, "cancelled")
                return True
        for req in self.pending:
            if req.uid == uid:
                self.pending.remove(req)
                self._record(req.uid, "cancelled")
                return True
        return False

    @property
    def idle(self) -> bool:
        return not self.pending and not self.running

    # -- terminal bookkeeping --------------------------------------------

    def _record(self, uid: Any, status: str, narrow: bool = False) -> None:
        toks = np.asarray(self._history.pop(uid, []), np.int32)
        drafted, draft_acc = self._spec_acc.pop(uid, (0, 0))
        res = RequestResult(
            status=status, tokens=toks,
            container=(self.engine.degraded_container if narrow
                       else self.engine.container),
            recoveries=self._recoveries.pop(uid, 0),
            drafted=int(drafted), draft_accepted=int(draft_acc))
        self.results[uid] = res
        # The single terminal-outcome increment: every path that ends a
        # request funnels through here, so summing the outcome series
        # always equals serve_submitted_total once the queue drains.
        self._c_requests.labels(outcome=status).inc()
        self._submit_ts.pop(uid, None)
        tracer = self.obs.tracer
        if tracer is not None:
            q = self._queued_spans.pop(uid, None)
            if q is not None:  # went terminal while still pending
                tracer.end(q, outcome=status)
            tracer.instant("retire", str(uid), outcome=status,
                           tokens=int(toks.size),
                           recoveries=res.recoveries)
        if status == "ok":
            self.finished[uid] = toks
        self._terminal.append(uid)
        if not self.retain_history:
            while len(self._terminal) > self.history_limit:
                old = self._terminal.popleft()
                self.results.pop(old, None)
                self.finished.pop(old, None)

    def _retire(self, st: _Running, status: str,
                quarantine: Tuple[int, ...] = ()) -> None:
        self.engine.pool.free_slot(st.slot, quarantine=quarantine)
        del self.running[st.slot]
        self.free_slots.append(st.slot)
        self._record(st.req.uid, status, narrow=st.narrow)

    # -- internals -------------------------------------------------------

    def _emit(self, st: _Running, tok: int) -> Tuple[Any, int, bool]:
        st.emitted.append(int(tok))
        st.last_tok = int(tok)
        self._history.setdefault(st.req.uid, []).append(int(tok))
        self._c_tokens.inc()
        t0 = self._submit_ts.pop(st.req.uid, None)
        if t0 is not None:  # first token this request ever emitted
            self._h_ttft.observe(time.perf_counter() - t0)
        done = (len(st.emitted) >= st.req.max_new
                or st.n_ctx + 1 >= self.engine.max_len)
        for cb in (st.req.on_token, self.on_token):
            if cb is not None:
                cb(st.req.uid, int(tok), done)
        return (st.req.uid, int(tok), done)

    def _finish(self, st: _Running) -> None:
        self._retire(st, "ok")

    def _requeue(self, st: _Running) -> Request:
        """Fold emitted tokens into the prompt and put the request back at
        the queue front (emitted tokens are never retracted)."""
        req = st.req
        if st.emitted:
            req = dataclasses.replace(
                req, prompt=np.concatenate(
                    [np.asarray(req.prompt, np.int32),
                     np.asarray(st.emitted, np.int32)]),
                max_new=req.max_new - len(st.emitted))
        req = dataclasses.replace(req, requeued=True)
        self.pending.appendleft(req)
        tracer = self.obs.tracer
        if tracer is not None:
            self._queued_spans[req.uid] = tracer.begin(
                "queued", str(req.uid), requeued=True)
        return req

    def _preempt(self, st: _Running) -> None:
        """Recompute-preemption: the victim's blocks and slot free now."""
        self.engine.pool.free_slot(st.slot)
        del self.running[st.slot]
        self.free_slots.append(st.slot)
        if self.obs.tracer is not None:
            self.obs.tracer.instant("preempt", str(st.req.uid),
                                    slot=st.slot,
                                    emitted=len(st.emitted))
        self._requeue(st)
        self._c_preempt.inc()

    def _recover(self, st: _Running, quarantine: Tuple[int, ...]) -> None:
        """Recompute-from-prompt recovery after an integrity failure.

        The slot's bad blocks go to quarantine, the rest recycle, and the
        request re-enters the queue with its emitted tokens folded into
        the prompt — exactly the preemption mechanics, so the recovered
        stream is token-identical to a fault-free run. A request that
        keeps failing (``max_recoveries``) is marked ``failed`` instead of
        looping forever on a sticky fault.
        """
        uid = st.req.uid
        n = self._recoveries.get(uid, 0) + 1
        self._recoveries[uid] = n
        self._c_recov.inc()
        if self.obs.tracer is not None:
            self.obs.tracer.instant("recover", str(uid), attempt=n,
                                    quarantined=len(quarantine))
        if n > self.max_recoveries:
            self._retire(st, "failed", quarantine=quarantine)
            return
        self.engine.pool.free_slot(st.slot, quarantine=quarantine)
        del self.running[st.slot]
        self.free_slots.append(st.slot)
        self._requeue(st)

    # -- fault handling (per step, before the device call) ---------------

    def _expire(self, now: Optional[float]) -> None:
        if now is None:
            return
        for st in list(self.running.values()):
            d = st.req.deadline
            if d is not None and now >= d:
                self._retire(st, "expired")
        expired = [r for r in self.pending
                   if r.deadline is not None and now >= r.deadline]
        for req in expired:
            self.pending.remove(req)
            self._record(req.uid, "expired")

    def _shed(self, now: Optional[float]) -> None:
        """Bounded admission queue: arrived requests beyond ``max_pending``
        are explicitly shed, newest-arrival first. Requeued (preempted or
        recovering) requests are never shed — they hold emitted tokens."""
        if self.max_pending is None:
            return
        arrived = sum(1 for r in self.pending
                      if now is None or r.arrival <= now)
        excess = arrived - self.max_pending
        if excess <= 0:
            return
        kept: List[Request] = []
        for req in reversed(self.pending):
            if (excess > 0 and not req.requeued
                    and (now is None or req.arrival <= now)):
                self._record(req.uid, "shed")
                excess -= 1
            else:
                kept.append(req)
        self.pending = deque(reversed(kept))

    def _verify_integrity(self) -> None:
        """Verify every allocated block's checksum before it is gathered;
        quarantine mismatches and recover their owners by recompute."""
        eng = self.engine
        if not eng.integrity or not self.running:
            return
        bad = eng.verify_blocks(eng.pool.owned_ids())
        if not bad:
            return
        self._c_corrupt.inc(len(bad))
        self.obs.event("corrupt_blocks", blocks=[int(p) for p in bad])
        by_slot: Dict[int, List[int]] = {}
        for phys in bad:
            owner = eng.pool.owner_of(phys)
            if owner is not None:
                by_slot.setdefault(owner, []).append(phys)
        for slot, blocks in by_slot.items():
            st = self.running.get(slot)
            if st is not None:
                self._recover(st, tuple(blocks))

    def scrub_quarantined(self) -> int:
        """Scrub (zero + re-checksum) every quarantined block on device and
        return it to the free list; returns how many were rehabilitated."""
        n = 0
        for phys in self.engine.pool.quarantined_blocks:
            self.engine.scrub_block(phys)
            self.engine.pool.rehabilitate(phys)
            n += 1
        if n:
            self.obs.event("scrub", blocks=n)
        return n

    # -- admission -------------------------------------------------------

    def _reserve_blocks(self) -> int:
        """Blocks the running slots still need to finish their (budget-
        bounded) generations. The storm guard holds these back from
        admission: new work can never take blocks a running request will
        need, so admission→preempt thrash cannot start and the oldest
        running request always runs to completion."""
        pool = self.engine.pool
        need = 0
        for st in self.running.values():
            remaining = st.req.max_new - len(st.emitted)
            end = min(st.n_ctx + remaining, self.engine.max_len)
            need += max(0, blocks_for(end, pool.block_l)
                        - pool.slot_blocks(st.slot))
        return need

    def _admit(self, now: Optional[float],
               emitted: List[Tuple[Any, int, bool]]) -> None:
        pool = self.engine.pool
        reserve = self._reserve_blocks() if self.storm_guard else 0
        recompute = 0
        while self.pending and self.free_slots:
            degraded = False
            if self.pressure is not None:
                # Re-evaluated per candidate, not per step: each admission
                # moves the free-byte fraction, and the downshift must
                # engage mid-loop once a flood pushes it under the low
                # watermark (hysteresis in the controller stops chatter).
                ps = pool.stats()
                degraded = self.pressure.update(ps.free_bytes,
                                                ps.capacity_bytes)
            rate = self.engine.degraded_block_bytes if degraded else None
            req = self.pending[0]
            if now is not None and req.arrival > now:
                break  # FIFO: later arrivals queue behind
            n0 = int(np.asarray(req.prompt).size)
            if req.requeued and self.recompute_budget is not None \
                    and recompute + n0 > self.recompute_budget \
                    and recompute > 0:
                break  # this step's re-prefill budget is spent
            if not pool.can_admit(n0, block_bytes=rate,
                                  reserve_blocks=reserve):
                if blocks_for(n0 + 1, pool.block_l) > pool.num_blocks:
                    raise RuntimeError(
                        f"pool of {pool.num_blocks} blocks cannot ever "
                        f"admit a request of {n0} prompt tokens")
                break  # transient: blocks free up as running requests end
            if self.storm_guard:
                # Admit only if the candidate's own worst-case residency
                # also fits beside the reservation — otherwise it is the
                # request that would later thrash against the runners.
                worst = blocks_for(min(n0 + req.max_new,
                                       self.engine.max_len), pool.block_l)
                if worst + reserve > pool.free_blocks:
                    break
            self.pending.popleft()
            slot = self.free_slots.pop()
            if not pool.alloc_upto(slot, n0, block_bytes=rate):
                # can_admit passed but the allocator refused (injected
                # alloc failure, or a race with the byte budget): requeue
                # gracefully instead of crashing the loop.
                self._c_allocfail.inc()
                try:
                    pool.free_slot(slot)  # clears the empty registration
                except KeyError:
                    pass  # injected failure fired before registration
                self.free_slots.append(slot)
                self.pending.appendleft(req)
                break
            if req.requeued:
                recompute += n0
                self._c_recomp.inc(n0)
            tracer = self.obs.tracer
            t_pf = time.perf_counter()
            tok0 = self.engine.prefill_into_slot(slot, req.prompt,
                                                 narrow=degraded)
            self._admit_seq += 1
            st = _Running(req=req, slot=slot, admit_seq=self._admit_seq,
                          n_ctx=n0, last_tok=tok0, narrow=degraded)
            self.running[slot] = st
            geom = (self.engine.degraded_container if degraded
                    else self.engine.container)
            self._c_admitted.labels(geometry=geom).inc()
            if degraded:
                self._c_downshift.inc()
            if tracer is not None:
                lane = str(req.uid)
                q = self._queued_spans.pop(req.uid, None)
                if q is not None:
                    tracer.end(q, requeued=req.requeued)
                tracer.complete(
                    "prefill", lane, time.perf_counter() - t_pf,
                    geometry=geom, blocks=pool.slot_blocks(slot),
                    downshift=bool(degraded), prompt_tokens=n0, slot=slot)
            if self.storm_guard:
                # The new runner's remaining growth joins the reservation
                # before the next candidate is considered.
                reserve += max(0, worst - pool.slot_blocks(slot))
            emitted.append(self._emit(st, tok0))
            if emitted[-1][2]:  # max_new == 1 (or budget exhausted)
                self._finish(st)

    def _ensure_blocks(self, horizon: int = 1) -> None:
        """Every running slot needs blocks covering its next ``horizon``
        positions before the batched step (the whole burst runs against
        one fixed block table); when the pool runs dry the *youngest*
        running request (possibly the requester itself) is preempted —
        oldest-first priority, so head-of-line requests always drain."""
        pool = self.engine.pool
        for slot in sorted(self.running,
                           key=lambda s: self.running[s].admit_seq):
            st = self.running.get(slot)
            if st is None:  # preempted earlier this round
                continue
            while not pool.alloc_upto(slot, st.n_ctx + horizon):
                victim = max(self.running.values(),
                             key=lambda r: r.admit_seq)
                if victim.slot == slot and len(self.running) == 1:
                    raise RuntimeError(
                        f"pool of {pool.num_blocks} blocks cannot hold one "
                        f"request of {st.n_ctx + horizon} tokens")
                self._preempt(victim)
                if victim.slot == slot:
                    break  # requester preempted itself; skip its step

    def _burst_len(self, burst: int) -> int:
        """Clamp the requested burst to what this round can actually use.

        Hard cap: no running slot may step past ``max_len`` (its blocks
        and positions end there). Efficiency cap: once every running slot
        has hit its token budget there is nothing left to emit, so the
        burst never outruns the *largest* remaining budget — slots that
        finish mid-burst keep decoding harmlessly (their extra tokens are
        computed but never replayed), which is what keeps the executable
        shape fixed."""
        cap = min(self.engine.max_len - st.n_ctx
                  for st in self.running.values())
        need = max(st.req.max_new - len(st.emitted)
                   for st in self.running.values())
        return max(1, min(int(burst), cap, need))

    # -- the loop --------------------------------------------------------

    def step(self, now: Optional[float] = None, burst: int = 1,
             speculate: Optional[int] = None,
             draft_planes: Optional[int] = None
             ) -> List[Tuple[Any, int, bool]]:
        """Expire, shed, verify, admit, then advance every running slot by
        up to ``burst`` tokens in one engine call. Admission, slot
        recycling and preemption happen only at burst boundaries (here,
        before the device call); per-token streaming callbacks are
        replayed in step order from the burst's (K, max_slots) token
        buffer, so a request that hits its budget mid-burst still sees
        ``done`` on exactly its last token. Returns the (uid, token,
        done) tuples emitted this step.

        ``speculate=K`` replaces the burst with one self-speculative
        round (``engine.speculate``): K draft steps at
        ``draft_planes``-bit prefix reads, one batched full-width
        verify, and per-slot acceptance — each slot commits between 1
        and K tokens, greedy-guaranteed identical to ``burst=1`` output.
        Rejected suffixes are rolled back on device; ``n_ctx`` advances
        only by the tokens actually emitted, so pool byte accounting is
        untouched by rejection. Draft precision is engine-wide (the
        executable is specialized on it): degraded (downshifted)
        admissions store narrow-requantized planes whose low mantissa
        bit planes are zero, so a prefix at or above the degraded width
        reads their KV exactly — they effectively draft at their own
        narrower prefix, and verification covers the rest.
        """
        t0 = time.perf_counter()
        emitted = self._step_inner(now, burst, speculate, draft_planes)
        wall = time.perf_counter() - t0
        self._h_step.observe(wall)
        if emitted:
            per = wall / len(emitted)
            for _ in emitted:
                self._h_tok.observe(per)
        if self.obs.timeline is not None:
            self._record_timeline()
        self._step_i += 1
        return emitted

    def _record_timeline(self) -> None:
        """One serve timeline entry: which geometry holds how many blocks
        and bytes right now. Bytes are priced by the same per-slot rates
        the pool charges, so the per-geometry sum byte-agrees with
        ``pool.used_bytes`` by construction."""
        eng = self.engine
        pool = eng.pool
        ps = pool.stats()
        gblocks: Dict[str, int] = {}
        gbytes: Dict[str, int] = {}
        for st in self.running.values():
            name = eng.degraded_container if st.narrow else eng.container
            nb = pool.slot_blocks(st.slot)
            gblocks[name] = gblocks.get(name, 0) + nb
            gbytes[name] = (gbytes.get(name, 0)
                            + nb * pool.slot_rate(st.slot))
        degraded = bool(self.pressure is not None and self.pressure.degraded)
        self.obs.timeline.record_serve(
            self._step_i,
            geometry_blocks=gblocks, geometry_bytes=gbytes,
            used_bytes=ps.used_bytes, free_bytes=ps.free_bytes,
            capacity_bytes=ps.capacity_bytes,
            occupancy=ps.used_blocks / max(1, ps.num_blocks),
            pressure="degraded" if degraded else "normal",
            quarantined=ps.quarantined, running=len(self.running))

    def _step_inner(self, now: Optional[float], burst: int,
                    speculate: Optional[int] = None,
                    draft_planes: Optional[int] = None
                    ) -> List[Tuple[Any, int, bool]]:
        emitted: List[Tuple[Any, int, bool]] = []
        self._expire(now)
        self._shed(now)
        self._verify_integrity()
        self._admit(now, emitted)
        if not self.running:
            return emitted
        if speculate is not None and int(speculate) < 1:
            raise ValueError(f"speculate must be >= 1, got {speculate}")
        K = self._burst_len(burst if speculate is None else speculate)
        try:
            self._ensure_blocks(K)
        except RuntimeError:
            if K == 1:
                raise
            # Pool too tight for the whole burst horizon even after
            # evicting everyone else: degrade to single-step pacing
            # rather than refusing a request burst=1 could serve.
            K = 1
            self._ensure_blocks(K)
        if not self.running:
            return emitted  # everyone preempted back to the queue

        pool = self.engine.pool
        toks = np.zeros(self.engine.max_slots, np.int32)
        pos = np.zeros(self.engine.max_slots, np.int32)
        for st in self.running.values():
            toks[st.slot] = st.last_tok
            pos[st.slot] = st.n_ctx  # the input token's absolute position
        # Snapshot the participating blocks now: _finish/_recover clear
        # table rows during replay, and these blocks' checksums must be
        # re-recorded after the decode wrote fresh KV into them.
        written = [int(p) for st in self.running.values()
                   for p in pool.tables[st.slot] if p != TRASH_BLOCK]
        slot_blocks = {st.slot: tuple(int(p) for p in pool.tables[st.slot]
                                      if p != TRASH_BLOCK)
                       for st in self.running.values()}
        t_dec = time.perf_counter()
        if speculate is None:
            nxt, bad = self.engine.decode_burst(toks, pos, K)
            # Uniform replay: every slot streams all K burst tokens.
            n_emit = np.full(self.engine.max_slots, K, np.int64)
            accepted = None
            self._c_decode.inc(K)
        else:
            nxt, bad, accepted, n_emit = self.engine.speculate(
                toks, pos, K, draft_planes)  # nxt/bad: (K, max_slots)
            self._c_decode.inc(2 * K)  # K draft + K verify model steps
            self._c_spec_rounds.inc()
        dec_wall = time.perf_counter() - t_dec

        live = list(self.running.values())
        tracer = self.obs.tracer
        if speculate is not None:
            # Acceptance bookkeeping happens before replay (terminal
            # replay paths pop _spec_acc into the request's result).
            for st in live:
                acc = int(accepted[st.slot])
                self._c_drafted.inc(K)
                self._c_draft_acc.inc(acc)
                self._c_draft_rej.inc(K - acc)
                pair = self._spec_acc.setdefault(st.req.uid, [0, 0])
                pair[0] += K
                pair[1] += acc
        if tracer is not None:
            # One decode/spec span per participating request per round:
            # the token positions advanced and the geometry served at.
            for st in live:
                geom = (self.engine.degraded_container if st.narrow
                        else self.engine.container)
                if speculate is None:
                    tracer.complete(
                        "decode", str(st.req.uid), dec_wall, burst=K,
                        slot=st.slot, n_ctx=st.n_ctx,
                        blocks=len(slot_blocks[st.slot]), geometry=geom)
                else:
                    tracer.complete(
                        "spec", str(st.req.uid), dec_wall, horizon=K,
                        accepted=int(accepted[st.slot]),
                        emitted=int(n_emit[st.slot]),
                        slot=st.slot, n_ctx=st.n_ctx,
                        blocks=len(slot_blocks[st.slot]), geometry=geom)
        poisoned: Dict[int, _Running] = {}
        for i in range(K):
            for st in live:
                if self.running.get(st.slot) is not st:
                    continue  # finished earlier in this burst
                if st.slot in poisoned:
                    continue  # NaN guard tripped earlier in this burst
                if i >= n_emit[st.slot]:
                    continue  # speculative round: rejected suffix
                if bad[i, st.slot]:
                    # Non-finite logits: this token and everything chained
                    # after it is garbage — stop streaming, recover below.
                    poisoned[st.slot] = st
                    continue
                st.n_ctx += 1
                _, _, done = res = self._emit(st, int(nxt[i, st.slot]))
                emitted.append(res)
                if done:
                    self._finish(st)
        for st in poisoned.values():
            if self.running.get(st.slot) is st:
                self._c_nan.inc()
                self._recover(st, slot_blocks[st.slot])
        self.engine.refresh_checksums(written)
        return emitted

    def run(self, requests=None, now_fn=None, max_steps: int = 100_000,
            burst: int = 1, fault_hook=None,
            speculate: Optional[int] = None,
            draft_planes: Optional[int] = None) -> Dict[Any, np.ndarray]:
        """Drive until every submitted request reaches a terminal state.
        ``now_fn`` feeds the admission clock (trace simulation); None
        admits on submit order only. ``burst`` > 1 decodes K tokens per
        scheduler step (one scan dispatch), touching the host only
        between bursts; ``speculate=K`` instead runs self-speculative
        draft+verify rounds (see ``step``). ``fault_hook(step)`` runs
        before each step — the serving analogue of the train loop's
        chaos hook (the FaultInjector plugs in here). Returns uid ->
        tokens for requests that finished ``ok``; other outcomes are in
        ``results``."""
        if requests:
            for r in requests:
                self.submit(r)
        for step_i in range(max_steps):
            if self.idle:
                return dict(self.finished)
            if fault_hook is not None:
                fault_hook(step_i)
            self.step(now=None if now_fn is None else now_fn(),
                      burst=burst, speculate=speculate,
                      draft_planes=draft_planes)
        raise RuntimeError(f"scheduler did not drain in {max_steps} steps")
