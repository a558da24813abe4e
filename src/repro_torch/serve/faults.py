"""Deterministic fault injection for the paged serving stack.

The serving analogue of the train loop's chaos hook (train/loop.py's
``fault_hook(step)`` fires before every train step): a ``FaultInjector``
is a callable passed to ``Scheduler.run(fault_hook=...)`` and fires
before every scheduler step, seeded so every chaos run is reproducible.

Three fault families, matching what the fault-tolerance layer defends
against:

* **Bit flips** in packed KV planes (``flip_random_bit`` /
  ``p_flip``) — in-memory corruption of allocated blocks, detected by
  the engine's per-block checksums before the next gather.
* **Poisoned bases** (``poison_block_bases``) — a block whose group
  exponents are forced to the top of the range so decompression produces
  non-finite values: corruption the NaN/Inf logit guard must catch when
  checksum integrity is off (or for decodable-but-wrong planes).
* **Alloc failures** (``p_alloc_fail``) — the pool transiently refuses
  an admission-time allocation (the wrapper only fires for slots that
  own nothing yet, so running slots' growth is never sabotaged — that is
  the scheduler's own preemption path); the scheduler must requeue
  gracefully, not crash.

Arrival floods — the third chaos axis — are a workload property, not an
injected fault: drive them with many same-arrival requests (see
``launch/serve.py --trace --flood`` and bench_serve's degraded section).

Every injected fault is appended to ``events`` for test assertions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.serve.engine import PagedEngine


@dataclasses.dataclass
class FaultEvent:
    step: int
    kind: str                   # bit_flip | poison_bases | alloc_fail
    detail: Dict[str, Any]


class FaultInjector:
    def __init__(self, engine: PagedEngine, seed: int = 0,
                 p_flip: float = 0.0, p_alloc_fail: float = 0.0):
        self.engine = engine
        self.rng = np.random.RandomState(seed)
        self.p_flip = float(p_flip)
        self.p_alloc_fail = float(p_alloc_fail)
        self.events: List[FaultEvent] = []
        self._step = -1
        self._armed_alloc_fails = 0
        self._orig_alloc = None
        if self.p_alloc_fail > 0:
            self.attach_alloc_failures()

    # -- bit flips -------------------------------------------------------

    def flip_random_bit(self, step: int = -1) -> Optional[int]:
        """Flip one seeded-random bit in a random *allocated* block's
        packed planes; returns the physical block id (None when nothing
        is allocated — there is no victim to corrupt)."""
        owned = self.engine.pool.owned_ids()
        if not owned:
            return None
        phys = int(owned[self.rng.randint(len(owned))])
        detail = {"phys": phys,
                  "layer": int(self.rng.randint(1 << 16)),
                  "field": int(self.rng.randint(4)),
                  "row": int(self.rng.randint(1 << 16)),
                  "col": int(self.rng.randint(1 << 16)),
                  "bit": int(self.rng.randint(32))}
        self.engine.corrupt_block(phys, layer=detail["layer"],
                                  field=detail["field"], row=detail["row"],
                                  col=detail["col"], bit=detail["bit"])
        self.events.append(FaultEvent(step, "bit_flip", detail))
        return phys

    def poison_block_bases(self, phys: int, value: int = 0xFF,
                           step: int = -1) -> None:
        """Force every group base of block ``phys`` to ``value``: the
        shared exponents saturate, decompression goes non-finite, and the
        NaN/Inf logit guard (not the checksum) must catch it."""
        eng = self.engine
        for entry in eng._global_entries():
            for li in entry:
                kv = eng.mem["layers"][li]
                kv.k_bases[int(phys)] = value
                kv.v_bases[int(phys)] = value
        self.events.append(FaultEvent(step, "poison_bases",
                                      {"phys": int(phys), "value": value}))

    # -- alloc failures --------------------------------------------------

    def attach_alloc_failures(self) -> None:
        """Wrap ``pool.alloc_upto`` so armed failures refuse admission-time
        allocations (slots owning nothing yet) once each."""
        if self._orig_alloc is not None:
            return
        pool = self.engine.pool
        orig = self._orig_alloc = pool.alloc_upto

        def alloc_upto(slot, n_tokens, block_bytes=None):
            if self._armed_alloc_fails > 0 and pool.slot_blocks(slot) == 0:
                self._armed_alloc_fails -= 1
                self.events.append(FaultEvent(
                    self._step, "alloc_fail",
                    {"slot": int(slot), "n_tokens": int(n_tokens)}))
                return False
            return orig(slot, n_tokens, block_bytes=block_bytes)

        pool.alloc_upto = alloc_upto

    def arm_alloc_failure(self, n: int = 1) -> None:
        """Deterministically arm ``n`` one-shot admission alloc failures
        (the probabilistic path arms these via ``p_alloc_fail``)."""
        self.attach_alloc_failures()
        self._armed_alloc_fails += int(n)

    def detach(self) -> None:
        """Restore the unwrapped allocator."""
        if self._orig_alloc is not None:
            self.engine.pool.alloc_upto = self._orig_alloc
            self._orig_alloc = None

    # -- the hook --------------------------------------------------------

    def __call__(self, step: int) -> None:
        self._step = step
        if self.p_flip and self.rng.random_sample() < self.p_flip:
            self.flip_random_bit(step)
        if self.p_alloc_fail and self.rng.random_sample() < self.p_alloc_fail:
            self._armed_alloc_fails += 1

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out
