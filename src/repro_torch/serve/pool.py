"""Paged packed-KV block pool: host-side allocator for the serving engine.

The serving analogue of the paper's containers-at-the-memory-interface: KV
bytes live *packed* in fixed-size physical blocks (one block = the packed
flash-decode kernel's KV block — ``ops.DECODE_BLOCK_L`` token rows), and a
request owns blocks, not a contiguous region. Device memory is one
request-agnostic pool slice per global-attention layer
(``kvcache.PagedKV``); this module owns everything host-side: the free
list, per-slot block tables, admission accounting, eviction, and the
block *quarantine* (integrity-failed blocks held out of circulation until
scrubbed — see serve/faults.py and the scheduler's recovery path).

Because blocks are codec-packed, pool capacity is measured in *compressed*
bytes — an sfp8 pool holds ~2x the tokens of a raw bf16 cache in the same
HBM footprint, which is exactly the admission-throughput win the scheduler
converts into tok/s. A *dense* policy-derived geometry (``sfp-m{K}e{E}``,
bit-plane payloads) pushes the same lever further: a 7-bit ``sfp-m2e4``
pool holds ~2.27x the tokens of raw bf16 where fixed-lane sfp8 stops at
~1.98x.

Admission can additionally be gated on a **byte budget** that is decoupled
from the physical block count: each slot registers the dense-packed bytes
*its* geometry makes one block cost, so requests admitted at a narrower
container (the pressure controller's graceful-degradation downshift,
serve/precision.py) are priced at their narrower geometry and more of
them fit the same modeled HBM budget. The device arrays stay sized for
the widest geometry (fixed shapes keep the decode step one shape); the
byte accounting models what the blocks would occupy repacked dense.

Physical block 0 is reserved as the *trash block*: idle engine slots (and
logical blocks past a row's allocation) point their table entries at it,
so the fixed-shape decode step can always scatter/gather without
branching — writes to block 0 are garbage by construction and never read
through a valid position mask.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np

TRASH_BLOCK = 0


def blocks_for(n_tokens: int, block_l: int) -> int:
    """Physical blocks needed to hold ``n_tokens`` KV rows."""
    return max(0, -(-int(n_tokens) // block_l))


@dataclasses.dataclass
class PoolStats:
    num_blocks: int      # allocatable blocks (trash block excluded)
    free_blocks: int
    used_blocks: int
    peak_used: int
    quarantined: int = 0
    block_bytes: int = 0   # dense-packed bytes per block at the pool's
    #                        configured (widest) geometry; 0 = not priced
    capacity_bytes: int = 0
    used_bytes: int = 0
    free_bytes: int = 0
    peak_bytes: int = 0
    budget_bytes: Optional[int] = None


class BlockPool:
    """Free list + per-slot block tables over ``num_blocks`` physical blocks.

    ``num_blocks`` counts *allocatable* blocks; one extra trash block is
    implicit (physical id 0), so device pool arrays must be sized
    ``num_blocks + 1``. Tables are dense numpy (max_slots, max_logical)
    int32 uploaded to the decode step each call; unallocated entries point
    at the trash block.

    Admission accounting is measured in *dense-packed bytes*:
    ``block_bytes`` is what one physical block really occupies under the
    pool's configured codec geometry (payload words or bit planes + group
    bases, summed over the layers sharing this pool — see
    ``kvcache.paged_block_bytes``). A slot may register a different
    per-block rate at allocation time (``alloc_upto(block_bytes=...)``):
    that is the graceful-degradation path, where admissions downshifted
    to a narrower dense geometry are priced at the narrower rate. When a
    ``budget_bytes`` cap is set, admission is gated on the byte budget as
    well as the physical free list, so cheaper (narrower) blocks admit
    proportionally more tokens into the same modeled HBM budget.

    Blocks that fail integrity verification are **quarantined**: removed
    from circulation (neither owned nor free) until ``rehabilitate`` puts
    them back — the engine scrubs (zeroes + re-checksums) the device block
    first.
    """

    def __init__(self, num_blocks: int, max_slots: int, max_logical: int,
                 block_l: int, block_bytes: int = 0,
                 budget_bytes: Optional[int] = None):
        assert num_blocks >= 1 and max_slots >= 1 and max_logical >= 1
        self.num_blocks = int(num_blocks)
        self.block_l = int(block_l)
        self.block_bytes = int(block_bytes)
        self.budget_bytes = None if budget_bytes is None else int(budget_bytes)
        self.max_slots = int(max_slots)
        self.max_logical = int(max_logical)
        # LIFO free list: physical ids 1..num_blocks (0 is trash).
        self._free: List[int] = list(range(self.num_blocks, 0, -1))
        self._owned: Dict[int, List[int]] = {}  # slot -> physical ids
        self._rate: Dict[int, int] = {}         # slot -> bytes per block
        self._quarantined: List[int] = []
        self.tables = np.full((max_slots, max_logical), TRASH_BLOCK,
                              np.int32)
        self.peak_used = 0
        self._peak_bytes = 0
        # Telemetry sink (repro_torch.obs.Obs), installed by the scheduler;
        # watermark gauges refresh on every alloc/free so the exported
        # metrics track occupancy without polling.
        self.obs: Optional[object] = None

    def _obs_watermarks(self) -> None:
        obs = self.obs
        if obs is None:
            return
        reg = obs.registry
        reg.gauge("pool_used_blocks", "allocated physical blocks"
                  ).set(self.used_blocks)
        reg.gauge("pool_free_blocks", "free-list physical blocks"
                  ).set(self.free_blocks)
        reg.gauge("pool_quarantined_blocks",
                  "blocks held out pending scrub"
                  ).set(len(self._quarantined))
        reg.gauge("pool_used_bytes",
                  "dense-packed bytes live (per-slot geometry pricing)",
                  unit="B").set(self.used_bytes)

    # -- accounting ------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free) - len(self._quarantined)

    @property
    def quarantined_blocks(self) -> List[int]:
        return list(self._quarantined)

    @property
    def used_bytes(self) -> int:
        """Dense-packed bytes live right now, priced per slot geometry."""
        return sum(len(owned) * self._rate.get(slot, self.block_bytes)
                   for slot, owned in self._owned.items())

    def slot_rate(self, slot: int) -> int:
        """Bytes one block costs for ``slot`` (its admission geometry)."""
        return self._rate.get(slot, self.block_bytes)

    def bytes_for(self, n_tokens: int, block_bytes: Optional[int] = None
                  ) -> int:
        """Dense-packed bytes a request holding ``n_tokens`` KV rows pins
        (block-granular — partial blocks occupy whole blocks)."""
        rate = self.block_bytes if block_bytes is None else int(block_bytes)
        return blocks_for(n_tokens, self.block_l) * rate

    def stats(self) -> PoolStats:
        cap = (self.budget_bytes if self.budget_bytes is not None
               else self.num_blocks * self.block_bytes)
        used = self.used_bytes
        return PoolStats(num_blocks=self.num_blocks,
                         free_blocks=self.free_blocks,
                         used_blocks=self.used_blocks,
                         peak_used=self.peak_used,
                         quarantined=len(self._quarantined),
                         block_bytes=self.block_bytes,
                         capacity_bytes=cap,
                         used_bytes=used,
                         free_bytes=max(0, cap - used),
                         peak_bytes=self._peak_bytes,
                         budget_bytes=self.budget_bytes)

    def slot_blocks(self, slot: int) -> int:
        return len(self._owned.get(slot, ()))

    def owner_of(self, phys: int) -> Optional[int]:
        """Slot owning physical block ``phys``; None if free/quarantined."""
        for slot, owned in self._owned.items():
            if phys in owned:
                return slot
        return None

    def owned_ids(self) -> List[int]:
        """Every currently allocated physical block id."""
        return [p for owned in self._owned.values() for p in owned]

    def _bytes_ok(self, extra_blocks: int, rate: int) -> bool:
        if self.budget_bytes is None:
            return True
        return self.used_bytes + extra_blocks * rate <= self.budget_bytes

    def can_admit(self, n_tokens: int, block_bytes: Optional[int] = None,
                  reserve_blocks: int = 0) -> bool:
        """Admission gate: blocks covering the prompt KV rows *and* the
        first decode token must fit, so a fresh request always takes its
        first step without immediately preempting someone. (That is one
        extra block only when the prompt lands exactly on a block
        boundary — a blanket +1 would leave one slot's worth of pool
        permanently idle at full residency.)

        ``block_bytes`` prices the candidate at its own (possibly
        downshifted) geometry against the byte budget; ``reserve_blocks``
        holds back blocks the currently running requests will need for
        their next step (the preemption-storm guard's no-thrash
        headroom)."""
        rate = self.block_bytes if block_bytes is None else int(block_bytes)
        need = blocks_for(n_tokens + 1, self.block_l)
        return (need + reserve_blocks <= self.free_blocks
                and self._bytes_ok(need, rate))

    # -- allocation ------------------------------------------------------

    def _check_slot(self, slot: int) -> int:
        slot = int(slot)
        if not 0 <= slot < self.max_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.max_slots})")
        return slot

    def alloc_upto(self, slot: int, n_tokens: int,
                   block_bytes: Optional[int] = None) -> bool:
        """Grow ``slot``'s table to cover positions [0, n_tokens).

        Returns False (allocating nothing) if the pool cannot supply every
        missing block — the caller then preempts someone and retries.
        ``block_bytes`` registers the slot's per-block byte rate on its
        first allocation (the admission geometry); growth reuses the
        registered rate.
        """
        slot = self._check_slot(slot)
        if n_tokens < 0:
            raise ValueError(f"n_tokens must be >= 0, got {n_tokens}")
        need = blocks_for(n_tokens, self.block_l)
        if need > self.max_logical:
            raise ValueError(
                f"request needs {need} blocks > max_logical "
                f"{self.max_logical} (engine max_len too small)")
        owned = self._owned.setdefault(slot, [])
        if slot not in self._rate:
            self._rate[slot] = (self.block_bytes if block_bytes is None
                                else int(block_bytes))
        missing = need - len(owned)
        if missing <= 0:
            return True
        if missing > len(self._free):
            return False
        if not self._bytes_ok(missing, self._rate[slot]):
            return False
        for _ in range(missing):
            phys = self._free.pop()
            self.tables[slot, len(owned)] = phys
            owned.append(phys)
        self.peak_used = max(self.peak_used, self.used_blocks)
        self._peak_bytes = max(self._peak_bytes, self.used_bytes)
        self._obs_watermarks()
        return True

    def free_slot(self, slot: int, quarantine: Iterable[int] = ()) -> int:
        """Release every block ``slot`` owns (finish or preemption);
        returns the number of blocks recycled to the free list.

        Raises on double-free (a slot that owns nothing) — a freed slot
        whose blocks were already recycled must never be freed again, or
        its old physical ids would alias another request's blocks.
        ``quarantine`` names owned blocks that failed integrity
        verification: they are held out of circulation instead of
        returning to the free list (see ``rehabilitate``).
        """
        slot = self._check_slot(slot)
        if slot not in self._owned:
            raise KeyError(f"double free: slot {slot} owns no blocks")
        # Validate the quarantine set *before* mutating anything: a
        # rejected call must leave the slot's ownership intact.
        bad = set(int(p) for p in quarantine)
        if TRASH_BLOCK in bad:
            raise ValueError("the reserved trash block cannot be "
                             "quarantined")
        unknown = bad - set(self._owned[slot])
        if unknown:
            raise ValueError(f"cannot quarantine blocks {sorted(unknown)}: "
                             f"not owned by slot {slot}")
        owned = self._owned.pop(slot)
        self._rate.pop(slot, None)
        recycled = [p for p in owned if p not in bad]
        self._free.extend(reversed(recycled))
        self._quarantined.extend(sorted(bad))
        self.tables[slot, :] = TRASH_BLOCK
        if bad and self.obs is not None:
            self.obs.event("quarantine", slot=slot, blocks=sorted(bad))
        self._obs_watermarks()
        return len(recycled)

    def rehabilitate(self, phys: int) -> None:
        """Return a quarantined block to the free list. The caller must
        have scrubbed the device block first (zeroed + re-checksummed:
        ``PagedEngine.scrub_block``)."""
        phys = int(phys)
        if phys == TRASH_BLOCK:
            raise ValueError("the reserved trash block is never pooled")
        if phys not in self._quarantined:
            raise ValueError(f"block {phys} is not quarantined")
        self._quarantined.remove(phys)
        self._free.append(phys)
        if self.obs is not None:
            self.obs.event("rehabilitate", block=phys)
        self._obs_watermarks()

    def reset(self) -> None:
        for slot in list(self._owned):
            self.free_slot(slot)

    # -- debug invariants ------------------------------------------------

    def verify_invariants(self) -> None:
        """Raise AssertionError unless the allocator is self-consistent:
        every physical id 1..num_blocks is exactly one of free / owned by
        exactly one slot / quarantined, tables mirror the owned lists,
        and the byte accounting respects the budget. Used by the chaos
        tests after every injected fault."""
        free = list(self._free)
        owned_all = self.owned_ids()
        quar = list(self._quarantined)
        ids = free + owned_all + quar
        assert len(ids) == len(set(ids)), (
            f"block id owned twice: free={free} owned={owned_all} "
            f"quarantined={quar}")
        assert set(ids) == set(range(1, self.num_blocks + 1)), (
            f"block ids leaked: have {sorted(ids)}")
        assert TRASH_BLOCK not in ids
        for slot, owned in self._owned.items():
            row = self.tables[slot]
            assert list(row[:len(owned)]) == owned, (
                f"slot {slot} table/owned mismatch: "
                f"{row[:len(owned)].tolist()} vs {owned}")
            assert (row[len(owned):] == TRASH_BLOCK).all(), (
                f"slot {slot} table has entries past its allocation")
        for slot in range(self.max_slots):
            if slot not in self._owned:
                assert (self.tables[slot] == TRASH_BLOCK).all(), (
                    f"unowned slot {slot} has live table entries")
        if self.budget_bytes is not None:
            assert self.used_bytes <= self.budget_bytes, (
                f"byte budget exceeded: {self.used_bytes} > "
                f"{self.budget_bytes}")
