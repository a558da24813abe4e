"""Serving engine: prefill + decode over a (packed) KV cache.

Two modes share the model:

* **Contiguous** (``generate``): one prefill, then a greedy decode loop.
  The JAX package's jitted ``lax.scan`` becomes a Python loop over one
  preallocated cache that every step updates in place (JAX donates it).
  ``make_prefill_step``, ``make_serve_step`` and ``make_decode_loop`` are
  the JAX package's step functions; on a mesh ``generate`` runs through
  them, and ``cache_axes`` names where each cache leaf lives: batch rows
  over the batch axes, the KV sequence over ``model`` (flash-decoding
  style: each rank attends over its slots, the partials are combined),
  the SSD heads and RG-LRU channels over ``model`` (the model's note).
* **Paged** (``PagedEngine``): the continuous-batching substrate. A fixed
  number of batch *slots* share one codec-packed KV block pool
  (serve/pool.py); one fixed-shape decode step advances every slot at its
  own position, and the paged decode kernel reads the GLOBAL layers'
  blocks through the block table; LOCAL layers keep per-slot rings and SSD
  / RG-LRU layers per-slot recurrent state. Queueing, admission and
  preemption live above, in serve/scheduler.py. The JAX package gives its
  pool no sharding axes, so the paged engine refuses a mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import NotYetPorted, codecs, resolve_device
from repro_torch.configs.base import GLOBAL, LOCAL, RGLRU, SSD
from repro_torch.kernels import ops
from repro_torch.models.model import PAGED_MESH, DecoderModel
from repro_torch.serve import kvcache
from repro_torch.serve import pool as _pool


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor          # (B, max_new) greedy tokens
    steps: int
    prefill_logits: torch.Tensor  # (B, V) f32 logits after the prompt
    margins: torch.Tensor         # (B, max_new) top-1 minus top-2 logit


def _greedy(logits: torch.Tensor):
    """(B, 1, V) logits -> (first argmax (B, 1), top-2 margin (B,))."""
    last = logits[:, -1, :]
    top2 = torch.topk(last, 2, dim=-1).values
    return torch.argmax(last, dim=-1, keepdim=True), top2[:, 0] - top2[:, 1]


def cache_axes(model: DecoderModel, batch: int = 1, max_len: int = 1
               ) -> Dict[str, Any]:
    """The logical sharding axes of ``model.init_cache(batch, max_len)``,
    leaf for leaf (the JAX package's ``cache_axes``, one entry a layer
    instead of a leading ``layers`` axis): a raw KV cache ("batch",
    "cache_seq", "kv", None), a packed one ("batch", "cache_seq", None,
    ...) on every part, an SSD state ("batch", "heads", None, None) with
    ``conv_x`` over "ssm_inner", an RG-LRU state ("batch", "lru")."""
    return model.cache_axes(batch, max_len)


def _serve(model: DecoderModel, params, cache, token, pos):
    """One greedy decode step: (next token (B, 1), its top-2 margin (B,),
    cache)."""
    logits, cache = model.decode_step(params, cache, token, pos)
    return (*_greedy(logits), cache)


def make_serve_step(model: DecoderModel):
    """(params, cache, token (B, 1), pos) -> (next_token (B, 1), cache):
    one greedy decode step."""

    def serve_step(params, cache, token, pos):
        tok, _, cache = _serve(model, params, cache, token, pos)
        return tok, cache

    return serve_step


def make_prefill_step(model: DecoderModel, max_len: int):
    """(params, tokens (B, S), cond_embeddings=None) -> (logits (B, 1, V),
    cache): the prompt's prefill into a cache of ``max_len`` slots."""

    def prefill_step(params, tokens, cond_embeddings=None):
        return model.prefill(params, tokens, max_len,
                             cond_embeddings=cond_embeddings)

    return prefill_step


def make_decode_loop(model: DecoderModel, n_steps: int):
    """(params, cache, token (B, 1), pos0) -> (tokens (n_steps, B, 1),
    cache): ``n_steps`` greedy steps from ``token`` at position ``pos0``,
    the cache updated in place (the JAX package donates it to its scan)."""
    serve_step = make_serve_step(model)

    def loop(params, cache, tok, pos0):
        toks = []
        for i in range(n_steps):
            tok, cache = serve_step(params, cache, tok, pos0 + i)
            toks.append(tok)
        return torch.stack(toks), cache

    return loop


@torch.inference_mode()
def generate(model: DecoderModel, params, prompt: torch.Tensor, max_new: int,
             max_len: Optional[int] = None,
             cond_embeddings: Optional[torch.Tensor] = None
             ) -> GenerationResult:
    """Greedy batched generation of ``max_new`` tokens after ``prompt``
    (B, S), on the model's device (CUDA unless the model was built with
    ``device="cpu"``). A prefix-LM's ``cond_embeddings`` (B, P, d_model)
    go before the prompt; decoding then starts at position P + S. On a
    mesh, ``params`` are the rank's shards, ``prompt`` the whole batch on
    every rank, and the result the whole batch's. The prefill is
    ``make_prefill_step``'s, each step ``make_serve_step``'s with its
    margin kept."""
    dev = resolve_device(model.device)
    prompt = prompt.to(dev)
    B, S = prompt.shape
    P = model.cfg.prefix_tokens if cond_embeddings is not None else 0
    max_len = max_len or (P + S + max_new)
    prefill_logits, cache = make_prefill_step(model, max_len)(
        params, prompt, cond_embeddings)
    tok, margin = _greedy(prefill_logits)
    toks, margins = [tok], [margin]
    for i in range(max_new - 1):
        tok, margin, cache = _serve(model, params, cache, tok, P + S + i)
        toks.append(tok)
        margins.append(margin)
    return GenerationResult(tokens=torch.cat(toks, dim=1), steps=max_new,
                            prefill_logits=prefill_logits[:, -1, :],
                            margins=torch.stack(margins, dim=1))


# ---------------------------------------------------------------------------
# Paged continuous-batching engine
# ---------------------------------------------------------------------------


class PagedEngine:
    """Fixed-shape batch-slot serving over a paged packed-KV block pool.

    ``max_slots`` requests decode together in one step; each GLOBAL layer
    stores K/V in codec-packed physical blocks (``block_l`` = the decode
    kernel's tile) shared by the slots and addressed through per-slot block
    tables; LOCAL layers keep per-slot packed rings (window-bounded), SSD
    and RG-LRU layers a ``max_slots``-row state (an arch without a GLOBAL
    layer prices a block at 0 bytes: the pool still gates admission by
    block count, and the integrity checks have nothing to check). Idle
    slots run the same step on the trash block and their outputs are
    discarded, so the step has one shape whatever requests come and go.

    The engine is mechanism only: it owns device memory, the block pool
    and the decode step; admission, preemption and streaming live in
    ``serve/scheduler.py``. Device memory is updated in place (JAX donates
    it). Per step the host uploads the block table and downloads the tokens
    and the non-finite-logit flags, nothing else.
    """

    def __init__(self, model: DecoderModel, params, *, max_slots: int = 8,
                 max_len: int = 256, num_blocks: Optional[int] = None,
                 degraded_container: Optional[str] = None,
                 integrity: bool = True):
        if model.mesh is not None:
            raise NotYetPorted(PAGED_MESH)
        if model.kv_container is None:
            raise ValueError("PagedEngine needs a model with kv_container "
                             "set (the pool stores packed blocks)")
        cfg = model.cfg
        if cfg.prefix_tokens:
            raise NotImplementedError(
                "prefix-conditioned archs are not paged-served yet")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = model.device
        self.container = model.kv_container
        self.block_l = ops.DECODE_BLOCK_L
        # The pool block is the kernel tile; rounding max_len up keeps
        # prefill's packed cache (cache_len) and the block grid the same
        # length, so prefill rows scatter into whole blocks.
        self.max_len = -(-max_len // self.block_l) * self.block_l
        self.nmax = self.max_len // self.block_l
        self.max_slots = int(max_slots)
        if num_blocks is None:
            num_blocks = self.max_slots * self.nmax  # full residency
        # Fail fast if the codec cannot page, and price one block in
        # packed bytes across the layers that share the pool.
        kvcache.paged_block_spec(cfg, 1, self.block_l, self.container)
        self.n_global_layers = sum(k == GLOBAL for k in model.kinds)
        self._recurrent = [i for i, k in enumerate(model.kinds)
                           if k in (SSD, RGLRU)]
        self.block_bytes = self.n_global_layers * kvcache.paged_block_bytes(
            cfg, self.block_l, self.container)
        # Graceful degradation (serve/precision.PressureController): under
        # pressure new requests are admitted at a narrower dense geometry,
        # priced at its per-block bytes against a budget of `num_blocks`
        # blocks at the configured geometry; the arrays over-provision
        # blocks so that the cheaper blocks are allocatable (the shapes
        # stay fixed; the accounting models the bytes repacked narrow).
        self.degraded_container = degraded_container
        if degraded_container is not None:
            self.degraded_block_bytes = (
                self.n_global_layers
                * kvcache.paged_block_bytes(cfg, self.block_l,
                                            degraded_container))
            if self.degraded_block_bytes >= self.block_bytes:
                raise ValueError(
                    f"degraded container {degraded_container!r} "
                    f"({self.degraded_block_bytes} B/block) is not narrower "
                    f"than {self.container!r} ({self.block_bytes} B/block)")
            budget_bytes = num_blocks * self.block_bytes
            phys_blocks = min(-(-budget_bytes // self.degraded_block_bytes),
                              self.max_slots * self.nmax)
            phys_blocks = max(phys_blocks, num_blocks)
        else:
            self.degraded_block_bytes = self.block_bytes
            budget_bytes = None
            phys_blocks = num_blocks
        self.pool = _pool.BlockPool(phys_blocks, self.max_slots, self.nmax,
                                    self.block_l,
                                    block_bytes=self.block_bytes,
                                    budget_bytes=budget_bytes)
        self.mem = self._init_mem()
        self.decode_steps = 0
        self.spec_rounds = 0
        # Block integrity: a per-physical-block checksum over the packed
        # parts (kvcache.paged_block_checksums summed over the GLOBAL
        # layers), recorded after every legitimate write and compared
        # before every read. The scheduler drives verify/refresh.
        self.integrity = bool(integrity)
        self.expected_sums = np.zeros(self.pool.num_blocks + 1, np.uint32)
        # Telemetry sink (repro_torch.obs.Obs); the driving Scheduler
        # installs its own. Recording happens on the host after the step's
        # outputs were downloaded.
        self.obs: Optional[Any] = None

    def _observe(self, name: str, help: str, seconds: float) -> None:
        if self.obs is not None:
            self.obs.registry.histogram(name, help,
                                        unit="s").observe(seconds)

    # -- device memory ---------------------------------------------------

    def _init_mem(self) -> Dict[str, List[Any]]:
        """One entry per layer: a ``PagedKV`` pool slice for GLOBAL layers
        (physical block 0 is the trash block, pool.TRASH_BLOCK), a packed
        ``max_slots``-row ring for LOCAL ones, a ``max_slots``-row
        ``SSDCache`` / ``LRUCache`` of zeros for SSD / RG-LRU ones."""
        cfg, dev = self.cfg, self.device
        layers = []
        for kind in self.model.kinds:
            if kind == GLOBAL:
                layers.append(kvcache.paged_block_init(
                    cfg, self.pool.num_blocks + 1, self.block_l,
                    self.container, device=dev))
            elif kind == LOCAL:
                layers.append(kvcache.packed_cache_init(
                    cfg, kind, self.max_slots, self.max_len, self.container,
                    device=dev))
            else:
                layers.append(self.model._layer_cache(kind, self.max_slots,
                                                      self.max_len))
        return {"layers": layers}

    def _tensors(self):
        for kind, layer in zip(self.model.kinds, self.mem["layers"]):
            if kind == LOCAL:
                for pt in layer:
                    yield from pt.data.values()
            else:   # PagedKV, SSDCache, LRUCache: tuples of tensors
                yield from layer

    def cache_bytes(self) -> Dict[str, float]:
        """Realized device bytes of the pool, rings and recurrent state,
        and the packed bytes live in allocated blocks, per the host byte
        accounting."""
        total = float(sum(t.numel() * t.element_size()
                          for t in self._tensors()))
        st = self.pool.stats()
        return {"total": total,
                "live_block_fraction":
                    st.used_blocks / max(1, st.num_blocks),
                "block_bytes": float(st.block_bytes),
                "pool_capacity_bytes": float(st.capacity_bytes),
                "pool_live_bytes": float(st.used_bytes),
                "pool_peak_bytes": float(st.peak_bytes)}

    # -- block integrity -------------------------------------------------

    def _global_entries(self) -> List[List[int]]:
        """Layer indices of the GLOBAL layers, one list per GLOBAL position
        of the period (its layers in period order, as the JAX package
        stacks them), then one per GLOBAL remainder layer."""
        cfg, n = self.cfg, len(self.cfg.period)
        out = [[p * n + i for p in range(cfg.n_periods)]
               for i, k in enumerate(cfg.period) if k == GLOBAL]
        out += [[cfg.n_periods * n + i]
                for i, k in enumerate(cfg.remainder) if k == GLOBAL]
        return out

    def _block_sums(self, ids: Optional[List[int]] = None) -> np.ndarray:
        """uint32 checksums of physical blocks ``ids`` (all when None),
        each summed over the GLOBAL layers with salt = entry + 1: zeros
        when there is none."""
        if not self.n_global_layers:
            return np.zeros(self.pool.num_blocks + 1 if ids is None
                            else len(ids), np.uint32)
        idx = (None if ids is None else
               torch.as_tensor(ids, dtype=torch.long, device=self.device))
        total = None
        with torch.no_grad():
            for j, entry in enumerate(self._global_entries()):
                s = kvcache.paged_block_checksums(
                    [self.mem["layers"][li] for li in entry], salt=j + 1,
                    ids=idx)
                total = s if total is None else total + s
        return (total & 0xFFFFFFFF).cpu().numpy().astype(np.uint32)

    def block_checksums(self) -> np.ndarray:
        """Current checksums of every physical block (trash block = id 0)."""
        return self._block_sums()

    def verify_blocks(self, ids) -> list:
        """The physical block ids among ``ids`` whose packed parts no longer
        match the checksum recorded at their last legitimate write."""
        ids = [int(p) for p in ids if p != _pool.TRASH_BLOCK]
        if not self.integrity or not ids or not self.n_global_layers:
            return []
        t0 = time.perf_counter()
        sums = self._block_sums(ids)
        bad = [p for p, s in zip(ids, sums) if s != self.expected_sums[p]]
        self._observe("serve_verify_seconds",
                      "block checksum verification wall time",
                      time.perf_counter() - t0)
        return bad

    def refresh_checksums(self, ids) -> None:
        """Record the current checksums of ``ids`` as expected: called
        after every legitimate write (prefill scatter, decode step)."""
        ids = [int(p) for p in ids if p != _pool.TRASH_BLOCK]
        if not self.integrity or not ids or not self.n_global_layers:
            return
        self.expected_sums[ids] = self._block_sums(ids)

    def corrupt_block(self, phys: int, *, layer: int = 0, field: int = 0,
                      row: int = 0, col: int = 0, bit: int = 0) -> None:
        """Chaos/test hook: flip one bit of a packed part of block
        ``phys``. ``layer`` picks a GLOBAL entry (its first layer),
        ``field`` the part (k_payload, k_bases, v_payload, v_bases)."""
        entries = self._global_entries()
        if not entries:
            raise ValueError(f"{self.cfg.name}: the engine has no paged "
                             f"(GLOBAL) layer to corrupt")
        kv = self.mem["layers"][entries[layer % len(entries)][0]]
        arr = kv[field % len(kv)]
        idx = (int(phys), row % arr.shape[-2], col % arr.shape[-1])
        nbits = 8 * arr.element_size()
        signed = {1: torch.int8, 2: torch.int16, 4: torch.int32}[
            arr.element_size()]
        view = arr.view(signed)
        word = (int(view[idx]) & ((1 << nbits) - 1)) ^ (1 << (bit % nbits))
        if word >= 1 << (nbits - 1):
            word -= 1 << nbits
        view[idx] = word

    def scrub_block(self, phys: int) -> None:
        """Zero a (quarantined) block's parts in every GLOBAL layer and
        record its checksum, so it can return to the free list
        (pool.rehabilitate)."""
        for entry in self._global_entries():
            for li in entry:
                for a in self.mem["layers"][li]:
                    a[int(phys)] = 0
        self.refresh_checksums([phys])
        if self.obs is not None:
            self.obs.event("scrub_block", block=int(phys))

    # -- prefill ---------------------------------------------------------

    def _requant(self, pref_cache):
        """Round-trip the GLOBAL layers' prompt K/V through the degraded
        codec and repack it at the configured container: the stored values
        carry the narrow geometry (exactly representable in the wide one),
        the pool keeps one shape. Decode appends stay full width; the
        pool's byte rates price the slot at the narrow geometry."""
        wide = codecs.get(self.container)
        narrow = codecs.get(self.degraded_container)

        def one(pt):
            vals = wide.unpack(kvcache._flat(pt))
            return kvcache._seq_major(wide.pack(
                narrow.unpack(narrow.pack(vals))))

        layers = list(pref_cache["layers"])
        for i, kind in enumerate(self.model.kinds):
            if kind == GLOBAL:
                layers[i] = kvcache.PackedKV(k=one(layers[i].k),
                                             v=one(layers[i].v))
        return {"layers": layers}

    def _scatter(self, pref_cache, slot: int, ids: torch.Tensor) -> None:
        """Write one request's prefill cache into slot ``slot``: GLOBAL
        layers scatter whole blocks to the physical ``ids`` (unallocated
        logical blocks name the trash block and receive identical packed
        zero rows), LOCAL layers overwrite their ring row, SSD and RG-LRU
        layers their state row."""
        nmax, bl = self.nmax, self.block_l
        for kind, mem, pref in zip(self.model.kinds, self.mem["layers"],
                                   pref_cache["layers"]):
            if kind in (SSD, RGLRU):
                for dst, src in zip(mem, pref):
                    dst[slot] = src[0]
            elif kind == GLOBAL:
                for dst, pt, key in ((mem.k_payload, pref.k, "payload"),
                                     (mem.k_bases, pref.k, "bases"),
                                     (mem.v_payload, pref.v, "payload"),
                                     (mem.v_bases, pref.v, "bases")):
                    part = pt.data[key][0]
                    dst[ids] = part.reshape(nmax, bl, *part.shape[1:])
            else:
                for dst, src in ((mem.k, pref.k), (mem.v, pref.v)):
                    for key, t in dst.data.items():
                        t[slot] = src.data[key][0]

    def prefill_into_slot(self, slot: int, prompt: np.ndarray,
                          narrow: bool = False) -> int:
        """Prefill one request into ``slot``; returns its first token.

        The slot's block table must already cover the prompt
        (``pool.alloc_upto``). The model's packed prefill runs at the
        engine-wide ``max_len``, so the packed rows equal the contiguous
        serving path's at the same budget. ``narrow=True`` (degraded
        admission) round-trips the prompt K/V through
        ``degraded_container`` first."""
        t0 = time.perf_counter()
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(f"prompt must be 1-D and non-empty, got shape "
                             f"{prompt.shape}")
        if prompt.size >= self.max_len:
            raise ValueError(f"prompt ({prompt.size}) must leave decode "
                             f"room inside max_len ({self.max_len})")
        if narrow and self.degraded_container is None:
            raise ValueError("narrow prefill needs degraded_container")
        ids_np = self.pool.tables[slot]
        with torch.no_grad():
            tokens = torch.as_tensor(prompt.astype(np.int64)[None],
                                     device=self.device)
            logits, pref = self.model.prefill(self.params, tokens,
                                              self.max_len)
            if narrow:
                pref = self._requant(pref)
            self._scatter(pref, int(slot),
                          torch.as_tensor(ids_np, dtype=torch.long,
                                          device=self.device))
            tok = int(torch.argmax(logits[0, -1]))
        if self.integrity:
            self.refresh_checksums([p for p in ids_np
                                    if p != _pool.TRASH_BLOCK])
        self._observe("serve_prefill_seconds",
                      "prefill-into-slot wall time (incl. scatter)",
                      time.perf_counter() - t0)
        return tok

    # -- decode ----------------------------------------------------------

    def _inputs(self, toks: np.ndarray, pos: np.ndarray):
        dev = self.device
        return (torch.as_tensor(self.pool.tables, device=dev),
                torch.as_tensor(np.asarray(toks, np.int64)[:, None],
                                device=dev),
                torch.as_tensor(np.asarray(pos, np.int64), device=dev))

    def _step(self, tables, tok, pos, prefix_planes=None):
        """One model step over every slot: (argmax tokens (S,), non-finite
        flags (S,)), both on the device."""
        logits, _ = self.model.decode_step_paged(
            self.params, self.mem, tok, pos, tables,
            prefix_planes=prefix_planes)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        bad = ~torch.isfinite(logits).all(dim=2).all(dim=1)
        return nxt, bad

    def decode(self, toks: np.ndarray, pos: np.ndarray):
        """One batched decode step over every slot. ``toks``/``pos`` are
        (max_slots,) host arrays; idle slots carry token 0 at position 0
        with a trash-block table row, and their tokens are meaningless.
        Returns ((max_slots,) int32 next tokens, (max_slots,) bool
        non-finite-logit flags)."""
        nxt, bad = self.decode_burst(toks, pos, 1)
        return nxt[0], bad[0]

    def decode_burst(self, toks: np.ndarray, pos: np.ndarray, burst: int):
        """``burst`` greedy decode steps over every slot with one table
        upload and one download. Each slot chains its own argmax token;
        positions advance ``pos + i``. Every running slot must own blocks
        covering ``pos + burst`` (``<= max_len``): the scheduler sees to
        it. Returns the (burst, max_slots) int32 tokens and bool
        non-finite-logit flags."""
        K = int(burst)
        if K < 1:
            raise ValueError(f"burst must be >= 1, got {K}")
        t0 = time.perf_counter()
        with torch.no_grad():
            tables, tok, pos_t = self._inputs(toks, pos)
            outs = []
            for i in range(K):
                nxt, bad = self._step(tables, tok, pos_t + i)
                outs.append(torch.stack([nxt, bad.long()]))
                tok = nxt[:, None]
            res = torch.stack(outs).cpu().numpy()       # (K, 2, S)
        self.decode_steps += K
        self._observe("serve_decode_seconds",
                      "decode dispatch wall time (whole burst)",
                      time.perf_counter() - t0)
        return res[:, 0].astype(np.int32), res[:, 1].astype(bool)

    # -- self-speculative decoding ---------------------------------------

    def default_draft_planes(self) -> int:
        """Deepest valid draft prefix shallower than full width, if any:
        the draft keeps the sign, the whole delta exponent and at least
        one mantissa bit (``ops.prefix_fields``), so a very narrow
        container may only draft at full width."""
        fields = kvcache._paged_fields(self.cfg, self.container)
        return max(fields.payload_bits - 1, fields.dexp_bits + 2)

    def validate_draft_planes(self, draft_planes: int) -> int:
        """Check ``draft_planes`` against the pool geometry; returns it."""
        fields = kvcache._paged_fields(self.cfg, self.container)
        ops.prefix_fields(fields, int(draft_planes))  # raises ValueError
        return int(draft_planes)

    def _ring_rows(self, pos_t: torch.Tensor, K: int):
        """Per LOCAL layer part, the (S, K) ring rows the K steps of a round
        write ((pos + i) mod L), with their current contents."""
        S = self.max_slots
        slots = torch.arange(S, device=self.device)[:, None]
        out = []
        for kind, layer in zip(self.model.kinds, self.mem["layers"]):
            if kind != LOCAL:
                continue
            for pt in layer:
                for t in pt.data.values():
                    L = t.shape[1]
                    if K > L:
                        raise ValueError(f"speculate K={K} exceeds the "
                                         f"{L}-slot local ring")
                    r = torch.remainder(
                        pos_t[:, None] + torch.arange(K, device=self.device),
                        L)
                    out.append((t, slots, r, t[slots, r]))
        return out

    def speculate(self, toks: np.ndarray, pos: np.ndarray, K: int,
                  draft_planes: Optional[int] = None):
        """One self-speculative round over every slot.

        * **Draft**: K decode steps whose packed-attention reads decode
          only the leading ``draft_planes`` bits (``prefix_planes``); K/V
          writes stay full width.
        * **Rewind**: the LOCAL rings and the SSD / RG-LRU state return to
          their round-start state. The pool needs no rollback: verify
          rewrites each position before any step attends to it, and later
          rows are causally masked.
        * **Verify**: K full-width steps teacher-forced with [token,
          d_1..d_{K-1}] at the same positions.
        * **Accept**: per slot, m = the longest prefix with d_i == v_i;
          ``n_emit = min(m + 1, K)`` (the verifier's token always commits).
          The committed per-slot state is the one after verify step
          ``n_emit - 1``, which is bit-exact against ``burst=1`` decode.

        The two kinds of per-slot state are rewound and committed in two
        ways, neither of which copies a whole ring or the pool:

        * A LOCAL layer's step writes only ring row (pos + i) mod L of each
          slot, so the round-start ring is those K rows per slot (saved
          before the draft), and the ring after verify step n - 1 is the
          final one with rows n..K-1 put back.
        * An SSD or RG-LRU step rewrites its layer's whole state, as new
          tensors (``decode_step`` replaces the cache entry; the JAX
          package's protocol): the round start is a reference to the
          state before the draft, put back after it; verify keeps a
          reference to the state after each of its K steps; the commit
          gathers, for each slot s, the state after step n_emit[s] - 1.

        Calling convention as ``decode_burst``. Returns (verifs (K, S)
        int32, bad (K, S) bool, accepted (S,), n_emit (S,)); the caller
        streams ``verifs[:n_emit[s], s]`` per slot."""
        K = int(K)
        if K < 1:
            raise ValueError(f"speculate K must be >= 1, got {K}")
        if draft_planes is None:
            draft_planes = self.default_draft_planes()
        dp = self.validate_draft_planes(draft_planes)
        t0 = time.perf_counter()
        with torch.no_grad():
            tables, tok0, pos_t = self._inputs(toks, pos)
            saved = self._ring_rows(pos_t, K)
            layers = self.mem["layers"]
            snap = {li: layers[li] for li in self._recurrent}
            tok, drafts = tok0, []
            for i in range(K):
                nxt, _ = self._step(tables, tok, pos_t + i, dp)
                drafts.append(nxt)
                tok = nxt[:, None]
            for t, slots, r, rows in saved:     # rewind the rings
                t[slots, r] = rows
            for li, state in snap.items():      # and the recurrent state
                layers[li] = state
            vin = [tok0[:, 0]] + drafts[:-1]
            verifs, bads, stack = [], [], []
            for i in range(K):
                nxt, bad = self._step(tables, vin[i][:, None], pos_t + i)
                verifs.append(nxt)
                bads.append(bad)
                stack.append([layers[li] for li in self._recurrent])
            drafts_t, verifs_t = torch.stack(drafts), torch.stack(verifs)
            match = torch.cumprod((drafts_t == verifs_t).long(), dim=0)
            accepted = match.sum(dim=0)
            n_emit = torch.clamp(accepted + 1, max=K)
            late = (torch.arange(K, device=self.device)[None, :]
                    >= n_emit[:, None])                 # (S, K)
            for t, slots, r, rows in saved:     # commit step n_emit - 1
                sl = slots.expand_as(r)
                t[sl[late], r[late]] = rows[late]
            pick = (n_emit - 1, torch.arange(self.max_slots,
                                             device=self.device))
            for j, li in enumerate(self._recurrent):
                layers[li] = type(layers[li])(*(
                    torch.stack(steps)[pick]
                    for steps in zip(*(st[j] for st in stack))))
            res = torch.cat([verifs_t, torch.stack(bads).long(),
                             accepted[None], n_emit[None]]).cpu().numpy()
        self.decode_steps += 2 * K  # K draft + K verify model steps
        self.spec_rounds += 1
        self._observe("serve_spec_seconds",
                      "speculative draft+verify round wall time",
                      time.perf_counter() - t0)
        return (res[:K].astype(np.int32), res[K:2 * K].astype(bool),
                res[2 * K], res[2 * K + 1])
