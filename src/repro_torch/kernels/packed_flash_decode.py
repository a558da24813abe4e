"""Fused decompress-attend decode: CUDA kernel wrappers and plain versions.

Replaces the TPU kernels ``src/repro/kernels/packed_flash_decode.py:
packed_flash_decode`` (a contiguous cache) and ``paged_flash_decode`` (a
paged block pool read through per-row block tables), each for fixed-lane
words (``packed_flash_decode``, ``paged_flash_decode``) and dense bit
planes (the ``_dense`` variants), at full width or in the
``prefix_planes`` draft read mode of self-speculation. One kernel,
``csrc/packed_flash_decode.cu``, serves all of them: split-KV over
(split, KV head, batch row), each split a run of slots within one KV
tile, whose K and V sub-tiles are staged by asynchronous 16-byte copies
and decoded in registers (dense planes by a SWAR bit transpose), then a
merge of the splits in split order. The least time it could take on the
H100 is set by memory, (D * P' / 8 + D / 128) bytes per live slot for K
and again for V (P' = the bits read: the payload width, or the draft's
prefix for dense planes).

``split_plan`` is the launch's split arithmetic and ``split_decode_plain``
its recurrence in plain PyTorch (each split from scratch, merged in split
order); the CPU tests hold both to the plain decode.

The shard view (``packed_flash_decode_shard``, words or planes) is the
same kernel over one rank's sequence shard of a cache whose sequence is
split over a mesh's ``model`` dim: slots [slot0, slot0 + L) of an
L_global-slot cache, masked by their global slot, the splits counted from
the shard's first slot (``shard_split_l``, the last one partial where it
does not divide the shard) and the merge's normalized f32 output with its
log-sum-exp in place of the bf16 output, for ``sharding.lse_combine``.

Each wrapper counts its launches: ``.launches`` at full width,
``.draft_launches`` in the draft mode.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import containers
from repro_torch.kernels import _lib
from repro_torch.kernels import ref
from repro_torch.kernels.ref import GROUP, NEG_INF, PackFields

DEFAULT_BLOCK_L = 128
SPLIT_L = 64    # slots a split at most
SUB_TILE = 32   # slots a staged sub-tile (one per lane)
MAX_REP = 16    # query heads a KV head (the kernel's kMaxRep)


def block_len(L: int, block_l: int = DEFAULT_BLOCK_L) -> int:
    """The KV tile: ``block_l`` shrunk to a divisor of L (the cache is
    never padded; padding would copy it every step)."""
    bl = min(block_l, L)
    while L % bl:
        bl -= 1
    return bl


class SplitPlan(NamedTuple):
    block_l: int   # slots a KV tile
    split_l: int   # slots a split, a divisor of the tile
    splits: int    # splits a row, L / split_l
    ctas: int      # CTAs of the split kernel, B * KH * splits
    threads: int   # threads a CTA: 32 a chunk of ``ref.head_chunks``


def split_plan(B: int, KH: int, hd: int, L: int,
               block_l: int = DEFAULT_BLOCK_L, *, paged: bool = False
               ) -> SplitPlan:
    """The split-KV grid of one launch. Split s is slots [s * split_l,
    (s + 1) * split_l) of every row, split_l the largest divisor of the
    tile up to ``SPLIT_L``: a function of the slot index and the tile
    alone, so a row's result does not depend on B or the card. A paged
    pool's tile is its block; a contiguous cache's is ``block_len``."""
    bl = block_l if paged else block_len(L, block_l)
    sl = min(SPLIT_L, bl)
    while bl % sl:
        sl -= 1
    return SplitPlan(bl, sl, L // sl, B * KH * (L // sl), 32 * -(-hd // 32))


def shard_split_l(L_global: int, block_l: int = DEFAULT_BLOCK_L) -> int:
    """The shard view's split: the one ``split_plan`` gives the whole
    L_global-slot cache, so a shard that is the whole cache (a world of
    one) reads the same splits as ``packed_flash_decode``."""
    return split_plan(1, 1, 32, L_global, block_l).split_l


def chunk_scores(qf: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, KH, rep, hd) f32 queries against (B, L, KH, hd) keys: each
    head's chunks of ``ref.head_chunks`` as partial dot products, added in
    chunk order (the kernel's score sum; its sums within a chunk run in
    another order). Returns (B, KH, rep, L)."""
    KH, hd = k.shape[2], k.shape[3]
    out = []
    for h in range(KH):
        total = None
        for ch in ref.head_chunks(h, hd):
            part = torch.einsum("bgd,bld->bgl", qf[:, h, :, ch.lo:ch.hi],
                                k[:, :, h, ch.lo:ch.hi])
            total = part if total is None else total + part
        out.append(total)
    return torch.stack(out, 1)


def split_decode_plain(q, k_payload, k_bases, v_payload, v_bases, pos,
                       fields: PackFields, *, window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       block_l: int = DEFAULT_BLOCK_L,
                       prefix_planes: Optional[int] = None,
                       tables: Optional[torch.Tensor] = None,
                       slot0: Optional[int] = None,
                       L_global: Optional[int] = None):
    """The kernel's split recurrence in plain PyTorch: per split of
    ``split_plan``, the scores as the sum of their ``ref.head_chunks`` partial
    products (``chunk_scores``), the softmax over its 32-slot sub-tiles
    that any slot may see, from scratch (m, l, acc); then the splits
    merged in split
    order with weights exp(m_s - max m), a split with no visible slot
    (or a weight that underflows to 0) adding nothing. With ``tables``
    the payloads are a pool, read as ``paged_flash_decode`` reads it.
    With ``slot0`` the cache is the shard view's slots [slot0, slot0 + L)
    of an ``L_global``-slot cache: splits of ``shard_split_l(L_global)``
    from the shard's first slot, the last one partial, and the result
    (o (B, H, hd), lse (B, H)) in f32 as ``packed_flash_decode_shard``
    gives it. For the tests only."""
    if tables is not None:
        block_l = k_payload.shape[1]
        k_payload, k_bases, v_payload, v_bases = (
            ref.paged_gather(t, tables)
            for t in (k_payload, k_bases, v_payload, v_bases))
        window = None
    B, _, H, hd = q.shape
    L, G = k_bases.shape[1], k_bases.shape[2]
    KH = G * GROUP // hd
    rep = H // KH
    plan = split_plan(B, KH, hd, L, block_l, paged=tables is not None)
    n, spec = plan.split_l, containers.spec_for(q.dtype)
    splits = plan.splits
    shard = slot0 is not None
    if shard:
        n = shard_split_l(L_global, block_l)
        splits = -(-L // n)
    else:
        slot0, L_global = 0, L

    def unp(payload, bases):
        return ref.unpack_tile(
            payload.reshape(B * L, -1), bases.reshape(B * L, G), fields,
            spec, rows=B * L, KH=KH, hd=hd,
            prefix_planes=prefix_planes).reshape(B, L, KH, hd)

    k, v = unp(k_payload, k_bases), unp(v_payload, v_bases)
    qf = q.reshape(B, KH, rep, hd).to(torch.float32)
    pos = torch.as_tensor(pos, dtype=torch.int64).reshape(-1).expand(B)
    slots = torch.arange(L)
    valid = ref.decode_kv_mask(pos[:, None], L_global, window,
                               slots=slot0 + slots[None])
    sub = torch.div(slots, SUB_TILE, rounding_mode="floor")
    scale = 1.0 / (hd ** 0.5)
    parts = []
    for s in range(splits):
        sl = slice(s * n, min((s + 1) * n, L))
        vs, ss = valid[:, sl], sub[sl] - sub[s * n]
        n_sub = int(ss[-1]) + 1
        vis = torch.stack([vs[:, ss == j].any(1) for j in range(n_sub)], 1)
        seen = vis[:, ss][:, None, None, :]          # (B, 1, 1, n)
        sc = chunk_scores(qf, k[:, sl]) * scale
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        sc = torch.where(vs[:, None, None, :], sc, NEG_INF)
        m = torch.where(seen, sc, -torch.inf).amax(-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, NEG_INF)
        p = torch.where(seen, torch.exp(sc - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bhgl,blhd->bhgd", p, v[:, sl])))
    M = torch.full_like(parts[0][0], NEG_INF)
    for m, l, _ in parts:
        M = torch.where(l > 0, torch.maximum(M, m), M)
    l_sum = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = torch.where(l > 0, torch.exp(m - M), 0.0)
        l_sum = l_sum + w * l
        acc = acc + torch.where(w != 0, w * a, 0.0)
    o = acc / torch.clamp(l_sum, min=1e-30)
    if shard:
        lse = torch.where(l_sum > 0, M + torch.log(l_sum), -torch.inf)
        return o.reshape(B, H, hd), lse.reshape(B, H)
    return o.reshape(B, 1, H, hd).to(q.dtype)


def plain(q, k_payload, k_bases, v_payload, v_bases, pos,
          fields: PackFields, *, window: Optional[int] = None,
          softcap: Optional[float] = None,
          block_l: int = DEFAULT_BLOCK_L,
          prefix_planes: Optional[int] = None) -> torch.Tensor:
    return ref.packed_flash_decode(q, k_payload, k_bases, v_payload, v_bases,
                                   pos, fields, window=window,
                                   softcap=softcap, block_l=block_l,
                                   prefix_planes=prefix_planes)


def plain_paged(q, k_payload, k_bases, v_payload, v_bases, tables, pos,
                fields: PackFields, *, softcap: Optional[float] = None,
                prefix_planes: Optional[int] = None) -> torch.Tensor:
    return ref.paged_flash_decode(q, k_payload, k_bases, v_payload, v_bases,
                                  tables, pos, fields, softcap=softcap,
                                  prefix_planes=prefix_planes)


def draft_planes(fields: PackFields, prefix_planes: Optional[int]
                 ) -> Optional[int]:
    """``prefix_planes`` checked against ``fields`` (ValueError outside
    ``ref.prefix_fields``' range); None for a full-width read."""
    if prefix_planes is None:
        return None
    ref.prefix_fields(fields, prefix_planes)
    return None if prefix_planes == fields.payload_bits else int(prefix_planes)


def _check_kind(name: str, fields: PackFields, dense: bool) -> None:
    if dense and (not fields.dense or not 3 <= fields.payload_bits <= 16):
        raise ValueError(f"{name}: dense bit planes only, got {fields}")
    if not dense and (fields.dense or fields.payload_bits not in (8, 16)):
        raise ValueError(f"{name}: fixed-lane words only, got {fields}")


def _check(name: str, part: str, t: torch.Tensor, dt, shape, device):
    if (t.device != device or t.dtype != dt or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {part} must be a contiguous {dt} "
                         f"{shape} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


_TICKETS: dict = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """int32 zeros, one per (row, KV head), on which the split kernel's
    CTAs take their tickets; every launch leaves them zero, so one buffer
    serves each (device, stream)."""
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[(device, stream)] = torch.zeros(
            n, dtype=torch.int32, device=device)
    return t


def _launch(name: str, q: torch.Tensor, k_payload: torch.Tensor,
            k_bases: torch.Tensor, v_payload: torch.Tensor,
            v_bases: torch.Tensor, pos: torch.Tensor, fields: PackFields,
            window: Optional[int], softcap: Optional[float], block_l: int,
            prefix: Optional[int],
            tables: Optional[torch.Tensor] = None,
            shard: Optional[tuple] = None):
    """Launch over a contiguous cache (payload (B, L, cols)) or, with
    ``tables`` (B, nb), over a pool (payload (P_blocks, block_l, cols)).
    ``shard`` (slot0, L_global, split_l) is the shard view over a
    contiguous cache: returns (o, lse) in f32."""
    lib = _lib.load()
    B, one, H, hd = q.shape
    G = k_bases.shape[2]
    D = G * GROUP
    KH = D // hd
    if one != 1 or KH * hd != D or H % KH:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit a cache "
                         f"of {G} groups")
    if not q.is_cuda or q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous bf16 on a CUDA "
                         f"device")
    if shard is not None:
        lead = (B, k_bases.shape[1])
        L, bl = lead[1], block_l
    elif tables is None:
        lead = (B, k_bases.shape[1])
        L, bl = lead[1], block_len(lead[1], block_l)
    else:
        lead = tuple(k_bases.shape[:2])
        bl = lead[1]
        _check(name, "tables", tables, torch.int32, (B, tables.shape[1]),
               q.device)
        L = tables.shape[1] * bl
    cols = fields.nd_payload_cols(D)
    for part, t, dt, shape in (
            ("k_payload", k_payload, fields.payload_dtype, (*lead, cols)),
            ("v_payload", v_payload, fields.payload_dtype, (*lead, cols)),
            ("k_bases", k_bases, torch.uint8, (*lead, G)),
            ("v_bases", v_bases, torch.uint8, (*lead, G)),
            ("pos", pos, torch.int32, (B,))):
        _check(name, part, t, dt, shape, q.device)
    if hd % 16 or hd > 512 or H // KH > MAX_REP:
        raise ValueError(f"{name}: hd={hd}, rep={H // KH} not supported "
                         f"(hd % 16 == 0, hd <= 512, rep <= {MAX_REP})")
    plan = split_plan(B, KH, hd, L, bl, paged=True)   # bl is the tile
    slot0, L_global, split_l = 0, L, plan.split_l
    if shard is not None:
        slot0, L_global, split_l = shard
    splits = -(-L // split_l)
    # 16-byte copies: every payload row starts 16-byte aligned (whole
    # 128-lane groups), and so does every head's run of words (hd % 16 ==
    # 0; planes are staged by whole groups), when each tensor does.
    for part, t in (("k_payload", k_payload), ("k_bases", k_bases),
                    ("v_payload", v_payload), ("v_bases", v_bases)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {part} is not 16-byte aligned")
    scratch = torch.empty(splits * B * (H // KH) * KH * (hd + 2),
                          dtype=torch.float32, device=q.device)
    lse = None
    if shard is None:
        out = torch.empty_like(q)
    else:
        out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
        lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    stream = _lib.stream_ptr(q)
    tickets = _tickets(q.device, stream, B * KH)
    err = lib.packed_flash_decode_launch(
        q.data_ptr(), k_payload.data_ptr(), k_bases.data_ptr(),
        v_payload.data_ptr(), v_bases.data_ptr(), pos.data_ptr(),
        None if tables is None else tables.data_ptr(), scratch.data_ptr(),
        tickets.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, L, H, KH, hd, G, bl, split_l,
        -1 if window is None else int(window),
        fields.man_keep, fields.dexp_bits, fields.payload_bits,
        int(fields.dense), -1 if prefix is None else prefix,
        slot0, L_global,
        0.0 if softcap is None else float(softcap), 1.0 / (hd ** 0.5),
        stream)
    _lib.check(err, name)
    return out if lse is None else (out, lse)


def _count(fn, prefix: Optional[int]) -> None:
    if prefix is None:
        fn.launches += 1
    else:
        fn.draft_launches += 1


def _contiguous(fn, dense: bool, q, k_payload, k_bases, v_payload, v_bases,
                pos, fields, window, softcap, block_l, prefix_planes):
    if q.device.type == "cpu":
        return plain(q, k_payload, k_bases, v_payload, v_bases, pos, fields,
                     window=window, softcap=softcap, block_l=block_l,
                     prefix_planes=prefix_planes)
    _check_kind(fn.__name__, fields, dense)
    prefix = draft_planes(fields, prefix_planes)
    out = _launch(fn.__name__, q, k_payload, k_bases, v_payload, v_bases,
                  pos, fields, window, softcap, block_l, prefix)
    _count(fn, prefix)
    return out


def _paged(fn, dense: bool, q, k_payload, k_bases, v_payload, v_bases,
           tables, pos, fields, softcap, prefix_planes):
    if q.device.type == "cpu":
        return plain_paged(q, k_payload, k_bases, v_payload, v_bases, tables,
                           pos, fields, softcap=softcap,
                           prefix_planes=prefix_planes)
    _check_kind(fn.__name__, fields, dense)
    prefix = draft_planes(fields, prefix_planes)
    out = _launch(fn.__name__, q, k_payload, k_bases, v_payload, v_bases,
                  pos, fields, None, softcap, k_payload.shape[1], prefix,
                  tables=tables)
    _count(fn, prefix)
    return out


def packed_flash_decode(q: torch.Tensor, k_payload: torch.Tensor,
                        k_bases: torch.Tensor, v_payload: torch.Tensor,
                        v_bases: torch.Tensor, pos: torch.Tensor,
                        fields: PackFields, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        block_l: int = DEFAULT_BLOCK_L,
                        prefix_planes: Optional[int] = None
                        ) -> torch.Tensor:
    """One-token attention over fixed-lane words: q (B, 1, H, hd), payload
    (B, L, KH*hd) words, bases (B, L, KH*hd // 128) uint8, ``pos`` (B,)
    int32 decode positions; ``window`` not None means an L-slot ring
    buffer; ``prefix_planes`` reads only the leading bits of each word.
    Returns (B, 1, H, hd). A CPU tensor takes the plain version; any other
    tensor launches the kernel or raises."""
    return _contiguous(packed_flash_decode, False, q, k_payload, k_bases,
                       v_payload, v_bases, pos, fields, window, softcap,
                       block_l, prefix_planes)


def packed_flash_decode_dense(q: torch.Tensor, k_payload: torch.Tensor,
                              k_bases: torch.Tensor, v_payload: torch.Tensor,
                              v_bases: torch.Tensor, pos: torch.Tensor,
                              fields: PackFields, *,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              block_l: int = DEFAULT_BLOCK_L,
                              prefix_planes: Optional[int] = None
                              ) -> torch.Tensor:
    """As ``packed_flash_decode``, over a dense bit-plane cache: payload
    (B, L, G * P * 16) uint8, each slot's bytes ordered (group, plane,
    16)."""
    return _contiguous(packed_flash_decode_dense, True, q, k_payload,
                       k_bases, v_payload, v_bases, pos, fields, window,
                       softcap, block_l, prefix_planes)


def paged_flash_decode(q: torch.Tensor, k_payload: torch.Tensor,
                       k_bases: torch.Tensor, v_payload: torch.Tensor,
                       v_bases: torch.Tensor, tables: torch.Tensor,
                       pos: torch.Tensor, fields: PackFields, *,
                       softcap: Optional[float] = None,
                       prefix_planes: Optional[int] = None) -> torch.Tensor:
    """One-token global attention over a paged pool of fixed-lane words:
    payload (P_blocks, block_l, KH*hd), bases (P_blocks, block_l, G),
    ``tables`` (B, nb) int32 physical block per logical block (unused
    entries name the trash block 0), ``pos`` (B,) int32. The block table is
    read inside the kernel; no per-row cache is gathered."""
    return _paged(paged_flash_decode, False, q, k_payload, k_bases,
                  v_payload, v_bases, tables, pos, fields, softcap,
                  prefix_planes)


def paged_flash_decode_dense(q: torch.Tensor, k_payload: torch.Tensor,
                             k_bases: torch.Tensor, v_payload: torch.Tensor,
                             v_bases: torch.Tensor, tables: torch.Tensor,
                             pos: torch.Tensor, fields: PackFields, *,
                             softcap: Optional[float] = None,
                             prefix_planes: Optional[int] = None
                             ) -> torch.Tensor:
    """As ``paged_flash_decode``, over a pool of dense bit planes."""
    return _paged(paged_flash_decode_dense, True, q, k_payload, k_bases,
                  v_payload, v_bases, tables, pos, fields, softcap,
                  prefix_planes)


def packed_flash_decode_shard(q: torch.Tensor, k_payload: torch.Tensor,
                              k_bases: torch.Tensor, v_payload: torch.Tensor,
                              v_bases: torch.Tensor, pos: torch.Tensor,
                              fields: PackFields, *, slot0: int,
                              L_global: int, window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              prefix_planes: Optional[int] = None):
    """The shard view: one-token attention over a rank's sequence shard,
    slots [slot0, slot0 + L) of an ``L_global``-slot cache (a ring of
    L_global slots under ``window``), fixed-lane words or dense planes
    (``fields.dense``): payload (B, L, nd_payload_cols(KH*hd)), bases (B,
    L, G), ``pos`` (B,) int32 global positions. Splits of
    ``shard_split_l(L_global)`` slots from the shard's first slot, the
    last one partial. Returns (o (B, H, hd), lse (B, H)) in
    f32: the softmax over the shard's visible slots, normalized, and the
    log-sum-exp of their scores (-inf where none is visible). A CPU
    tensor takes the plain version; any other launches the kernel or
    raises."""
    L = k_bases.shape[1]
    if not (0 <= slot0 and slot0 + L <= L_global):
        raise ValueError(f"packed_flash_decode_shard: slots [{slot0}, "
                         f"{slot0 + L}) outside a {L_global}-slot cache")
    if q.device.type == "cpu":
        return ref.packed_flash_decode_shard(
            q, k_payload, k_bases, v_payload, v_bases, pos, fields,
            slot0=slot0, L_global=L_global, window=window, softcap=softcap,
            block_l=DEFAULT_BLOCK_L, prefix_planes=prefix_planes)
    fn = packed_flash_decode_shard
    _check_kind(fn.__name__, fields, fields.dense)
    prefix = draft_planes(fields, prefix_planes)
    sl = shard_split_l(L_global)
    bl = -(-DEFAULT_BLOCK_L // sl) * sl    # a tile the split divides
    out = _launch(fn.__name__, q, k_payload, k_bases, v_payload, v_bases,
                  pos, fields, window, softcap, bl, prefix,
                  shard=(int(slot0), int(L_global), sl))
    _count(fn, prefix)
    return out


for _fn in (packed_flash_decode, packed_flash_decode_dense,
            paged_flash_decode, paged_flash_decode_dense,
            packed_flash_decode_shard):
    _fn.launches = 0
    _fn.draft_launches = 0
del _fn
