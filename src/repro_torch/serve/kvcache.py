"""Codec-compressed contiguous KV cache (default: the paper's sfp8).

Decode is bound by the KV cache read; the cache stores the packed
representation of a registry codec and each decode step packs only the
new token's K/V row. For the SFP containers attention reads the packed
(payload, bases) pair straight through ``ops.packed_flash_decode``: the
bf16 cache never exists in device memory. Codecs without a fixed-width
payload geometry (``bit_exact``, ``gecko8``) take the fallback of the JAX
package: unpack the whole cache, then attend over it with
``attention.decode_attend``. The paged pool of the continuous-batching
engine (``PagedKV``) keeps the packed rows of every request's global
layers in shared physical blocks, read through per-row block tables by
``ops.paged_flash_decode``; only the SFP containers page (``gecko8`` and
``bit_exact`` have no fixed-width geometry and raise).

Every part is stored with the batch on axis 0 and the sequence on axis 1,
so one splice along axis 1 writes a token row of any codec. gecko8's
exponent parts come out of ``pack`` flat over groups of 64 values
((G, 8) bases, (G, 7) widths, (G, 63) planes for the whole tensor). The
JAX package's cache keeps them flat and splices them as if the sequence
were on axis 1, which writes a new row's groups over other rows'; the
port does not copy that. Since D = KH * head_dim is a multiple
of 64, no group crosses a (batch, slot) row, so the flat parts of a
(B, L, D) tensor are exactly (B, L, D // 64, .) arrays, reshaped: the
cache stores those (the same bytes as JAX's flat pack) and flattens them
again before ``unpack``.

Under a mesh the cache is a rank's shard (``packed_cache_axes``: batch
rows over the batch axes, the sequence over ``model``): the prefill packs
the rank's slots of whole rows, a decode step writes the new row on the
rank whose shard holds its slot, and the packed SFP caches are read by
the decode kernel's shard view, whose partials ``sharding.lse_combine``
joins over ``model`` in f32 before one rounding to the cache dtype;
``gecko8`` and ``bit_exact`` unpack the rank's shard alone and attend as
``attention.decode_attend(group=)`` does, the JAX package's softmax
arithmetic across the ranks.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import codecs
from repro_torch.configs.base import ArchConfig, LOCAL
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import GECKO_GROUP, GROUP
from repro_torch.models import attention


class PackedKV(NamedTuple):
    k: codecs.PackedTensor  # parts shaped (B, L, ...), D = KH * head_dim
    v: codecs.PackedTensor


def cache_len(cfg: ArchConfig, kind: str, max_len: int) -> int:
    """Packed-cache sequence allocation for a budget ``max_len``: past one
    decode block, round up to a block multiple so the decode kernel always
    gets full tiles. Extra slots stay masked (global) or are ring slack
    (local; the modulus is the allocated length everywhere)."""
    L = min(max_len, cfg.window) if kind == LOCAL else max_len
    block = ops.DECODE_BLOCK_L
    if L > block:
        L = -(-L // block) * block
    return L


def _codec(container: Optional[str]) -> codecs.Codec:
    return codecs.get(container or codecs.DEFAULT_CONTAINER)


# Parts of a codec that are flat over the tensor's groups of 64 values.
_GROUPED = {codecs.GECKO8: ("bases", "widths", "planes")}


def seq_len(entry) -> int:
    """The slots of an attention layer's cache entry (``KVCache`` or
    ``PackedKV``): the whole cache's for DTensor leaves."""
    k = entry.k
    if isinstance(k, codecs.PackedTensor):
        k = next(iter(k.data.values()))
    return k.shape[1]


def _seq_major(pt: codecs.PackedTensor) -> codecs.PackedTensor:
    """``pt`` (of a (B, L, D) tensor) with every part (B, L, ...)."""
    B, L, D = pt.shape
    grouped = _GROUPED.get(pt.codec, ())
    data = {k: (v.reshape(B, L, D // GECKO_GROUP, v.shape[-1])
                if k in grouped else v) for k, v in pt.data.items()}
    return codecs.PackedTensor(pt.codec, pt.shape, pt.dtype, data)


def _flat(pt: codecs.PackedTensor) -> codecs.PackedTensor:
    """Inverse of ``_seq_major``: the parts as ``pack`` gives them."""
    grouped = _GROUPED.get(pt.codec, ())
    data = {k: (v.reshape(-1, v.shape[-1]) if k in grouped else v)
            for k, v in pt.data.items()}
    return codecs.PackedTensor(pt.codec, pt.shape, pt.dtype, data)


def _row(cfg: ArchConfig, container: Optional[str]) -> codecs.PackedTensor:
    """One packed zero row (1, 1, D) on the CPU, every part (1, 1, ...):
    the per-slot shape and dtype of each part (the plain path; no kernel
    is launched)."""
    D = cfg.n_kv_heads * cfg.head_dim_
    if D % GROUP:
        raise ValueError(f"KV feature dim {D} must align to {GROUP} lanes")
    return _seq_major(_codec(container).pack(
        torch.zeros((1, 1, D), dtype=cfg.compute_dtype)))


def packed_cache_axes(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                      container: Optional[str] = None) -> PackedKV:
    """Logical sharding axes of ``packed_cache_init``'s parts, each
    (batch, seq, ...): ("batch", "cache_seq", None, ...). The JAX
    package's ``packed_cache_axes`` gives every part these axes over its
    own layout; the port's gecko8 parts are (B, L, D / 64, .) where JAX's
    are flat (the module's note), so they carry two trailing Nones."""
    row = _row(cfg, container)
    part = codecs.PackedTensor(row.codec, (batch, cache_len(cfg, kind,
                                                            max_len),
                                           row.shape[2]), row.dtype, {
        k: ("batch", "cache_seq") + (None,) * (v.dim() - 2)
        for k, v in row.data.items()})
    return PackedKV(k=part, v=part)


def packed_cache_init(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                      container: Optional[str] = None, *,
                      device) -> PackedKV:
    """An all-zero packed cache: each part (B, L, ...) with the per-slot
    shape and dtype of a packed row (found by packing one zero row on the
    CPU, the plain path; no kernel is launched). SFP: payload
    (B, L, nd_payload_cols(D)) words or bit-plane bytes and bases
    (B, L, D // 128); bit_exact: (B, L, D) values; gecko8: signman
    (B, L, D) and (B, L, D // 64, .) bases, widths and planes."""
    L = cache_len(cfg, kind, max_len)
    row = _row(cfg, container)

    def part():
        return codecs.PackedTensor(row.codec, (batch, L, row.shape[2]),
                                   cfg.compute_dtype, {
            k: torch.zeros((batch, L, *v.shape[2:]), dtype=v.dtype,
                           device=device) for k, v in row.data.items()})
    return PackedKV(k=part(), v=part())


def _splice(cache_pt: codecs.PackedTensor, new_pt: codecs.PackedTensor,
            slot: torch.Tensor, slot0: int = 0,
            L_global: Optional[int] = None) -> None:
    """Write one packed token row per batch row at ``slot`` (B,), in
    place (the JAX package donates the cache and updates it in place);
    a shard of slots [slot0, slot0 + L) of an ``L_global``-slot cache
    takes only the rows whose slot it holds
    (``attention.splice_rows``)."""
    new_pt = _seq_major(new_pt)
    for k in cache_pt.data:
        attention.splice_rows(cache_pt.data[k], new_pt.data[k][:, 0], slot,
                              slot0, L_global)


def attention_decode_packed(params, h_tok: torch.Tensor, cache: PackedKV,
                            pos: torch.Tensor, cfg: ArchConfig, *, kind: str,
                            container: Optional[str] = None,
                            prefix_planes: Optional[int] = None,
                            shard: Optional[attention.DecodeShard] = None
                            ) -> Tuple[torch.Tensor, PackedKV]:
    """One-token decode over the compressed cache, spliced in place.
    h_tok (B, 1, d); pos (B,) int64 decode positions. ``prefix_planes``
    (a speculative draft step) reads only the leading P' payload bits;
    the write stays full width. Under a mesh (``shard``) the cache is the
    rank's shard (the module's note)."""
    codec = _codec(container)
    B = h_tok.shape[0]
    hd, H, KH = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    D = KH * hd
    L = cache.k.shape[1]
    dtype = h_tok.dtype
    q, k_new, v_new = attention._project_qkv(params, h_tok, cfg,
                                             pos[:, None])
    q, k_new, v_new = attention.replicate_qkv(q, k_new, v_new, shard)
    slot0, L_global, group = attention.cache_span(shard, L)
    slot = attention.decode_slot_index(pos, L_global, kind)
    for part, new in ((cache.k, k_new), (cache.v, v_new)):
        _splice(part, codec.pack(new.reshape(B, 1, D).to(dtype)), slot,
                slot0, L_global)
    fields = codec.pack_fields(dtype)
    if prefix_planes is not None and fields is None:
        raise ValueError(f"prefix_planes needs a fixed-width payload "
                         f"geometry; codec {codec.name!r} has none")
    if fields is None:
        # No fused kernel for this codec: unpack the (rank's) cache, attend.
        k_c = codec.unpack(_flat(cache.k)).reshape(B, L, KH, hd)
        v_c = codec.unpack(_flat(cache.v)).reshape(B, L, KH, hd)
        o = attention.decode_attend(q, k_c, v_c, pos, cfg, kind,
                                    slot0=slot0, L_global=L_global,
                                    group=group)
        return attention.out_proj(o, params, shard), cache
    packed = [ops.Packed(c.data["payload"], c.data["bases"])
              for c in (cache.k, cache.v)]
    kw = dict(fields=fields, window=cfg.window if kind == LOCAL else None,
              softcap=cfg.attn_softcap, prefix_planes=prefix_planes)
    if shard is None:
        o = ops.packed_flash_decode(q.to(dtype), *packed, pos, **kw)
    else:
        o, lse = ops.packed_flash_decode_shard(
            q.to(dtype), *packed, pos, slot0=slot0, L_global=L_global, **kw)
        o = shd.lse_combine(o, lse, group).to(dtype).reshape(B, 1, H, hd)
    return attention.out_proj(o, params, shard), cache


def pack_prefill_cache(cache_kv: attention.KVCache,
                       container: Optional[str] = None) -> PackedKV:
    """Compress a prefill-produced bf16 cache in one shot."""
    codec = _codec(container)
    B, L, KH, hd = cache_kv.k.shape
    if (KH * hd) % GROUP:
        raise ValueError(f"KV feature dim {KH * hd} must align to {GROUP} "
                         f"lanes")
    return PackedKV(
        k=_seq_major(codec.pack(cache_kv.k.reshape(B, L, KH * hd))),
        v=_seq_major(codec.pack(cache_kv.v.reshape(B, L, KH * hd))))


# ---------------------------------------------------------------------------
# Paged pool (continuous-batching serving engine)
# ---------------------------------------------------------------------------


class PagedKV(NamedTuple):
    """One global-attention layer's slice of the packed block pool:
    payload (P_blocks, block_l, fields.nd_payload_cols(D)) words or bit
    planes and bases (P_blocks, block_l, D // 128) uint8, shared by every
    request. Which blocks belong to which request lives in the engine's
    block tables."""

    k_payload: torch.Tensor
    k_bases: torch.Tensor
    v_payload: torch.Tensor
    v_bases: torch.Tensor


def _paged_fields(cfg: ArchConfig, container: Optional[str]):
    codec = _codec(container)
    fields = codec.pack_fields(cfg.compute_dtype)
    if fields is None:
        raise ValueError(
            f"paged KV pools need a fixed-width payload geometry; codec "
            f"{codec.name!r} has none (pack_fields() is None)")
    return fields


def paged_block_bytes(cfg: ArchConfig, block_l: int,
                      container: Optional[str] = None) -> int:
    """Packed bytes of one physical block of one layer: K and V payload
    plus the group bases (the unit of the pool's admission accounting)."""
    fields = _paged_fields(cfg, container)
    D = cfg.n_kv_heads * cfg.head_dim_
    itemsize = torch.empty((), dtype=fields.payload_dtype).element_size()
    return 2 * block_l * (fields.nd_payload_cols(D) * itemsize + D // GROUP)


def paged_block_spec(cfg: ArchConfig, num_blocks: int, block_l: int,
                     container: Optional[str] = None) -> PagedKV:
    """(shape, dtype) of each part of one layer's pool slice."""
    D = cfg.n_kv_heads * cfg.head_dim_
    if D % GROUP:
        raise ValueError(f"KV feature dim {D} must align to {GROUP} lanes")
    fields = _paged_fields(cfg, container)
    payload = ((num_blocks, block_l, fields.nd_payload_cols(D)),
               fields.payload_dtype)
    bases = ((num_blocks, block_l, D // GROUP), torch.uint8)
    return PagedKV(k_payload=payload, k_bases=bases, v_payload=payload,
                   v_bases=bases)


def paged_block_init(cfg: ArchConfig, num_blocks: int, block_l: int,
                     container: Optional[str] = None, *, device) -> PagedKV:
    return PagedKV(*(torch.zeros(shape, dtype=dt, device=device)
                     for shape, dt in paged_block_spec(cfg, num_blocks,
                                                       block_l, container)))


_U32 = 0xFFFFFFFF
_KNUTH = 2654435761
_GOLDEN = 0x9E3779B9


def _weighted_sums(a: torch.Tensor, s: int, start: int) -> torch.Tensor:
    """(P, n) integers -> (P,) int64 sums of a[:, j] * w(start + j) mod
    2^32, w(j) = (j * 2654435761 + s) | 1 mod 2^32. Every product is
    reduced mod 2^32 before the sum, so int64 never overflows (n < 2^31)."""
    n = a.shape[1]
    j = torch.arange(start, start + n, dtype=torch.int64, device=a.device)
    w = ((j * _KNUTH + (s & _U32)) & _U32) | 1
    return ((a.to(torch.int64) * w) & _U32).sum(dim=1)


def paged_block_checksums(paged, salt: int = 0,
                          ids: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Per-physical-block integrity checksum over the packed parts: (P,)
    int64 holding the uint32 value. A position-weighted sum mod 2^32 with
    odd weights, so a single bit flip always changes its block's sum;
    ``salt`` decorrelates the four parts and the layer groups the engine
    sums. ``paged`` is one ``PagedKV`` (parts (P, block_l, cols), or with
    a leading layer axis), or a sequence of them, one per layer: the layers
    then count as one flat sequence per block, as the JAX package's
    stacked periods do. ``ids`` selects physical blocks (all when None).
    Bit-equal to the JAX package's uint32 sums (torch has no full uint32
    arithmetic: int64, masked)."""
    if isinstance(paged, PagedKV):
        layers = ([paged] if paged.k_payload.dim() == 3 else
                  [PagedKV(*(a[k] for a in paged))
                   for k in range(paged.k_payload.shape[0])])
    else:
        layers = list(paged)
    total = None
    for i in range(len(PagedKV._fields)):
        s = salt + _GOLDEN * (i + 1)
        for k, kv in enumerate(layers):
            a = kv[i] if ids is None else kv[i].index_select(0, ids)
            part = _weighted_sums(a.reshape(a.shape[0], -1), s,
                                  k * a[0].numel())
            total = part if total is None else total + part
    return total & _U32


def attention_decode_paged(params, h_tok: torch.Tensor, paged: PagedKV,
                           tables: torch.Tensor, pos: torch.Tensor,
                           cfg: ArchConfig, *,
                           container: Optional[str] = None,
                           prefix_planes: Optional[int] = None
                           ) -> Tuple[torch.Tensor, PagedKV]:
    """One continuous-batching decode step over the paged pool, written in
    place. ``tables`` (B, nb) int32 maps each row's logical blocks to
    physical ones; ``pos`` (B,) is each row's position. The new token's
    K/V row is packed and written into the row's current block (idle rows
    point at the trash block 0, where several may land on one row: garbage
    that no valid position reads), then attention reads the pool through
    the tables. Global attention only. ``prefix_planes`` (draft steps)
    narrows the read; the write stays full width."""
    codec = _codec(container)
    B = h_tok.shape[0]
    hd, H, KH = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    D = KH * hd
    block_l = paged.k_payload.shape[1]
    dtype = h_tok.dtype
    fields = _paged_fields(cfg, container)
    q, k_new, v_new = attention._project_qkv(params, h_tok, cfg,
                                             pos[:, None])
    k_pt = codec.pack(k_new.reshape(B, 1, D).to(dtype))
    v_pt = codec.pack(v_new.reshape(B, 1, D).to(dtype))
    rows = torch.arange(B, device=pos.device)
    phys = tables[rows, pos // block_l].long()
    off = pos % block_l
    for part, pt, key in ((paged.k_payload, k_pt, "payload"),
                          (paged.k_bases, k_pt, "bases"),
                          (paged.v_payload, v_pt, "payload"),
                          (paged.v_bases, v_pt, "bases")):
        part[phys, off] = pt.data[key][:, 0]
    o = ops.paged_flash_decode(
        q.to(dtype), ops.Packed(paged.k_payload, paged.k_bases),
        ops.Packed(paged.v_payload, paged.v_bases), tables, pos,
        fields=fields, softcap=cfg.attn_softcap,
        prefix_planes=prefix_planes)
    out = o.reshape(B, 1, H * hd) @ params["wo"]
    return out, paged
