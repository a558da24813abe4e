"""Codec-compressed contiguous KV cache (default: the paper's sfp8).

Decode is bound by the KV cache read; the cache stores the packed
representation of a registry codec and each decode step packs only the
new token's K/V row. For the SFP containers attention reads the packed
(payload, bases) pair straight through ``ops.packed_flash_decode``: the
bf16 cache never exists in device memory. Codecs without a fixed-width
payload geometry (``bit_exact``, ``gecko8``) take the fallback of the JAX
package: unpack the whole cache, then attend over it with
``attention.decode_attend``. The paged pool of the JAX package is not
ported yet.

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
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import codecs
from repro_torch.configs.base import ArchConfig, LOCAL
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


def packed_cache_init(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                      container: Optional[str] = None, *,
                      device) -> PackedKV:
    """An all-zero packed cache: each part (B, L, ...) with the per-slot
    shape and dtype of a packed row (found by packing one zero row on the
    CPU, the plain path; no kernel is launched). SFP: payload
    (B, L, nd_payload_cols(D)) words or bit-plane bytes and bases
    (B, L, D // 128); bit_exact: (B, L, D) values; gecko8: signman
    (B, L, D) and (B, L, D // 64, .) bases, widths and planes."""
    codec = _codec(container)
    D = cfg.n_kv_heads * cfg.head_dim_
    if D % GROUP:
        raise ValueError(f"KV feature dim {D} must align to {GROUP} lanes")
    L = cache_len(cfg, kind, max_len)
    row = _seq_major(codec.pack(torch.zeros((1, 1, D),
                                            dtype=cfg.compute_dtype)))

    def part():
        return codecs.PackedTensor(codec.name, (batch, L, D),
                                   cfg.compute_dtype, {
            k: torch.zeros((batch, L, *v.shape[2:]), dtype=v.dtype,
                           device=device) for k, v in row.data.items()})
    return PackedKV(k=part(), v=part())


def _splice(cache_pt: codecs.PackedTensor, new_pt: codecs.PackedTensor,
            slot: torch.Tensor) -> None:
    """Write one packed token row per batch row at ``slot`` (B,), in
    place (the JAX package donates the cache and updates it in place)."""
    new_pt = _seq_major(new_pt)
    rows = torch.arange(slot.shape[0], device=slot.device)
    for k in cache_pt.data:
        cache_pt.data[k][rows, slot] = new_pt.data[k][:, 0]


def attention_decode_packed(params, h_tok: torch.Tensor, cache: PackedKV,
                            pos: torch.Tensor, cfg: ArchConfig, *, kind: str,
                            container: Optional[str] = None
                            ) -> Tuple[torch.Tensor, PackedKV]:
    """One-token decode over the compressed cache, spliced in place.
    h_tok (B, 1, d); pos (B,) int64 decode positions."""
    codec = _codec(container)
    B = h_tok.shape[0]
    hd, H, KH = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    D = KH * hd
    L = cache.k.shape[1]
    dtype = h_tok.dtype
    q, k_new, v_new = attention._project_qkv(params, h_tok, cfg,
                                             pos[:, None])
    slot = attention.decode_slot_index(pos, L, kind)
    _splice(cache.k, codec.pack(k_new.reshape(B, 1, D).to(dtype)), slot)
    _splice(cache.v, codec.pack(v_new.reshape(B, 1, D).to(dtype)), slot)
    fields = codec.pack_fields(dtype)
    if fields is None:
        # No fused kernel for this codec: unpack the whole cache, attend.
        k_c = codec.unpack(_flat(cache.k)).reshape(B, L, KH, hd)
        v_c = codec.unpack(_flat(cache.v)).reshape(B, L, KH, hd)
        o = attention.decode_attend(q, k_c, v_c, pos, cfg, kind)
    else:
        window = cfg.window if kind == LOCAL else None
        o = ops.packed_flash_decode(
            q.to(dtype),
            ops.Packed(cache.k.data["payload"], cache.k.data["bases"]),
            ops.Packed(cache.v.data["payload"], cache.v.data["bases"]),
            pos, fields=fields, window=window, softcap=cfg.attn_softcap)
    out = o.reshape(B, 1, H * hd) @ params["wo"]
    return out, cache


def pack_prefill_cache(cache_kv: attention.KVCache,
                       container: Optional[str] = None) -> PackedKV:
    """Compress a prefill-produced bf16 cache in one shot."""
    codec = _codec(container)
    B, L, KH, hd = cache_kv.k.shape
    return PackedKV(
        k=_seq_major(codec.pack(cache_kv.k.reshape(B, L, KH * hd))),
        v=_seq_major(codec.pack(cache_kv.v.reshape(B, L, KH * hd))))
