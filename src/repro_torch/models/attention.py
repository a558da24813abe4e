"""GQA attention blocks: global / sliding-window, prefill + decode paths.

Prefill sends every prompt length through ``ops.attention`` (the flash
kernel on the card): the kernel computes the same function as the JAX
package's chunked route for long prompts, without the S x S tensor.
Decode positions are (B,) tensors throughout, one per batch row.

Under tensor parallelism (``attention_train(tp=)``) a rank computes its
``n_heads / tp`` query heads from its columns of ``wq``, and its group's KV
heads: its own columns of ``wk`` / ``wv`` where tp splits ``n_kv_heads``,
else every KV head from the whole weights (the JAX package's
``_qkv_specs`` replicates them), of which it reads its group's. ``wo``'s
partial product is summed over the TP group. Where the query heads do not
split over tp, or the KV heads neither split nor divide it, every rank
computes every head from the whole weights, as JAX replicates them
(``kv_local``; the model then calls this without ``tp``).

Serving under a mesh (``DecodeShard``) splits the KV cache's sequence over
``model`` (flash-decoding style), as the JAX package's cache axes and its
hints do (``src/repro/models/attention.py:321-328``). Prefill computes each
rank's heads as training does, then ``cache_shard`` turns them into the
rank's sequence shard of every head (an all-to-all over ``model`` where a
rank computed only its own KV heads, a slice where it computed all of
them), before any pack: a rank packs whole rows. A decode step gathers q
and the new K/V row over ``model`` (``replicate_qkv``), so every rank
holds every head of the token; the rank whose shard holds the new slot
writes it; each rank attends over its own slots, masked at their global
slots; the ranks' partials are combined (``decode_attend(group=)`` for a
raw or unpacked cache, ``sharding.lse_combine`` after the packed caches'
shard view); and ``wo`` runs row-parallel on the rank's own heads
(``out_proj``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, LOCAL
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.models import common

NEG_INF = -1e30

PARAM_AXES = {"wq": ("embed", "heads"), "wk": ("embed", "heads"),
              "wv": ("embed", "heads"), "wo": ("heads", "embed"),
              "q_norm": {"scale": ("norm",)}, "k_norm": {"scale": ("norm",)}}


# How a TP rank computes the heads (``kv_local``).
KV_OWN, KV_DIVIDE, REPLICATED = "own", "divide", "replicated"


def kv_local(cfg: ArchConfig, tp: int) -> str:
    """How a rank of TP degree ``tp`` computes the attention heads:
    ``KV_OWN``, its query heads and its own KV heads (tp splits both);
    ``KV_DIVIDE``, its query heads and every KV head, of which it reads
    the one its query heads share (the KV heads divide tp); ``REPLICATED``,
    every head from the whole weights, where the query heads do not split
    over tp or the KV heads neither split nor divide it (JAX's
    ``_qkv_specs`` replicates them)."""
    H, KH = cfg.n_heads, cfg.n_kv_heads
    if H % tp or (KH % tp and tp % KH):
        return REPLICATED
    return KV_OWN if KH % tp == 0 else KV_DIVIDE


def attn_init(cfg: ArchConfig, gen, device, dtype):
    d, hd = cfg.d_model, cfg.head_dim_
    H, KH = cfg.n_heads, cfg.n_kv_heads
    params = {
        "wq": common.normal_init((d, H * hd), gen, device, dtype),
        "wk": common.normal_init((d, KH * hd), gen, device, dtype),
        "wv": common.normal_init((d, KH * hd), gen, device, dtype),
        "wo": common.normal_init((H * hd, d), gen, device, dtype),
    }
    if cfg.qk_norm:
        params["q_norm"] = common.rmsnorm_init(hd, device, dtype)
        params["k_norm"] = common.rmsnorm_init(hd, device, dtype)
    return params


def _project_qkv(params, h: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor):
    """q (B, S, H, hd), k and v (B, S, KH, hd); the head counts are those
    of the weights given (a TP rank's columns)."""
    B, S, _ = h.shape
    hd = cfg.head_dim_
    q = (h @ params["wq"]).reshape(B, S, -1, hd)
    k = (h @ params["wk"]).reshape(B, S, -1, hd)
    v = (h @ params["wv"]).reshape(B, S, -1, hd)
    if cfg.qk_norm:  # Gemma-style RMSNorms over the head dim, before RoPE
        q = common.rmsnorm(params["q_norm"], q)
        k = common.rmsnorm(params["k_norm"], k)
    q = common.rope(q, positions, cfg.rope_theta)
    k = common.rope(k, positions, cfg.rope_theta)
    return q, k, v


def ring_pack_kv(k: torch.Tensor, v: torch.Tensor, L: int):
    """Full-sequence K/V (B, S, KH, hd) -> an L-slot ring cache: slot s
    holds the latest position p <= S-1 with p = s (mod L); unwritten
    slots hold position 0 and are masked at decode."""
    S = k.shape[1]
    slots = torch.arange(L, device=k.device)
    p = (S - 1) - torch.remainder(S - 1 - slots, L)
    p = torch.clamp(p, 0, S - 1)
    return k.index_select(1, p), v.index_select(1, p)


def attention_train(params, h: torch.Tensor, cfg: ArchConfig, *, kind: str,
                    positions: torch.Tensor, prefix_len: int = 0,
                    return_kv: bool = False, tp=None):
    """Full-sequence causal attention (training and prefill). h: (B, S, d);
    the first ``prefix_len`` positions (a prefix-LM's conditioning) are
    visible to every query. Under ``tp`` (a ``sharding.TensorParallel``)
    ``params`` hold this rank's columns (see the module's note) and the
    output is summed over the TP group; the heads must split over it
    (``kv_local`` not ``REPLICATED``). ``return_kv`` returns the K/V the
    rank computed: its own KV heads (``KV_OWN``), else every KV head.

    At every length this is ``ref.attention(prefix_len=)``. The JAX
    package's chunked route (``src/repro/models/attention.py``, taken for
    S > 1024 with prefix_len <= 512) drops the prefix mask from its
    global branch and attends causally there; the port does not follow it
    (ROADMAP §C)."""
    B, S, _ = h.shape
    window = cfg.window if kind == LOCAL else None
    group = tp.group if tp is not None else None
    q, k, v = _project_qkv(params, shd.copy_to(h, group), cfg, positions)
    computed = (k, v)
    if tp is not None and kv_local(cfg, tp.size) == KV_DIVIDE:
        # Every KV head was computed; this rank's query heads all read
        # one of them.
        kv = tp.rank * q.shape[2] * cfg.n_kv_heads // cfg.n_heads
        k, v = k[:, :, kv:kv + 1], v[:, :, kv:kv + 1]
    out = ops.attention(q, k, v, causal=True, window=window,
                        softcap=cfg.attn_softcap, prefix_len=prefix_len)
    out = shd.reduce(out.reshape(B, S, -1) @ params["wo"], group)
    if return_kv:
        return out, computed
    return out


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, L, KH, hd) — L = max_len (global) or window (local)
    v: torch.Tensor


# The raw cache's logical axes (the JAX package's ``engine._slot_axes``).
CACHE_AXES = KVCache(k=("batch", "cache_seq", "kv", None),
                     v=("batch", "cache_seq", "kv", None))


def cache_init(cfg: ArchConfig, kind: str, batch: int, max_len: int, dtype,
               device) -> KVCache:
    L = min(max_len, cfg.window) if kind == LOCAL else max_len
    shape = (batch, L, cfg.n_kv_heads, cfg.head_dim_)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


class DecodeShard(NamedTuple):
    """How a rank of a mesh serves one attention layer: ``tp`` its place
    on the TP axis where it computes only its own query heads (None where
    every rank computes every head: ``REPLICATED``, or no TP), the
    ``heads_mode`` (``kv_local``), and ``seq`` its place among the cache's
    sequence shards over ``model`` (a ``sharding.TensorParallel``; None
    where the rank holds every slot: the fsdp layout, or a length the
    shards do not divide)."""

    tp: Any
    heads_mode: str
    seq: Any


def cache_span(shard: Optional[DecodeShard], L: int):
    """(slot0, L_global, group) of a rank's L-slot cache: its first global
    slot, the whole cache's length and the group its partials combine
    over (0, L, None for a whole cache)."""
    if shard is None or shard.seq is None:
        return 0, L, None
    return shard.seq.rank * L, shard.seq.size * L, shard.seq.group


def cache_shard(k: torch.Tensor, v: torch.Tensor,
                shard: Optional[DecodeShard]):
    """A prefill's K/V (B, L, ., hd) of the heads the rank computed (its
    own KV heads under ``KV_OWN`` with TP, else every one), already padded
    or ring-packed to the cache's L slots -> the rank's cache: its
    sequence shard of every head (B, L / n, KH, hd), or every slot where
    the sequence is not split."""
    if shard is None:
        return k, v
    own = shard.tp is not None and shard.heads_mode == KV_OWN
    seq = shard.seq
    if seq is None:
        if own:   # the cache is whole on every rank: gather the heads
            kv = shd.all_gather(torch.stack([k, v]), 3, shard.tp.group)
            return kv[0], kv[1]
        return k, v
    B, L, n = k.shape[0], k.shape[1], seq.size
    Ll = L // n
    if not own:
        lo = seq.rank * Ll
        return k[:, lo:lo + Ll], v[:, lo:lo + Ll]
    # Block j of the sequence goes to rank j; rank i's block holds its
    # heads, which follow rank order.
    x = torch.stack([k, v]).reshape(2, B, n, Ll, *k.shape[2:])
    x = shd.all_to_all(x.permute(2, 0, 1, 3, 4, 5).contiguous(), seq.group)
    x = x.permute(1, 2, 3, 0, 4, 5).reshape(2, B, Ll, -1, k.shape[3])
    return x[0], x[1]


def replicate_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  shard: Optional[DecodeShard]):
    """One token's q and new K/V row, of the heads the rank computed,
    gathered over the TP group into every head (one all-gather; under
    ``KV_DIVIDE`` the rank computed every KV head and gathers q alone)."""
    if shard is None or shard.tp is None:
        return q, k, v
    tp = shard.tp
    if shard.heads_mode == KV_DIVIDE:
        return shd.all_gather(q, 2, tp.group), k, v
    B, _, Hl, hd = q.shape
    KHl = k.shape[2]
    g = shd.all_gather(torch.cat([q, k, v], dim=2), 2, tp.group)
    g = g.reshape(B, 1, tp.size, Hl + 2 * KHl, hd)
    return (g[:, :, :, :Hl].reshape(B, 1, -1, hd),
            g[:, :, :, Hl:Hl + KHl].reshape(B, 1, -1, hd),
            g[:, :, :, Hl + KHl:].reshape(B, 1, -1, hd))


def out_proj(o: torch.Tensor, params, shard: Optional[DecodeShard]
             ) -> torch.Tensor:
    """``wo`` of the decode output o (B, 1, H, hd) of every head: under TP
    row-parallel on the rank's own heads, summed over the TP group."""
    B, _, H, hd = o.shape
    if shard is None or shard.tp is None:
        return o.reshape(B, 1, H * hd) @ params["wo"]
    Hl = params["wo"].shape[0] // hd
    h0 = shard.tp.rank * Hl
    out = o[:, :, h0:h0 + Hl].reshape(B, 1, Hl * hd) @ params["wo"]
    return shd.reduce(out, shard.tp.group)


def splice_rows(part: torch.Tensor, new: torch.Tensor, slot: torch.Tensor,
                slot0: int = 0, L_global: Optional[int] = None) -> None:
    """``part[b, slot[b] - slot0] = new[b]`` in place. Where the part is
    the slots [slot0, slot0 + L) of an ``L_global``-slot cache, only the
    rows whose global ``slot`` lies there are written; the others belong
    to another rank's shard."""
    B, L = slot.shape[0], part.shape[1]
    rows = torch.arange(B, device=slot.device)
    if L_global is None or L_global == L:
        part[rows, slot] = new
        return
    loc = slot - slot0
    own = ((loc >= 0) & (loc < L)).reshape(B, *([1] * (new.dim() - 1)))
    loc = torch.clamp(loc, 0, L - 1)
    part[rows, loc] = torch.where(own, new, part[rows, loc])


def decode_slot_index(pos: torch.Tensor, L: int, kind: str) -> torch.Tensor:
    return torch.remainder(pos, L) if kind == LOCAL else pos


def decode_attend(q: torch.Tensor, k_c: torch.Tensor, v_c: torch.Tensor,
                  pos: torch.Tensor, cfg: ArchConfig, kind: str, *,
                  slot0: int = 0, L_global: Optional[int] = None,
                  group=None) -> torch.Tensor:
    """Attend one query token per row over a raw (ring-buffered) cache.
    q (B, 1, H, hd); pos (B,). Returns (B, 1, H, hd). The softmax is the
    JAX package's arithmetic: exp(s - max) over its sum, rounded to the
    cache dtype before p . v. With ``group`` the cache holds the slots
    [slot0, slot0 + L) of an ``L_global``-slot cache split over the group's
    ranks: the max, the sum and the p . v partials are all-reduced, so the
    global p is formed and rounded as on one device."""
    B = q.shape[0]
    hd, H, KH = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    L = k_c.shape[1]
    window = cfg.window if kind == LOCAL else None
    valid = ops.decode_kv_mask(
        pos[:, None], L if L_global is None else L_global, window,
        slots=slot0 + torch.arange(L, device=q.device)[None])
    rep = H // KH
    qg = q.reshape(B, KH, rep, hd).to(torch.float32)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_c.to(torch.float32))
    s = s * (1.0 / (hd ** 0.5))
    if cfg.attn_softcap is not None:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    e, total = shd.softmax_stats(s, group)
    p = e / total
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(k_c.dtype).to(torch.float32),
                     v_c.to(torch.float32))
    o = shd.all_reduce_(o, group)
    return o.reshape(B, 1, H, hd).to(q.dtype)


def attention_decode(params, h_tok: torch.Tensor, cache: KVCache,
                     pos: torch.Tensor, cfg: ArchConfig, *, kind: str,
                     shard: Optional[DecodeShard] = None
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode over a raw cache, updated in place (the JAX
    package donates it). h_tok (B, 1, d); pos (B,) int64. Under a mesh
    (``shard``) the cache is the rank's sequence shard (see the module's
    note)."""
    L = cache.k.shape[1]
    q, k_new, v_new = _project_qkv(params, h_tok, cfg, pos[:, None])
    q, k_new, v_new = replicate_qkv(q, k_new, v_new, shard)
    slot0, L_global, group = cache_span(shard, L)
    slot = decode_slot_index(pos, L_global, kind)
    splice_rows(cache.k, k_new[:, 0].to(cache.k.dtype), slot, slot0,
                L_global)
    splice_rows(cache.v, v_new[:, 0].to(cache.v.dtype), slot, slot0,
                L_global)
    o = decode_attend(q, cache.k, cache.v, pos, cfg, kind, slot0=slot0,
                      L_global=L_global, group=group)
    return out_proj(o, params, shard), cache
