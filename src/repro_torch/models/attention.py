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
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

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
    (``kv_local`` not ``REPLICATED``).

    At every length this is ``ref.attention(prefix_len=)``. The JAX
    package's chunked route (``src/repro/models/attention.py``, taken for
    S > 1024 with prefix_len <= 512) drops the prefix mask from its
    global branch and attends causally there; the port does not follow it
    (ROADMAP §C)."""
    B, S, _ = h.shape
    window = cfg.window if kind == LOCAL else None
    group = tp.group if tp is not None else None
    q, k, v = _project_qkv(params, shd.copy_to(h, group), cfg, positions)
    if tp is not None and kv_local(cfg, tp.size) == KV_DIVIDE:
        # Every KV head was computed; this rank's query heads all read
        # one of them.
        kv = tp.rank * q.shape[2] * cfg.n_kv_heads // cfg.n_heads
        k, v = k[:, :, kv:kv + 1], v[:, :, kv:kv + 1]
    out = ops.attention(q, k, v, causal=True, window=window,
                        softcap=cfg.attn_softcap, prefix_len=prefix_len)
    out = shd.reduce(out.reshape(B, S, -1) @ params["wo"], group)
    if return_kv:
        return out, (k, v)
    return out


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, L, KH, hd) — L = max_len (global) or window (local)
    v: torch.Tensor


def cache_init(cfg: ArchConfig, kind: str, batch: int, max_len: int, dtype,
               device) -> KVCache:
    L = min(max_len, cfg.window) if kind == LOCAL else max_len
    shape = (batch, L, cfg.n_kv_heads, cfg.head_dim_)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def decode_slot_index(pos: torch.Tensor, L: int, kind: str) -> torch.Tensor:
    return torch.remainder(pos, L) if kind == LOCAL else pos


def decode_attend(q: torch.Tensor, k_c: torch.Tensor, v_c: torch.Tensor,
                  pos: torch.Tensor, cfg: ArchConfig, kind: str
                  ) -> torch.Tensor:
    """Attend one query token per row over a raw (ring-buffered) cache.
    q (B, 1, H, hd); pos (B,). Returns (B, 1, H, hd)."""
    B = q.shape[0]
    hd, H, KH = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    L = k_c.shape[1]
    window = cfg.window if kind == LOCAL else None
    valid = ops.decode_kv_mask(pos[:, None], L, window,
                               slots=torch.arange(L, device=q.device)[None])
    rep = H // KH
    qg = q.reshape(B, KH, rep, hd).to(torch.float32)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_c.to(torch.float32))
    s = s * (1.0 / (hd ** 0.5))
    if cfg.attn_softcap is not None:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(k_c.dtype).to(torch.float32),
                     v_c.to(torch.float32))
    return o.reshape(B, 1, H, hd).to(q.dtype)


def attention_decode(params, h_tok: torch.Tensor, cache: KVCache,
                     pos: torch.Tensor, cfg: ArchConfig, *, kind: str
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode over a raw cache, updated in place (the JAX
    package donates it). h_tok (B, 1, d); pos (B,) int64."""
    B = h_tok.shape[0]
    hd, H = cfg.head_dim_, cfg.n_heads
    L = cache.k.shape[1]
    q, k_new, v_new = _project_qkv(params, h_tok, cfg, pos[:, None])
    slot = decode_slot_index(pos, L, kind)
    rows = torch.arange(B, device=h_tok.device)
    cache.k[rows, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v_new[:, 0].to(cache.v.dtype)
    o = decode_attend(q, cache.k, cache.v, pos, cfg, kind)
    out = o.reshape(B, 1, H * hd) @ params["wo"]
    return out, cache
