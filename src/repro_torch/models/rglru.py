"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427), the
port of ``repro.models.rglru``.

    r_t = sigmoid(w_r . x_t + b_r)            (recurrence gate)
    i_t = sigmoid(w_i . x_t + b_i)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t     (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates are diagonal (per channel) rather than Griffin's block-diagonal
ones, as in the JAX package, which documents the simplification (ROADMAP
§C). A full sequence runs a log-depth scan of (log a, b) pairs with the
decays in f32 (``associative_scan``, the JAX package's
``lax.associative_scan``); decode is the one-step recurrence over a
(B, lru_width) state.

Block layout: in-proj -> [x branch: causal conv(4) -> RG-LRU] * gelu(gate
branch) -> out-proj.

Under tensor parallelism (``rglru_forward(tp=)``) a rank holds its own
``lru`` channels: its columns of ``w_x`` and ``w_gate``, its slices of the
per-channel conv, gates and ``lam`` (the recurrence never mixes
channels), and its rows of the row-parallel ``w_out``, whose partial
output is summed over the TP group. ``rglru_decode(tp=)`` steps the same
channels over a cache that holds them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import common
from repro_torch.models.mamba2 import causal_conv, raw_tail, softplus

C_FACTOR = 8.0

# The logical axes of each leaf (the JAX package's ``ParamFactory`` names).
PARAM_AXES = {"w_x": ("embed", "lru"), "w_gate": ("embed", "lru"),
              "conv": ("conv", "lru"), "w_r": ("lru",), "b_r": ("lru",),
              "w_i": ("lru",), "b_i": ("lru",), "lam": ("lru",),
              "w_out": ("lru", "embed")}


def rglru_init(cfg: ArchConfig, gen, device, dtype):
    """One RG-LRU block's parameters in the JAX package's leaf order; the
    gate vectors and ``lam`` are f32."""
    d, lw, cw = cfg.d_model, cfg.lru_width_, cfg.conv_width

    def f32(fill):
        return torch.full((lw,), fill, dtype=torch.float32, device=device)

    return {
        "w_x": common.normal_init((d, lw), gen, device, dtype),
        "w_gate": common.normal_init((d, lw), gen, device, dtype),
        "conv": common.normal_init((cw, lw), gen, device, dtype,
                                   scale=cw ** -0.5),
        "w_r": f32(0.0), "b_r": f32(0.0), "w_i": f32(0.0), "b_i": f32(0.0),
        "lam": f32(1.0),
        "w_out": common.normal_init((lw, d), gen, device, dtype),
    }


def _gates(params, xb: torch.Tensor):
    """xb (B, S, lru), the conv output. Returns (log_a, gated input), f32."""
    xf = xb.to(torch.float32)
    r = torch.sigmoid(params["w_r"] * xf + params["b_r"])
    i = torch.sigmoid(params["w_i"] * xf + params["b_i"])
    log_a = -C_FACTOR * softplus(params["lam"]) * r  # <= 0
    a2 = torch.exp(2.0 * log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-9))
    return log_a, beta * (i * xf)


def _combine(e1, e2):
    """(log a, b) pairs in time order: a2 after a1."""
    la1, b1 = e1
    la2, b2 = e2
    return la1 + la2, torch.exp(la2) * b1 + b2


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a's entries at the even indices along ``dim``, b's at the odd ones
    (a holds as many as b or one more)."""
    m = b.shape[dim]
    out = torch.stack([a.narrow(dim, 0, m), b], dim=dim + 1).flatten(
        dim, dim + 1)
    if a.shape[dim] > m:
        out = torch.cat([out, a.narrow(dim, m, 1)], dim=dim)
    return out


def associative_scan(combine: Callable, elems: Sequence[torch.Tensor],
                     dim: int):
    """Inclusive scan of ``combine`` along ``dim`` in log depth:
    ``jax.lax.associative_scan``'s odd/even recursion (pairs reduced,
    the half scanned, the even entries filled in), so the products are
    grouped as JAX groups them."""
    n = elems[0].shape[dim]
    if n < 2:
        return list(elems)

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = combine([sl(e, 0, n - 1, 2) for e in elems],
                      [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine([sl(e, 0, -1) for e in odd],
                       [sl(e, 2, None, 2) for e in elems])
    else:
        even = combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
    return [_interleave(a, b, dim) for a, b in zip(even, odd)]


class LRUCache(NamedTuple):
    conv: torch.Tensor   # (B, cw-1, lru), the conv input's tail
    state: torch.Tensor  # (B, lru) f32


# The cache's logical axes (the JAX package's ``engine._slot_axes``).
CACHE_AXES = LRUCache(conv=("batch", None, "lru"), state=("batch", "lru"))


def _out(params, y: torch.Tensor, gate: torch.Tensor, dtype):
    g = common.activation("gelu")(gate.to(torch.float32)).to(dtype)
    return (y.to(dtype) * g) @ params["w_out"]


def rglru_forward(params, h: torch.Tensor, cfg: ArchConfig,
                  return_cache: bool = False, tp=None):
    """Full-sequence recurrent block. h (B, S, d). Under ``tp`` (a
    ``sharding.TensorParallel``) ``params`` hold this rank's channels and
    the output is summed over the TP group."""
    group = tp.group if tp is not None else None
    h = shd.copy_to(h, group)
    xb_raw = h @ params["w_x"]
    gate = h @ params["w_gate"]
    xb, _ = causal_conv(xb_raw, params["conv"])
    log_a, b = _gates(params, xb)  # (B, S, lw) f32
    _, hseq = associative_scan(_combine, (log_a, b), dim=1)
    out = shd.reduce(_out(params, hseq, gate, h.dtype), group)
    if return_cache:
        return out, LRUCache(conv=raw_tail(xb_raw, cfg.conv_width),
                             state=hseq[:, -1])
    return out


def lru_cache_init(cfg: ArchConfig, batch: int, dtype, device) -> LRUCache:
    lw = cfg.lru_width_
    return LRUCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, lw), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, lw), dtype=torch.float32, device=device))


def rglru_decode(params, h_tok: torch.Tensor, cache: LRUCache,
                 cfg: ArchConfig, tp=None) -> Tuple[torch.Tensor, LRUCache]:
    """One token a row. h_tok (B, 1, d). Returns (out, the new cache).
    Under ``tp`` ``params`` and the cache hold this rank's channels and
    the output is summed over the TP group."""
    xb = h_tok @ params["w_x"]
    gate = h_tok @ params["w_gate"]
    xb, new_conv = causal_conv(xb, params["conv"], cache.conv)
    log_a, b = _gates(params, xb)  # (B, 1, lw)
    state = torch.exp(log_a[:, 0]) * cache.state + b[:, 0]
    out = _out(params, state[:, None, :], gate, h_tok.dtype)
    return (shd.reduce(out, tp.group if tp is not None else None),
            LRUCache(conv=new_conv, state=state))
