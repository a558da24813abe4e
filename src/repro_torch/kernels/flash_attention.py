"""Flash attention forward and backward: CUDA kernel wrappers, their
plain versions, the kernels' tile plan and CPU mirrors of their numerics.

The forward replaces the TPU kernel ``src/repro/kernels/flash_attention.py:
flash_attention``. Its kernel is ``csrc/flash_attention.cu``: one CTA of
two warpgroups per (batch*head, 128-row query tile), 32-key tiles staged
by cp.async, Q K^T and P V on the tensor cores (wgmma), f32 online
softmax with P split into three bf16 terms, and optionally each row's
log-sum-exp.
The backward, ``csrc/flash_attention_bwd.cu``, is the gradient of that
function, which the JAX package trains through its dense oracle (JAX
cannot differentiate the Pallas call): FA2-style recompute from the
log-sum-exp, one pass for dK/dV per key tile and one for dQ per query
tile, all five products on the tensor cores, no floating-point atomics.
Both are bound by operations on the H100. GQA callers fold the query head
group into the rows (``q_rep``), as ``ops.attention`` does.

``tile_plan`` lists the tiles each kernel visits (its grids come from
it); ``plain_tiled`` and ``plain_bwd_tiled`` run the kernels' tile
recurrences with their roundings on the CPU, for the tests only.

``flash_attention`` is differentiable: when autograd needs its gradient
it runs the forward kernel with the log-sum-exp and the backward kernel
in a ``torch.autograd.Function``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref
from repro_torch.kernels.ref import NEG_INF

# Head widths the kernels are built for. 144 and 240 (16 mod 32) run in
# tiles of 160 and 256 columns whose last 16 are zeros in shared memory
# (csrc/attention_tc.cuh): same function, no padded copy in memory.
HEAD_DIMS = (64, 128, 144, 192, 240, 256, 288)
# (query rows, keys) of a tile: the forward's CTA, the dK/dV pass's query
# tile and CTA, the dQ pass's CTA and key tile (csrc/flash_attention*.cu).
FWD_TILE, DKDV_TILE, DQ_TILE = (128, 32), (32, 64), (128, 32)


def plain(q, k, v, *, causal: bool = True, window: Optional[int] = None,
          softcap: Optional[float] = None, prefix_len: int = 0,
          q_rep: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dense f32 attention with
    the folded-row causal position r // q_rep, the first ``prefix_len``
    keys visible to every row."""
    return ref.attention(q, k, v, causal=causal, window=window,
                         softcap=softcap, prefix_len=prefix_len, q_rep=q_rep)


def plain_bwd(q, k, v, do, *, causal: bool = True,
              window: Optional[int] = None, softcap: Optional[float] = None,
              prefix_len: int = 0, q_rep: int = 1):
    """The backward kernel's function in plain PyTorch: (dq, dk, dv) by
    autograd through ``plain``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = plain(*leaves, causal=causal, window=window, softcap=softcap,
                  prefix_len=prefix_len, q_rep=q_rep)
        return torch.autograd.grad(o, leaves, do)


def visible_mask(Sq: int, Sk: int, q_rep: int, causal: bool,
                 window: Optional[int], device=None,
                 prefix_len: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool: which (folded row, key) pairs attention sees."""
    q_pos = (torch.arange(Sq, device=device) // q_rep)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask = k_pos <= q_pos
    if window is not None and window > 0:
        mask = mask & (k_pos > q_pos - window)
    if prefix_len > 0:
        mask = mask | (k_pos < prefix_len)
    return mask


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The tiles of (Sq folded rows) x (Sk keys) that a kernel visits, with
    ``bq`` rows and ``bk`` keys a tile. ``q_keys[i]``: the key tiles query
    tile i visits (the forward and dQ passes), ascending; ``q_masked[i]``:
    those that need the mask (the rest are visible pair by pair).
    ``k_rows[j]`` and ``k_masked[j]``: the same for key tile j over query
    tiles (the dK/dV pass). ``q_order``: the query tile each grid row
    computes, longest first."""
    bq: int
    bk: int
    q_keys: tuple
    q_masked: tuple
    k_rows: tuple
    k_masked: tuple
    q_order: tuple

    @property
    def q_tiles(self) -> int:
        return len(self.q_keys)

    @property
    def k_tiles(self) -> int:
        return len(self.k_rows)


@functools.lru_cache(maxsize=256)
def tile_plan(Sq: int, Sk: int, q_rep: int, causal: bool,
              window: Optional[int], bq: int, bk: int,
              prefix_len: int = 0) -> TilePlan:
    """The kernels' tile schedule, by the same integer arithmetic as
    ``csrc/flash_attention*.cu``: a query tile visits the key tiles that
    hold a key some row of it can see; a key tile (backward) the query
    tiles that hold such a row; a visited tile skips the mask when every
    pair in it is visible (``tile_open`` in ``attention_tc.cuh``). The
    first ``prefix_len`` keys are visible to every row: a query tile's
    keys start at 0 and end no earlier than the prefix, a key tile that
    starts inside the prefix visits every query tile (with a window, the
    tiles between the prefix and the window are visited and masked whole,
    a no-op of the recurrence), and a tile wholly inside it is open."""
    w = window if window is not None and window > 0 else 0
    P = max(int(prefix_len), 0)
    q_tiles, k_tiles = -(-Sq // bq), -(-Sk // bk)

    def open_(r0, k0):
        r_hi = min(r0 + bq, Sq) - 1
        k_hi = k0 + bk - 1
        if k_hi >= Sk:
            return False
        if k_hi < P:
            return True
        if causal and k_hi > r0 // q_rep:
            return False
        return not (w and k0 <= r_hi // q_rep - w)

    q_keys, q_masked = [], []
    for i in range(q_tiles):
        r0 = i * bq
        q_lo, q_hi = r0 // q_rep, (min(r0 + bq, Sq) - 1) // q_rep
        k_end = min(Sk, q_hi + 1) if causal else Sk
        k_begin = max(0, q_lo - w + 1) if w else 0
        if P:
            k_begin, k_end = 0, max(k_end, min(Sk, P))
        keys = tuple(range(k_begin // bk, -(-k_end // bk)))
        q_keys.append(keys)
        q_masked.append(frozenset(j for j in keys if not open_(r0, j * bk)))
    k_rows, k_masked = [], []
    for j in range(k_tiles):
        k0 = j * bk
        r_begin = k0 * q_rep if causal else 0
        r_end = min(Sq, (k0 + bk - 1 + w) * q_rep) if w else Sq
        if k0 < P:
            r_begin, r_end = 0, Sq
        rows = tuple(range(r_begin // bq, -(-r_end // bq)))
        k_rows.append(rows)
        k_masked.append(frozenset(i for i in rows if not open_(i * bq, k0)))
    return TilePlan(bq, bk, tuple(q_keys), tuple(q_masked), tuple(k_rows),
                    tuple(k_masked), tuple(range(q_tiles - 1, -1, -1)))


def _heads(x, S_pad=None):
    """(B, S, H, D) -> (B*H, S, D) f32, zero rows appended up to S_pad."""
    B, S, H, D = x.shape
    y = x.float().permute(0, 2, 1, 3).reshape(B * H, S, D)
    if S_pad is not None and S_pad > S:
        y = torch.cat([y, y.new_zeros((B * H, S_pad - S, D))], dim=1)
    return y


def _unheads(y, B, H):
    BH, S, D = y.shape
    return y.reshape(B, H, S, D).permute(0, 2, 1, 3)


def _logits(s, scale, softcap):
    """(scaled, softcapped logits, tanh of the softcap or None)."""
    x = s * scale
    if softcap is None:
        return x, None
    t = torch.tanh(x / softcap)
    return softcap * t, t


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _bf16_terms(x, n):
    """x as the sum of n bf16 terms, each the rounding of what the earlier
    ones leave (the forward kernel's P: n = 3, 24 significant bits)."""
    total, rest = torch.zeros_like(x), x
    for _ in range(n):
        term = _bf16(rest)
        total, rest = total + term, rest - term
    return total


def plain_tiled(q, k, v, *, causal: bool = True,
                window: Optional[int] = None, softcap: Optional[float] = None,
                prefix_len: int = 0, q_rep: int = 1):
    """The forward kernel's recurrence on the CPU: (out in q's dtype, the
    (B*H, Sq) f32 log-sum-exp). The tiles of ``tile_plan`` at
    ``FWD_TILE``, the online softmax in f32, P split into three bf16 terms
    before it multiplies V (three tensor-core products; one bf16 P puts
    2^-9 relative errors into O, more than one output ulp where rows
    cancel), and the row sum taken from that split P (the kernel's
    roundings; its f32 sums run in another order, and its tensor-core
    accumulators truncate, which no CPU sum mirrors). Tests only: held to
    ``plain`` within one bf16 ulp of the output, 2^-7 |plain| + 1e-3."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    bq, bk = FWD_TILE
    plan = tile_plan(Sq, Sk, q_rep, causal, window, bq, bk, prefix_len)
    scale = 1.0 / (D ** 0.5)
    Sk_pad = -(-Sk // bk) * bk
    qf, kf, vf = _heads(q), _heads(k, Sk_pad), _heads(v, Sk_pad)
    vis = visible_mask(Sq, Sk_pad, q_rep, causal, window,
                       prefix_len=prefix_len)
    vis[:, Sk:] = False
    out = torch.zeros_like(qf)
    lse = torch.empty((B * H, Sq), dtype=torch.float32)
    for i, keys in enumerate(plan.q_keys):
        rows = slice(i * bq, min((i + 1) * bq, Sq))
        n = rows.stop - rows.start
        m = torch.full((B * H, n), NEG_INF)
        l = torch.zeros((B * H, n))
        acc = torch.zeros((B * H, n, D))
        for j in keys:
            cols = slice(j * bk, (j + 1) * bk)
            x, _ = _logits(qf[:, rows] @ kf[:, cols].transpose(1, 2), scale,
                           softcap)
            if j in plan.q_masked[i]:
                x = torch.where(vis[rows, cols], x, NEG_INF)
            m_new = torch.maximum(m, x.amax(-1))
            p = _bf16_terms(torch.exp(x - m_new[..., None]), 3)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + p @ vf[:, cols]
            m = m_new
        den = l.clamp_min(1e-30)
        out[:, rows] = acc / den[..., None]
        lse[:, rows] = m + torch.log(den)
    return _unheads(out, B, H).to(q.dtype), lse


def plain_bwd_tiled(q, k, v, o, do, lse, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, prefix_len: int = 0,
                    q_rep: int = 1):
    """The backward kernels' recurrences on the CPU: (dq, dk, dv) in q's
    dtype from the forward's output ``o`` and (B*H, Sq) log-sum-exp.
    delta = rowsum(dO * bf16(O)); the dK/dV pass over the tiles of
    ``tile_plan`` at ``DKDV_TILE`` (P^T to bf16 for dV, dS^T = P (1 - t^2)
    (dP - delta) to bf16 for dK), the dQ pass at ``DQ_TILE`` (dS to bf16),
    f32 sums. Tests only: held to ``plain_bwd`` per tensor within 2^-6 of
    its largest element, as the card's kernels are."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / (D ** 0.5)
    bk_max = max(DKDV_TILE[1], DQ_TILE[1])
    Sk_pad = -(-Sk // bk_max) * bk_max
    qf, dof = _heads(q), _heads(do)
    kf, vf = _heads(k, Sk_pad), _heads(v, Sk_pad)
    delta = (dof * _bf16(_heads(o))).sum(-1)
    lse = lse.float()
    vis = visible_mask(Sq, Sk_pad, q_rep, causal, window,
                       prefix_len=prefix_len)
    vis[:, Sk:] = False

    def tile(rows, cols):
        """P, dS (f32, rows x keys) and the softcap's tanh on one tile."""
        x, t = _logits(qf[:, rows] @ kf[:, cols].transpose(1, 2), scale,
                       softcap)
        p = torch.exp(x - lse[:, rows, None])
        return p, t

    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    bq, bk = DKDV_TILE
    plan = tile_plan(Sq, Sk, q_rep, causal, window, bq, bk, prefix_len)
    for j, row_tiles in enumerate(plan.k_rows):
        cols = slice(j * bk, (j + 1) * bk)
        for i in row_tiles:
            rows = slice(i * bq, min((i + 1) * bq, Sq))
            p, t = tile(rows, cols)
            if i in plan.k_masked[j]:
                p = torch.where(vis[rows, cols], p, 0.0)
            g = p if t is None else p * (1 - t * t)
            dp = dof[:, rows] @ vf[:, cols].transpose(1, 2)
            ds = _bf16(g * (dp - delta[:, rows, None]))
            dv[:, cols] += _bf16(p).transpose(1, 2) @ dof[:, rows]
            dk[:, cols] += ds.transpose(1, 2) @ qf[:, rows]
    dq = torch.zeros_like(qf)
    bq, bk = DQ_TILE
    plan = tile_plan(Sq, Sk, q_rep, causal, window, bq, bk, prefix_len)
    for i, keys in enumerate(plan.q_keys):
        rows = slice(i * bq, min((i + 1) * bq, Sq))
        for j in keys:
            cols = slice(j * bk, (j + 1) * bk)
            p, t = tile(rows, cols)
            if j in plan.q_masked[i]:
                p = torch.where(vis[rows, cols], p, 0.0)
            dp = dof[:, rows] @ vf[:, cols].transpose(1, 2)
            ds = p * (dp - delta[:, rows, None])
            if t is not None:
                ds = ds * (1 - t * t)
            dq[:, rows] += _bf16(ds) @ kf[:, cols]
    return (_unheads(dq * scale, B, H).to(q.dtype),
            _unheads(dk[:, :Sk] * scale, B, H).to(k.dtype),
            _unheads(dv[:, :Sk], B, H).to(v.dtype))


def _check(q, k, v, q_rep: int, **more):
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"bf16 CUDA tensor, got {t.dtype} on {t.device}")
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    for name, t in more.items():
        if t.shape != q.shape:
            raise ValueError(f"flash_attention: {name} {tuple(t.shape)} does "
                             f"not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if Sq % q_rep:
        raise ValueError(f"flash_attention: {Sq} rows not a multiple of "
                         f"q_rep={q_rep}")


def _scalars(causal, window, softcap, prefix_len, D):
    if prefix_len < 0:
        raise ValueError(f"flash_attention: prefix_len {prefix_len} < 0")
    return (int(causal), -1 if window is None else int(window),
            int(prefix_len), 0.0 if softcap is None else float(softcap),
            1.0 / (D ** 0.5))


def _forward(q, k, v, causal, window, softcap, q_rep, with_lse: bool,
             prefix_len: int = 0):
    lib = _lib.load()
    _check(q, k, v, q_rep)
    B, Sq, H, D = q.shape
    c, w, p, cap, scale = _scalars(causal, window, softcap, prefix_len, D)
    out = torch.empty_like(q)
    lse = (torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    plan = tile_plan(Sq, k.shape[1], q_rep, bool(causal), window, *FWD_TILE,
                     p)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, k.shape[1], H, D,
        q_rep, c, w, p, plan.q_tiles, cap, scale, _lib.stream_ptr(q))
    _lib.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


class _FlashAttentionFn(torch.autograd.Function):
    """The forward kernel (saving q, k, v, o and the log-sum-exp) tied to
    the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_rep, prefix_len):
        out, lse = _forward(q, k, v, causal, window, softcap, q_rep,
                            with_lse=True, prefix_len=prefix_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      prefix_len=prefix_len, q_rep=q_rep)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.contiguous(), lse,
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, prefix_len: int = 0,
                    q_rep: int = 1) -> torch.Tensor:
    """Attention over q (B, Sq, H, D) and k/v (B, Sk, H, D) with the same
    head count; returns (B, Sq, H, D) in q's dtype. The first
    ``prefix_len`` keys are visible to every row. A CPU tensor takes the
    plain version (differentiable by autograd); any other tensor launches
    the kernel or raises, through the autograd Function when a gradient is
    needed."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, softcap=softcap,
                     prefix_len=prefix_len, q_rep=q_rep)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttentionFn.apply(q, k, v, causal, window, softcap,
                                       q_rep, prefix_len)
    return _forward(q, k, v, causal, window, softcap, q_rep,
                    with_lse=False, prefix_len=prefix_len)[0]


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None, prefix_len: int = 0,
                        q_rep: int = 1):
    """(dq, dk, dv) of ``flash_attention`` from its inputs, its output
    ``o``, the output gradient ``do`` and the forward's (B*H, Sq) f32
    log-sum-exp. A CPU tensor takes the plain version (``o`` and ``lse``
    unused); any other tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return plain_bwd(q, k, v, do, causal=causal, window=window,
                         softcap=softcap, prefix_len=prefix_len,
                         q_rep=q_rep)
    lib = _lib.load()
    _check(q, k, v, q_rep, o=o, do=do)
    B, Sq, H, D = q.shape
    if (not lse.is_cuda or lse.dtype != torch.float32
            or lse.shape != (B * H, Sq) or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"f32 CUDA tensor of shape {(B * H, Sq)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    Sk = k.shape[1]
    c, w, p, cap, scale = _scalars(causal, window, softcap, prefix_len, D)
    kv_plan = tile_plan(Sq, Sk, q_rep, bool(causal), window, *DKDV_TILE, p)
    q_plan = tile_plan(Sq, Sk, q_rep, bool(causal), window, *DQ_TILE, p)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, D, q_rep, c, w, p,
        kv_plan.k_tiles, q_plan.q_tiles, cap, scale, _lib.stream_ptr(q))
    _lib.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0
