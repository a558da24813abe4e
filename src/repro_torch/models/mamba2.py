"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060), the port of
``repro.models.mamba2``.

Chunked SSD forward: within a chunk the recurrence is a masked quadratic,
attention-like product; across chunks a loop carries the (H, N, P) state
(the JAX package's ``lax.scan``; 16 chunks at S 2048). Decode is the pure
recurrence over a constant-size state: no KV cache.

Shapes follow the "minimal mamba2" formulation:
  x:  (B, S, H, P)   P = ssm_head_dim, H = d_inner / P
  dt: (B, S, H)      softplus(dt_raw + dt_bias)
  B,C:(B, S, G, N)   G = ssm_groups (broadcast to H), N = ssm_state

Everything past the projections runs in f32, as in the JAX package (the
f32 products stay f32: TF32 must be off for them on the card).

Under tensor parallelism (``ssd_forward(tp=)``) a rank computes its own
SSD heads: its columns of ``w_x``, ``w_z``, ``w_dt`` and ``conv_x`` and its
slices of ``A_log``, ``D``, ``dt_bias`` and the gated norm's scale (a
head's inner channels are its own), from the whole ``w_B``, ``w_C`` and
their convs (the ``state`` dim is replicated; each rank's gradient of
them is a share). The gated RMSNorm's mean square spans every rank's
channels (``common.rmsnorm(tp=)``), and ``w_out``'s partial product is
summed over the TP group. ``ssd_decode(tp=)`` steps the same heads over a
cache that holds the rank's heads (``state``) and channels (``conv_x``),
as the JAX package's cache axes place them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import common

# The logical axes of each leaf (the JAX package's ``ParamFactory`` names).
PARAM_AXES = {"w_x": ("embed", "ssm_inner"), "w_z": ("embed", "ssm_inner"),
              "w_B": ("embed", "state"), "w_C": ("embed", "state"),
              "w_dt": ("embed", "heads"), "conv_x": ("conv", "ssm_inner"),
              "conv_B": ("conv", "state"), "conv_C": ("conv", "state"),
              "A_log": ("heads",), "D": ("heads",), "dt_bias": ("heads",),
              "norm": {"scale": ("ssm_inner",)},
              "w_out": ("ssm_inner", "embed")}


def ssd_init(cfg: ArchConfig, gen, device, dtype):
    """One SSD block's parameters, drawn from ``gen`` in the JAX package's
    leaf order; ``A_log``, ``D`` and ``dt_bias`` are f32 vectors."""
    d, di = cfg.d_model, cfg.d_inner
    gn, H, cw = cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads, cfg.conv_width

    def normal(shape, scale=None):
        return common.normal_init(shape, gen, device, dtype, scale=scale)

    def f32(fill):
        return torch.full((H,), fill, dtype=torch.float32, device=device)

    return {
        "w_x": normal((d, di)),
        "w_z": normal((d, di)),
        "w_B": normal((d, gn)),
        "w_C": normal((d, gn)),
        "w_dt": normal((d, H)),
        "conv_x": normal((cw, di), cw ** -0.5),
        "conv_B": normal((cw, gn), cw ** -0.5),
        "conv_C": normal((cw, gn), cw ** -0.5),
        "A_log": f32(0.0),
        "D": f32(1.0),
        "dt_bias": f32(0.0),
        "norm": common.rmsnorm_init(di, device, dtype),
        "w_out": normal((di, d)),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), without torch's threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time. x (B, S, C); w (cw, C). The cw
    products are summed left to right in x's dtype, each rounded, as the
    JAX package's Python ``sum`` does (``F.conv1d`` rounds in another
    order). With ``state`` (B, cw-1, C), the decode carry, it goes in
    front and the new carry is returned too; else the sequence is padded
    with zeros and the carry is None."""
    cw = w.shape[0]
    if state is not None:
        x = torch.cat([state.to(x.dtype), x], dim=1)
        new_state = x[:, -(cw - 1):]
    else:
        x = F.pad(x, (0, 0, cw - 1, 0))
        new_state = None
    n = x.shape[1] - cw + 1
    out = x[:, 0:n] * w[0]
    for i in range(1, cw):
        out = out + x[:, i:i + n] * w[i]
    return out, new_state


def raw_tail(x: torch.Tensor, cw: int) -> torch.Tensor:
    """The last cw-1 positions of a conv's input (B, S, C): the decode
    carry after a prefill (zeros before a prompt shorter than cw-1)."""
    return F.pad(x, (0, 0, max(cw - 1 - x.shape[1], 0), 0))[:, -(cw - 1):]


def _projections(params, h: torch.Tensor, cfg: ArchConfig, conv_state=None,
                 return_raw_tail: bool = False, tp=None):
    """x (B, S, H, P), z, B and C per head (B, S, H, N), dt (B, S, H), A
    (H,) and the conv tails; H is this rank's heads under ``tp``."""
    B, S, _ = h.shape
    G, N, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    H = params["A_log"].shape[0]
    x = h @ params["w_x"]
    z = h @ params["w_z"]
    Bp = h @ params["w_B"]
    Cp = h @ params["w_C"]
    dt_raw = (h @ params["w_dt"]).to(torch.float32)

    tail = None
    if return_raw_tail:
        cw = cfg.conv_width
        tail = {"x": raw_tail(x, cw), "B": raw_tail(Bp, cw),
                "C": raw_tail(Cp, cw)}
    x, sx = causal_conv(x, params["conv_x"],
                        None if conv_state is None else conv_state["x"])
    Bp, sB = causal_conv(Bp, params["conv_B"],
                         None if conv_state is None else conv_state["B"])
    Cp, sC = causal_conv(Cp, params["conv_C"],
                         None if conv_state is None else conv_state["C"])
    x, Bp, Cp = (F.silu(t.to(torch.float32)).to(h.dtype)
                 for t in (x, Bp, Cp))

    x = x.reshape(B, S, H, P)
    Bp = Bp.reshape(B, S, G, N)
    Cp = Cp.reshape(B, S, G, N)
    rep = cfg.ssm_heads // G
    if rep > 1:
        Bp = torch.repeat_interleave(Bp, rep, dim=2)
        Cp = torch.repeat_interleave(Cp, rep, dim=2)
    if tp is not None:   # this rank's heads' groups
        Bp, Cp = (t.narrow(2, tp.rank * H, H) for t in (Bp, Cp))
    dt = softplus(dt_raw + params["dt_bias"])
    A = -torch.exp(params["A_log"])  # (H,) negative
    if conv_state is not None:
        tail = {"x": sx, "B": sB, "C": sC}
    return x, z, Bp, Cp, dt, A, tail


def _gated_out(params, y: torch.Tensor, z: torch.Tensor, dtype, tp=None):
    y = y * F.silu(z.to(torch.float32)).to(dtype)
    out = common.rmsnorm(params["norm"], y, tp=tp) @ params["w_out"]
    return shd.reduce(out, tp.group if tp is not None else None)


class SSDCache(NamedTuple):
    conv_x: torch.Tensor   # (B, cw-1, d_inner), the conv inputs' tail
    conv_B: torch.Tensor   # (B, cw-1, G*N)
    conv_C: torch.Tensor   # (B, cw-1, G*N)
    state: torch.Tensor    # (B, H, N, P) f32


# The cache's logical axes (the JAX package's ``engine._slot_axes``).
CACHE_AXES = SSDCache(conv_x=("batch", None, "ssm_inner"),
                      conv_B=("batch", None, "state"),
                      conv_C=("batch", None, "state"),
                      state=("batch", "heads", None, None))


def ssd_forward(params, h: torch.Tensor, cfg: ArchConfig,
                return_cache: bool = False, tp=None):
    """Chunked SSD over a full sequence. h: (B, S, d). Under ``tp`` (a
    ``sharding.TensorParallel``) ``params`` hold this rank's heads (see
    the module's note) and the output is summed over the TP group.

    A sequence that does not divide the chunk is padded; the padded
    positions get dt = 0 (decay 1, update 0), so the carried state is
    untouched and a prefill's state hand-off is exact at any length."""
    B, S, _ = h.shape
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    H = params["A_log"].shape[0]
    cs = min(cfg.ssm_chunk, S)
    h = shd.copy_to(h, tp.group if tp is not None else None)
    x, z, Bp, Cp, dt, A, tail = _projections(params, h, cfg,
                                             return_raw_tail=return_cache,
                                             tp=tp)
    S_orig = S
    pad = (-S) % cs
    if pad:
        x, Bp, Cp = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bp, Cp))
        dt = F.pad(dt, (0, 0, 0, pad))  # dt = 0: state frozen
        S = S + pad
    nc = S // cs
    f32 = torch.float32
    xc = x.reshape(B, nc, cs, H, P).to(f32)
    Bc = Bp.reshape(B, nc, cs, H, N).to(f32)
    Cc = Cp.reshape(B, nc, cs, H, N).to(f32)
    dtc = dt.reshape(B, nc, cs, H)

    da = dtc * A                                   # (B, nc, cs, H) log decay
    cum = torch.cumsum(da, dim=2)                  # within-chunk cumulative
    total = cum[:, :, -1, :]                       # (B, nc, H)

    # Intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j. For j > i the
    # difference is a positive sum of up to cs - 1 dt * |A| terms, past
    # f32's exp limit (88.7) at cs 128 with A_log = dt_bias = 0; the JAX
    # package masks after the exp, and the VJP of that mask multiplies 0
    # by inf, so its gradients turn NaN (ROADMAP §C). Masking before the
    # exp gives the same forward and finite gradients.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,i,j,H)
    tril = torch.ones((cs, cs), dtype=torch.bool, device=h.device).tril()
    L = torch.exp(torch.where(tril[:, :, None], diff,
                              torch.tensor(float("-inf"), device=h.device)))
    G_ = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc)        # C_i . B_j
    M = G_ * L
    xdt = xc * dtc[..., None]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xdt)

    # Chunk-boundary states, then the inter-chunk recurrence.
    decay_to_end = torch.exp(total[:, :, None, :] - cum)   # (B,nc,cs,H)
    state_c = torch.einsum("bcjhn,bcjhp->bchnp",
                           Bc * (decay_to_end * dtc)[..., None], xc)
    carry = torch.zeros((B, H, N, P), dtype=f32, device=h.device)
    prev = []
    for c in range(nc):
        prev.append(carry)  # the state before chunk c
        carry = (carry * torch.exp(total[:, c])[:, :, None, None]
                 + state_c[:, c])
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,H,N,P)
    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           Cc * torch.exp(cum)[..., None], prev_states)

    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + xc.reshape(B, S, H, P) * params["D"][:, None]
    y = y.reshape(B, S, H * P).to(h.dtype)[:, :S_orig]
    out = _gated_out(params, y, z, h.dtype, tp)
    if return_cache:
        return out, SSDCache(conv_x=tail["x"], conv_B=tail["B"],
                             conv_C=tail["C"], state=carry)
    return out


def ssd_cache_init(cfg: ArchConfig, batch: int, dtype, device) -> SSDCache:
    cw, gn = cfg.conv_width, cfg.ssm_groups * cfg.ssm_state

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    return SSDCache(conv_x=zeros(batch, cw - 1, cfg.d_inner),
                    conv_B=zeros(batch, cw - 1, gn),
                    conv_C=zeros(batch, cw - 1, gn),
                    state=zeros(batch, cfg.ssm_heads, cfg.ssm_state,
                                cfg.ssm_head_dim, dt=torch.float32))


def ssd_decode(params, h_tok: torch.Tensor, cache: SSDCache,
               cfg: ArchConfig, tp=None) -> Tuple[torch.Tensor, SSDCache]:
    """One token a row: state = exp(dt A) state + dt B x; y = C . state +
    D x. h_tok (B, 1, d). Returns (out, the new cache). Under ``tp``
    ``params`` and the cache hold this rank's heads (the module's note)."""
    B = h_tok.shape[0]
    H, P = params["A_log"].shape[0], cfg.ssm_head_dim
    conv_state = {"x": cache.conv_x, "B": cache.conv_B, "C": cache.conv_C}
    x, z, Bp, Cp, dt, A, new_conv = _projections(params, h_tok, cfg,
                                                 conv_state, tp=tp)
    f32 = torch.float32
    xf, Bf, Cf = (t[:, 0].to(f32) for t in (x, Bp, Cp))  # (B,H,P|N)
    dtf = dt[:, 0]                                        # (B, H)
    decay = torch.exp(dtf * A)
    upd = torch.einsum("bhn,bhp->bhnp", Bf, xf * dtf[..., None])
    state = cache.state * decay[:, :, None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", Cf, state)
    y = y + xf * params["D"][:, None]
    y = y.reshape(B, 1, H * P).to(h_tok.dtype)
    return _gated_out(params, y, z, h_tok.dtype, tp), SSDCache(
        conv_x=new_conv["x"], conv_B=new_conv["B"], conv_C=new_conv["C"],
        state=state)
