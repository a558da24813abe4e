"""BitChop: history-based network-wide mantissa bitlength control (the
port of ``repro.core.bitchop``).

Paper §IV-B. Observes the per-batch training loss, keeps an exponential
moving average (eq. 8) and a noise threshold epsilon (an EMA of
|L - Mavg|), and once per period (N = 1 batch) shrinks, keeps or grows the
one network-wide mantissa bitlength (eq. 9):

    n <- n - 1   if Mavg > L + eps     (loss clearly improving)
    n <- n       if |Mavg - L| <= eps
    n <- n + 1   if Mavg < L - eps     (loss clearly regressing)

Full precision is forced for a window after a learning-rate change. The
state is a NamedTuple of 0-d tensors on the model's device (f32 EMAs,
int32 registers), so the controller steps with no host sync and a fused
pack reads the bitlength from device memory. BitWave spends the same
signal on the mantissa and the exponent bitlength.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class BitChopConfig:
    alpha: float = 0.1            # loss EMA decay (eq. 8)
    eps_alpha: float = 0.1        # EMA decay for the |L - Mavg| noise proxy
    eps_scale: float = 1.0        # epsilon = eps_scale * err_ema
    max_bits: int = 7             # container mantissa bits (7 bf16, 23 fp32)
    min_bits: int = 0
    period: int = 1               # batches per decision period (paper: N=1)
    warmup_steps: int = 8         # observe-only steps before first decision
    lr_change_hold: int = 100     # full-precision steps after an LR change


class BitChopState(NamedTuple):
    mavg: torch.Tensor        # f32, EMA of the loss
    err_ema: torch.Tensor     # f32, EMA of |L - mavg|
    n: torch.Tensor           # int32, current mantissa bitlength
    step: torch.Tensor        # int32
    hold_until: torch.Tensor  # int32; full precision while step < hold_until


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _i32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def init(cfg: BitChopConfig, device=None) -> BitChopState:
    return BitChopState(mavg=_f32(0.0, device), err_ema=_f32(0.0, device),
                        n=_i32(cfg.max_bits, device), step=_i32(0, device),
                        hold_until=_i32(0, device))


def _loss_signal(state, loss, cfg):
    """The eq. 8-9 machinery BitChop and BitWave share: the EMA updates
    and the ungated shrink/grow signals. Returns (mavg, err_ema, decide,
    shrink, grow)."""
    loss = torch.as_tensor(loss, dtype=torch.float32,
                           device=state.mavg.device)
    first = state.step == 0
    mavg0 = torch.where(first, loss, state.mavg)
    err = torch.abs(loss - mavg0)
    err_ema = torch.where(
        first, err, state.err_ema + cfg.eps_alpha * (err - state.err_ema))
    # eq. (8): Mavg <- Mavg + alpha * (L - Mavg)
    mavg = mavg0 + cfg.alpha * (loss - mavg0)

    eps = cfg.eps_scale * err_ema
    decide = ((state.step >= cfg.warmup_steps)
              & (state.step >= state.hold_until)
              & ((state.step % cfg.period) == 0))
    # eq. (9)
    shrink = mavg0 > loss + eps
    grow = mavg0 < loss - eps
    return mavg, err_ema, decide, shrink, grow


def _hold(state, cfg, lr_changed: bool) -> torch.Tensor:
    """hold_until after this step: a learning-rate change (the schedule's
    host bool) opens a window of ``lr_change_hold`` steps."""
    if lr_changed:
        return (state.step + cfg.lr_change_hold).to(torch.int32)
    return state.hold_until


def update(state: BitChopState, loss, cfg: BitChopConfig,
           lr_changed: bool = False) -> BitChopState:
    """One observe/decide step (eq. 8 + 9): the EMA update, the epsilon
    gate, the clip, then the hold override."""
    mavg, err_ema, decide, shrink, grow = _loss_signal(state, loss, cfg)
    delta = torch.where(shrink, -1, torch.where(grow, 1, 0)).to(torch.int32)
    n = torch.where(decide, state.n + delta, state.n)
    n = torch.clamp(n, cfg.min_bits, cfg.max_bits)
    hold_until = _hold(state, cfg, lr_changed)
    # During the hold window run at full container precision.
    n = torch.where(state.step < hold_until, cfg.max_bits, n)
    return BitChopState(mavg=mavg, err_ema=err_ema, n=n.to(torch.int32),
                        step=state.step + 1, hold_until=hold_until)


def effective_bits(state: BitChopState, cfg: BitChopConfig) -> torch.Tensor:
    """Bitlength to apply this step (full precision inside hold windows)."""
    return torch.where(state.step < state.hold_until, cfg.max_bits,
                       state.n).to(torch.int32)


# ----------------------------------------------------------------------
# BitWave: the same loss-EMA controller driving mantissa AND exponent bits
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BitWaveConfig:
    """BitWave = BitChop's eq. 8-9 signals steering two bitlengths. One
    shrink budget is spent round-robin (mantissa first: the bigger field),
    while a regression grows both at once."""

    alpha: float = 0.1
    eps_alpha: float = 0.1
    eps_scale: float = 1.0
    max_man_bits: int = 7         # container mantissa bits (7 bf16, 23 fp32)
    min_man_bits: int = 0
    max_exp_bits: int = 8         # container exponent bits
    min_exp_bits: int = 2         # a 1-bit exponent has no normal codes
    period: int = 1
    warmup_steps: int = 8
    lr_change_hold: int = 100


class BitWaveState(NamedTuple):
    mavg: torch.Tensor        # f32, EMA of the loss
    err_ema: torch.Tensor     # f32, EMA of |L - mavg|
    n_man: torch.Tensor       # int32, current mantissa bitlength
    n_exp: torch.Tensor       # int32, current exponent bitlength
    turn: torch.Tensor        # int32; even -> next shrink hits the mantissa
    step: torch.Tensor        # int32
    hold_until: torch.Tensor  # int32


def bitwave_init(cfg: BitWaveConfig, device=None) -> BitWaveState:
    return BitWaveState(mavg=_f32(0.0, device), err_ema=_f32(0.0, device),
                        n_man=_i32(cfg.max_man_bits, device),
                        n_exp=_i32(cfg.max_exp_bits, device),
                        turn=_i32(0, device), step=_i32(0, device),
                        hold_until=_i32(0, device))


def bitwave_update(state: BitWaveState, loss, cfg: BitWaveConfig,
                   lr_changed: bool = False) -> BitWaveState:
    """One observe/decide step over both bitlengths."""
    mavg, err_ema, decide, shrink, grow = _loss_signal(state, loss, cfg)
    shrink = decide & shrink
    grow = decide & grow

    man_turn = (state.turn % 2) == 0
    n_man = state.n_man - (shrink & man_turn).to(torch.int32)
    n_exp = state.n_exp - (shrink & ~man_turn).to(torch.int32)
    n_man = torch.where(grow, n_man + 1, n_man)
    n_exp = torch.where(grow, n_exp + 1, n_exp)
    n_man = torch.clamp(n_man, cfg.min_man_bits, cfg.max_man_bits)
    n_exp = torch.clamp(n_exp, cfg.min_exp_bits, cfg.max_exp_bits)
    turn = state.turn + shrink.to(torch.int32)

    hold_until = _hold(state, cfg, lr_changed)
    in_hold = state.step < hold_until
    n_man = torch.where(in_hold, cfg.max_man_bits, n_man)
    n_exp = torch.where(in_hold, cfg.max_exp_bits, n_exp)
    return BitWaveState(mavg=mavg, err_ema=err_ema,
                        n_man=n_man.to(torch.int32),
                        n_exp=n_exp.to(torch.int32),
                        turn=turn.to(torch.int32), step=state.step + 1,
                        hold_until=hold_until)


def bitwave_effective(state: BitWaveState, cfg: BitWaveConfig):
    """(man_bits, exp_bits) to apply this step (full precision in holds)."""
    in_hold = state.step < state.hold_until
    man = torch.where(in_hold, cfg.max_man_bits, state.n_man)
    exp = torch.where(in_hold, cfg.max_exp_bits, state.n_exp)
    return man.to(torch.int32), exp.to(torch.int32)
