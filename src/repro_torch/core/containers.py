"""Floating-point container fields for bf16 and f32.

Bit math runs in int32 (int64 where a 32-bit word is rebuilt): CPU torch
has no shifts on uint16/uint32. Splitting and combining are exact
reinterpretations, so every payload the port packs is bit-for-bit the
JAX package's. Mantissa truncation masks the signed integer view of the
float with the same bits; exponent truncation (Quantum Exponent) flushes
and saturates the exponent field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class FloatSpec:
    """Static description of an IEEE-ish floating point container."""

    name: str
    dtype: torch.dtype
    int_dtype: torch.dtype    # signed integer of the same width (for views)
    total_bits: int
    exp_bits: int
    man_bits: int
    bias: int

    @property
    def sign_shift(self) -> int:
        return self.total_bits - 1

    @property
    def exp_shift(self) -> int:
        return self.man_bits

    @property
    def exp_mask(self) -> int:
        return (1 << self.exp_bits) - 1

    @property
    def man_mask(self) -> int:
        return (1 << self.man_bits) - 1


FP32 = FloatSpec("fp32", torch.float32, torch.int32, 32, 8, 23, 127)
BF16 = FloatSpec("bf16", torch.bfloat16, torch.int16, 16, 8, 7, 127)

_SPECS = {s.dtype: s for s in (FP32, BF16)}


def spec_for(x) -> FloatSpec:
    dtype = x.dtype if isinstance(x, torch.Tensor) else x
    try:
        return _SPECS[dtype]
    except KeyError as e:
        raise ValueError(f"No FloatSpec for dtype {dtype}") from e


def _word(x: torch.Tensor, spec: FloatSpec) -> torch.Tensor:
    """The float's bit pattern as a non-negative int64 (f32) or int32."""
    u = x.view(spec.int_dtype)
    if spec.total_bits == 32:
        return u.to(torch.int64) & 0xFFFFFFFF
    return u.to(torch.int32) & 0xFFFF


def split_fields(x: torch.Tensor):
    """Split into (sign, biased_exponent, mantissa) int32 fields."""
    spec = spec_for(x)
    u = _word(x, spec)
    sign = ((u >> spec.sign_shift) & 1).to(torch.int32)
    exp = ((u >> spec.exp_shift) & spec.exp_mask).to(torch.int32)
    man = (u & spec.man_mask).to(torch.int32)
    return sign, exp, man


def combine_fields(sign: torch.Tensor, exp: torch.Tensor, man: torch.Tensor,
                   spec: FloatSpec) -> torch.Tensor:
    u = ((sign.to(torch.int64) << spec.sign_shift)
         | ((exp.to(torch.int64) & spec.exp_mask) << spec.exp_shift)
         | (man.to(torch.int64) & spec.man_mask))
    return _signed(u, spec).view(spec.dtype)


def _signed(u: torch.Tensor, spec: FloatSpec) -> torch.Tensor:
    """A non-negative int64 word as the signed integer view of ``spec``."""
    half = 1 << (spec.total_bits - 1)
    return torch.where(u >= half, u - (half << 1), u).to(spec.int_dtype)


def mantissa_keep_mask(n, spec: FloatSpec, device=None) -> torch.Tensor:
    """Bitmask (int64) keeping the top ``n`` mantissa bits, ``n`` clamped
    to [0, man_bits]; ``man_mask ^ (2^(m-n) - 1)`` as in the JAX package.
    ``n`` may be an int or an integer tensor."""
    n = torch.as_tensor(n, device=device).to(torch.int64)
    n = torch.clamp(n, 0, spec.man_bits)
    low = torch.bitwise_left_shift(torch.ones_like(n), spec.man_bits - n) - 1
    return spec.man_mask ^ low


def truncate_mantissa(x: torch.Tensor, n) -> torch.Tensor:
    """Q(M, n): zero all but the top ``n`` mantissa bits (paper eq. 5).

    ``n`` is an int or an integer tensor (a 0-d tensor keeps a bitlength
    drawn on the device there). Not differentiable: see
    ``core.quantum_mantissa.qm_quantize`` for the estimator."""
    spec = spec_for(x)
    keep = mantissa_keep_mask(n, spec, x.device)
    full = (1 << spec.total_bits) - 1
    mask = _signed((full & ~spec.man_mask) | keep, spec)
    return torch.bitwise_and(x.view(spec.int_dtype), mask).view(spec.dtype)


def stochastic_bitlength(n_float: torch.Tensor, generator: torch.Generator,
                         max_bits: int, min_bits: int = 0,
                         shape: Optional[Sequence[int]] = None
                         ) -> torch.Tensor:
    """Eq. (6): floor(n) + Bernoulli(frac(n)), clipped to [min_bits,
    max_bits], as int32 on ``n_float``'s device.

    The Bernoulli draw is ``u < frac(n)`` with ``u`` uniform from
    ``generator`` (the JAX package draws ``jax.random.bernoulli``; the two
    streams differ, the distribution is the same). ``min_bits`` is 0 for
    mantissas; Quantum Exponent clamps to ``MIN_EXP_BITS``. ``shape`` draws
    that many independent bitlengths from the one parameter (default: one,
    the shape of ``n_float``)."""
    nf = torch.clamp(n_float.detach().to(torch.float32), float(min_bits),
                     float(max_bits))
    floor_n = torch.floor(nf)
    frac = nf - floor_n
    shape = tuple(nf.shape) if shape is None else tuple(shape)
    u = torch.rand(shape, generator=generator, device=nf.device)
    bump = (u < frac).to(torch.int32)
    return torch.clamp(floor_n.to(torch.int32) + bump, min_bits, max_bits)


MIN_EXP_BITS = 2  # a 1-bit IEEE-style exponent field has no normal codes


def exponent_range(e, spec: FloatSpec, device=None):
    """Unbiased normal-exponent range [lo, hi] (int32) of an ``e``-bit
    container: biased codes 1..2^e-2 with bias 2^(e-1)-1, so
    [2 - 2^(e-1), 2^(e-1) - 1]. ``e`` (int or integer tensor) is clipped to
    [MIN_EXP_BITS, spec.exp_bits]."""
    e = torch.as_tensor(e, device=device).to(torch.int32)
    e = torch.clamp(e, MIN_EXP_BITS, spec.exp_bits)
    one = torch.ones_like(e)
    bias_e = torch.bitwise_left_shift(one, e - 1) - 1
    lo = 1 - bias_e
    hi = (torch.bitwise_left_shift(one, e) - 2) - bias_e
    return lo, hi


def truncate_exponent(x: torch.Tensor, e, bias_offset=0) -> torch.Tensor:
    """Clamp ``x`` to the exponent range of an ``e``-bit container.

    Values below the e-bit normal range flush to signed zero (as do the
    source's own zeros and subnormals), values above it saturate to the
    largest in-range binade (exponent clamped, mantissa kept), inf/nan
    pass through. ``e`` is an int or an integer tensor (a 0-d tensor keeps
    a draw on the device), clipped to [MIN_EXP_BITS, spec.exp_bits]; at
    e == exp_bits only source subnormals flush.

    ``bias_offset`` shifts the window by that many binades (AdaptivFloat's
    per-tensor exponent bias: positive spends the e-bit range on larger
    magnitudes, negative on smaller), clipped to the source's own normal
    range. It is an int or a 0-d integer tensor on x's device, so a
    learned offset never syncs with the host; an int 0 leaves the window
    where it is. Not differentiable: see ``core.quantum_exponent.
    qe_quantize`` and ``policies/afloat.py``."""
    spec = spec_for(x)
    sign, exp, man = split_fields(x)
    lo, hi = exponent_range(e, spec, x.device)
    if not (isinstance(bias_offset, int) and bias_offset == 0):
        b = torch.as_tensor(bias_offset, device=x.device).to(torch.int32)
        src_lo, src_hi = 1 - spec.bias, (spec.exp_mask - 1) - spec.bias
        lo = torch.clamp(lo + b, src_lo, src_hi)
        hi = torch.clamp(hi + b, src_lo, src_hi)
    unb = exp - spec.bias
    special = exp == spec.exp_mask          # inf / nan: keep verbatim
    underflow = (~special) & (unb < lo)     # incl. exp == 0
    overflow = (~special) & (unb > hi)
    exp_new = torch.where(overflow, (hi + spec.bias).to(torch.int32), exp)
    exp_new = torch.where(underflow, torch.zeros_like(exp), exp_new)
    man_new = torch.where(underflow, torch.zeros_like(man), man)
    return combine_fields(sign, exp_new, man_new, spec)


def exponent_field(x: torch.Tensor) -> torch.Tensor:
    """The biased exponent field as uint8 (Gecko's input)."""
    _, exp, _ = split_fields(x)
    return exp.to(torch.uint8)
