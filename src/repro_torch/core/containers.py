"""Floating-point container fields for bf16 and f32.

Bit math runs in int32 (int64 where a 32-bit word is rebuilt): CPU torch
has no shifts on uint16/uint32. Splitting and combining are exact
reinterpretations, so every payload the port packs is bit-for-bit the
JAX package's.
"""
from __future__ import annotations

import dataclasses

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
    half = 1 << (spec.total_bits - 1)
    u = torch.where(u >= half, u - (half << 1), u)   # two's complement view
    return u.to(spec.int_dtype).view(spec.dtype)
