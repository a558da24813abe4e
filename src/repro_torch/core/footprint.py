"""Bit-exact SFP footprint accounting (the paper's Table I, Figs 12-13).

For a tensor and a container policy, how many bits the paper's
variable-length encoding would write to off-chip memory:

  total = sign_bits + mantissa_bits + gecko(exponent_field)

plus the baselines (FP32, BF16) and the comparison schemes of Fig 13 (JS
zero-skip and GIST++-style sparsity encoding). Counts are host integers,
as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import containers, gecko


@dataclasses.dataclass(frozen=True)
class FootprintReport:
    n_values: int
    sign_bits: int
    mantissa_bits: int
    exponent_bits: int
    metadata_bits: int

    @property
    def total_bits(self) -> int:
        return (self.sign_bits + self.mantissa_bits + self.exponent_bits
                + self.metadata_bits)

    def vs_fp32(self) -> float:
        return self.total_bits / (32.0 * max(self.n_values, 1))

    def vs_bf16(self) -> float:
        return self.total_bits / (16.0 * max(self.n_values, 1))

    def breakdown(self) -> Dict[str, float]:
        t = max(self.total_bits, 1)
        return {
            "sign": self.sign_bits / t,
            "mantissa": self.mantissa_bits / t,
            "exponent": self.exponent_bits / t,
            "metadata": self.metadata_bits / t,
        }


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    """Where ``x`` is not zero, with subnormals counted as zero: the JAX
    package compares with 0 on devices that flush subnormals (the TPU,
    XLA's CPU backend); the exponent field gives the same answer on
    every device."""
    return containers.exponent_field(x) != 0


def _f32_clip(value, lo: float, hi: float) -> float:
    """``value`` (a number or a scalar tensor) as f32, clipped, as a
    Python float: the rounding the JAX package's jnp.clip gives."""
    t = torch.as_tensor(value).detach().to("cpu", torch.float32)
    return float(torch.clamp(t, lo, hi))


def sfp_footprint(x: torch.Tensor, mantissa_bits, *, exp_bits=None,
                  signless: bool = False,
                  gecko_mode: str = "delta") -> FootprintReport:
    """Exact SFP bits of ``x`` stored at ``mantissa_bits`` mantissa bits.

    ``mantissa_bits`` may be an int, a scalar or fractional (Quantum
    Mantissa's expectation: a fractional n costs its expected bits).
    ``exp_bits`` (Quantum Exponent) prices the exponent field at the
    reduced bitlength: the exponents are first clamped to the e-bit range
    (what the policy stores), Gecko compresses the clamped stream, and the
    account takes min(gecko, e * n), the raw reduced-width encoding being
    the fallback when flush-to-zero outliers poison the delta rows. None
    keeps the full exponent. ``signless`` models post-ReLU/softmax tensors
    whose sign bit is elided (§IV-D)."""
    n = x.numel()
    spec = containers.spec_for(x)
    if exp_bits is not None:
        e_clip = _f32_clip(exp_bits, containers.MIN_EXP_BITS, spec.exp_bits)
        e_int = int(-(-e_clip // 1))  # ceil: the realized container range
        exp = containers.exponent_field(
            containers.truncate_exponent(x, e_int))
        ebits = min(int(gecko.compressed_bits(exp, mode=gecko_mode)),
                    int(round(e_clip * n)))
    else:
        exp = containers.exponent_field(x)
        ebits = int(gecko.compressed_bits(exp, mode=gecko_mode))
    mbits = _f32_clip(mantissa_bits, 0, spec.man_bits) * n
    return FootprintReport(
        n_values=n,
        sign_bits=0 if signless else n,
        mantissa_bits=int(round(mbits)),
        exponent_bits=ebits,
        metadata_bits=0,  # bitlength metadata: a few scalars per layer
    )


def sfp_js_footprint(x: torch.Tensor, mantissa_bits, *,
                     signless: bool = False,
                     gecko_mode: str = "delta") -> FootprintReport:
    """SFP combined with JS zero-skip (paper §VI-B): one tag bit per
    value, containers only for the nonzeros (ReLU zeros would otherwise
    poison the Gecko delta rows with exponent-0 outliers)."""
    n = x.numel()
    flat = x.reshape(-1)
    exp = containers.exponent_field(flat)
    nz_mask = exp != 0        # as _nonzero: subnormals count as zero
    nnz = int(torch.sum(nz_mask))
    # Zeros take the bias exponent and sort next to each other: the same
    # group count as the JAX package, a slightly conservative estimate.
    exp_nz = torch.where(nz_mask, exp, 127).to(torch.uint8)
    nz_sorted = torch.sort(exp_nz).values
    ebits = int(gecko.compressed_bits(nz_sorted, mode=gecko_mode))
    ebits = int(ebits * (nnz / max(n, 1)))
    mbits = _f32_clip(mantissa_bits, 0, containers.spec_for(x).man_bits) * nnz
    return FootprintReport(
        n_values=n,
        sign_bits=0 if signless else nnz,
        mantissa_bits=int(round(mbits)),
        exponent_bits=ebits,
        metadata_bits=n,  # one zero-tag bit per value
    )


def baseline_bits(x: torch.Tensor, fmt: str) -> int:
    return {"fp32": 32, "bf16": 16, "fp16": 16}[fmt] * x.numel()


def js_bits(x: torch.Tensor, base_bits: int = 16) -> int:
    """JS: sparse zero-skip with one extra bit per value (Fig 13)."""
    return x.numel() + int(torch.sum(_nonzero(x))) * base_bits


def gist_bits(x: torch.Tensor, base_bits: int = 16, *,
              relu_pool: bool = False) -> int:
    """GIST++-style: ReLU-pool tensors cost 1 bit per value; otherwise
    sparsity encoding only where it shrinks the footprint."""
    if relu_pool:
        return x.numel()
    return min(baseline_bits(x, "bf16" if base_bits == 16 else "fp32"),
               js_bits(x, base_bits))


def container_realized_bits(x: torch.Tensor, container: str) -> int:
    """Byte-aligned container sizes: the uncompressed baselines here, the
    realized containers through the codec registry."""
    baseline = {"bf16": 16, "fp16": 16, "fp32": 32}
    if container in baseline:
        return x.numel() * baseline[container]
    from repro_torch import codecs  # local: codecs account through here
    return int(codecs.get(container).packed_bits(x))


def container_realized_report(x: torch.Tensor, container: str
                              ) -> FootprintReport:
    """Realized container footprint with a field-level breakdown.

    Prices what the packed arrays occupy, so ``total_bits ==
    codecs.get(container).packed_bits(x)``: for SFP geometries the sign,
    mantissa and delta-exponent planes go to their fields (each plane is
    ``padded_n`` real bits, the tail padded to 128 lanes) and the 8-bit
    group bases, with any fixed-lane slack, to ``metadata_bits``. Codecs
    without a fixed payload geometry report their whole realized stream as
    ``exponent_bits``."""
    from repro_torch import codecs  # local: codecs account through here

    n = x.numel()
    codec = codecs.get(container)
    fields = codec.pack_fields(x.dtype)
    total = int(codec.packed_bits(x))
    if fields is None:
        return FootprintReport(n_values=n, sign_bits=0, mantissa_bits=0,
                               exponent_bits=total, metadata_bits=0)
    padded_n = -(-n // 128) * 128
    return FootprintReport(
        n_values=n,
        sign_bits=padded_n,
        mantissa_bits=padded_n * fields.man_keep,
        exponent_bits=padded_n * fields.dexp_bits,
        metadata_bits=total - padded_n * (1 + fields.man_keep
                                          + fields.dexp_bits),
    )
