"""Gecko: lossless exponent compression (paper §IV-C), bit accounting.

Training exponents concentrate tightly around the bias (127). Gecko stores
each exponent with only as many bits as its magnitude needs, amortizing
the width metadata over groups:

Delta mode (the paper's primary scheme):
  * values are grouped 64 at a time, viewed as an 8x8 matrix;
  * each of the 8 columns stores an 8-bit base exponent, its row-0 value;
  * rows 1..7 store sign+magnitude deltas against the column bases;
  * each delta row carries one 3-bit width field sized by the row's
    largest magnitude: a row whose max |delta| needs k bits costs
    3 + 8 (k + 1) bits, or just the 3-bit field when every delta is 0.

Bias mode (the paper's alternative):
  * a fixed bias (127) is subtracted from every exponent;
  * values are grouped 8 at a time with one 3-bit width field per group.

Both encoders are invertible bit for bit and count exact bits without
building a bitstream; the counts are summed in f32, as in the JAX package
(its bit counts overflow int32 for multi-GB tensors). The byte-aligned
realization is the ``gecko8`` codec (``codecs/gecko.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

DELTA_GROUP = (8, 8)  # (rows, cols): 64 exponents per group
BIAS_GROUP = 8
DEFAULT_BIAS = 127


def _bitwidth(x: torch.Tensor) -> torch.Tensor:
    """Bits needed for the unsigned magnitude x (0 -> 0 bits), exact for
    x < 2^9 (only x <= 255 occurs)."""
    x = x.to(torch.int32)
    w = torch.zeros_like(x)
    for b in range(8, -1, -1):  # 255 needs 8 bits
        w = torch.where((x >> b) > 0, torch.clamp(w, min=b + 1), w)
    return w


class GeckoDelta(NamedTuple):
    """Delta-mode encoding (lossless); the bit accounting is separate."""

    bases: torch.Tensor       # (G, 8) uint8 column bases (row 0)
    deltas: torch.Tensor      # (G, 7, 8) int16 row deltas vs column base
    row_widths: torch.Tensor  # (G, 7) int32 magnitude bits per row
    n_values: int             # element count before padding


class GeckoBias(NamedTuple):
    deltas: torch.Tensor        # (G, 8) int16 value - bias
    group_widths: torch.Tensor  # (G,) int32
    bias: int
    n_values: int


def _pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Edge-replicate the tail to a multiple: repeating the last exponent
    keeps the padded deltas at zero cost."""
    rem = (-x.shape[0]) % multiple
    if rem:
        x = torch.cat([x, x[-1:].expand(rem)])
    return x


def _flat_u8(exponents: torch.Tensor) -> torch.Tensor:
    return exponents.reshape(-1).to(torch.uint8)


def encode_delta(exponents: torch.Tensor) -> GeckoDelta:
    """Encode a uint8 exponent stream (any shape, flattened) with the 8x8
    delta scheme."""
    e = _pad_to(_flat_u8(exponents), 64)
    g = e.reshape(-1, 8, 8).to(torch.int16)  # (G, row, col)
    bases = g[:, 0, :]
    deltas = g[:, 1:, :] - bases[:, None, :]
    row_max = torch.amax(torch.abs(deltas), dim=2)  # (G, 7)
    return GeckoDelta(bases=bases.to(torch.uint8), deltas=deltas,
                      row_widths=_bitwidth(row_max),
                      n_values=exponents.numel())


def decode_delta(enc: GeckoDelta) -> torch.Tensor:
    g0 = enc.bases.to(torch.int16)[:, None, :]
    full = torch.cat([g0, enc.deltas + g0], dim=1)  # (G, 8, 8)
    return full.reshape(-1).to(torch.uint8)[:enc.n_values]


def delta_bits(enc: GeckoDelta) -> torch.Tensor:
    """Exact compressed size in bits (metadata + payload), padded groups
    included, as an f32 scalar."""
    per_row = torch.where(enc.row_widths > 0,
                          3 + 8 * (enc.row_widths + 1), 3)
    bases_bits = enc.bases.shape[0] * 8 * 8  # 8 bases x 8 bits per group
    return (torch.tensor(bases_bits, dtype=torch.float32,
                         device=per_row.device)
            + torch.sum(per_row.to(torch.float32)))


def encode_bias(exponents: torch.Tensor, bias: int = DEFAULT_BIAS
                ) -> GeckoBias:
    e = _pad_to(_flat_u8(exponents), BIAS_GROUP)
    d = (e.to(torch.int16) - bias).reshape(-1, BIAS_GROUP)
    widths = _bitwidth(torch.amax(torch.abs(d), dim=1))
    return GeckoBias(deltas=d, group_widths=widths, bias=bias,
                     n_values=exponents.numel())


def decode_bias(enc: GeckoBias) -> torch.Tensor:
    flat = (enc.deltas + enc.bias).reshape(-1).to(torch.uint8)
    return flat[:enc.n_values]


def bias_bits(enc: GeckoBias) -> torch.Tensor:
    per_group = torch.where(enc.group_widths > 0,
                            3 + BIAS_GROUP * (enc.group_widths + 1), 3)
    return torch.sum(per_group.to(torch.float32))


# ---------------------------------------------------------------------------
# Accounting entry points.
# ---------------------------------------------------------------------------


def compressed_bits(exponents: torch.Tensor, mode: str = "delta",
                    bias: int = DEFAULT_BIAS) -> torch.Tensor:
    """Exact Gecko-compressed size of a uint8 exponent stream, in bits
    (an f32 scalar)."""
    if mode == "delta":
        return delta_bits(encode_delta(exponents))
    if mode == "bias":
        return bias_bits(encode_bias(exponents, bias))
    raise ValueError(f"unknown gecko mode: {mode}")


def compression_ratio(exponents: torch.Tensor, mode: str = "delta",
                      bias: int = DEFAULT_BIAS) -> torch.Tensor:
    """(M + C) / O as in the paper: metadata plus compressed bits over the
    original 8 bits per value."""
    comp = compressed_bits(exponents, mode, bias)
    return comp / torch.tensor(exponents.numel() * 8, dtype=torch.float32,
                               device=comp.device)


def per_value_bits(exponents: torch.Tensor, mode: str = "delta",
                   bias: int = DEFAULT_BIAS) -> torch.Tensor:
    """Encoded bitlength of each value's exponent (the paper's Fig 10
    CDF): row-0 bases count 8 bits in delta mode, delta values the
    sign+magnitude of their row (or group) width."""
    if mode == "delta":
        enc = encode_delta(exponents)
        g = enc.bases.shape[0]
        base_bits = torch.full((g, 1, 8), 8, dtype=torch.int32,
                               device=enc.bases.device)
        row_bits = torch.where(enc.row_widths > 0, enc.row_widths + 1, 0)
        rest_bits = row_bits[:, :, None].expand(g, 7, 8)
        bits = torch.cat([base_bits, rest_bits], dim=1).reshape(-1)
        return bits[:enc.n_values]
    if mode == "bias":
        enc = encode_bias(exponents, bias)
        per_group = torch.where(enc.group_widths > 0,
                                enc.group_widths + 1, 0)
        bits = per_group[:, None].expand(-1, BIAS_GROUP).reshape(-1)
        return bits[:enc.n_values]
    raise ValueError(f"unknown gecko mode: {mode}")
