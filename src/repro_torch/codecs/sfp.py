"""SFP container codecs: fixed-lane words and dense bit-plane payloads.

  sfp8          byte = sign<<7 | dexp4<<3 | man3           (bf16 range)
  sfp16         word = sign<<15 | dexp5<<10 | manK<<(10-K) (K=10 f32 / 7 bf16)
  sfp-m{K}e{E}  dense payload of P = 1 + E + K bits per value (3..16),
                stored as P byte-aligned bit planes per 128-lane group
  sfp{8|16}-m{K}e{E}  the legacy fixed-lane family (an 8/16-bit word)

One shared 8-bit base exponent per 128-lane group. ``pack(x, bits)``
uses the fused quantize+pack kernel: the Quantum Mantissa truncation and
the container encoding happen in one pass over the tensor. Parametric
names resolve through the codec factory (``maybe_codec``); a dense budget
that lands on a lane width (P = 8 or 16) keeps the fixed-lane words.
"""
from __future__ import annotations

import math
import re

import torch

from repro_torch.codecs import base
from repro_torch.core import containers
from repro_torch.kernels import ops
from repro_torch.kernels.ref import GROUP, PackFields

SFP8 = "sfp8"
SFP16 = "sfp16"

_PARAM_NAME = re.compile(r"sfp(8|16)-m(\d+)e(\d+)$")
_DENSE_NAME = re.compile(r"sfp-m(\d+)e(\d+)$")

MIN_PAYLOAD_BITS = 3   # sign + 1 dexp + 1 mantissa
MAX_PAYLOAD_BITS = 16


def dense_fields(man: int, dexp: int, spec: containers.FloatSpec
                 ) -> PackFields:
    """Dense geometry for a (mantissa, delta-exponent) bit budget, clamped
    to what a <= 16-bit payload and the source dtype hold; the payload is
    1 + dexp + man bits, fixed-lane words when that is 8 or 16."""
    dexp = max(1, min(int(dexp), 8))
    man = max(1, min(int(man), spec.man_bits, MAX_PAYLOAD_BITS - 1 - dexp))
    payload = 1 + dexp + man
    if not MIN_PAYLOAD_BITS <= payload <= MAX_PAYLOAD_BITS:
        raise ValueError(f"payload of {payload} bits")
    return PackFields(man_keep=man, dexp_bits=dexp, payload_bits=payload,
                      dense=payload not in (8, 16))


def dense_name(man_bits: float, exp_bits: float) -> str:
    """The dense container of a (possibly fractional) learned decision:
    bitlengths round up (a fractional bit cannot be stored), the
    delta-exponent field takes the exponent bitlength clamped to [2, 7]
    (the shared base absorbs the rest of the range)."""
    man = max(1, int(math.ceil(man_bits - 1e-9)))
    dexp = max(2, min(7, int(math.ceil(exp_bits - 1e-9))))
    man = min(man, MAX_PAYLOAD_BITS - 1 - dexp)
    return f"sfp-m{man}e{dexp}"


def fields_for(name: str, dtype_or_spec) -> PackFields:
    """Resolve a container name + source dtype to its payload geometry."""
    spec = (dtype_or_spec if isinstance(dtype_or_spec, containers.FloatSpec)
            else containers.spec_for(dtype_or_spec))
    if name == SFP8:
        return PackFields(man_keep=3, dexp_bits=4, payload_bits=8)
    if name == SFP16:
        man_keep = 10 if spec.man_bits == 23 else 7
        return PackFields(man_keep=man_keep, dexp_bits=5, payload_bits=16)
    m = _DENSE_NAME.match(name)
    if m:
        man, dexp = (int(g) for g in m.groups())
        return dense_fields(man, dexp, spec)
    m = _PARAM_NAME.match(name)
    if m:
        payload, man, dexp = (int(g) for g in m.groups())
        # The name records the learned decision; the realized geometry
        # never exceeds the word or the source's mantissa.
        dexp = max(1, min(dexp, payload - 2))
        man = max(1, min(man, payload - 1 - dexp, spec.man_bits))
        return PackFields(man_keep=man, dexp_bits=dexp, payload_bits=payload)
    raise ValueError(f"not an SFP container: {name!r}")


def maybe_codec(name: str):
    """Codec factory for the parametric SFP names: the dense
    ``sfp-m{K}e{E}`` family and the fixed-lane ``sfp{8|16}-m{K}e{E}``."""
    if _DENSE_NAME.match(name) or _PARAM_NAME.match(name):
        return SFPCodec(name)
    return None


def _nd_layout(shape) -> bool:
    return len(shape) >= 1 and shape[-1] % GROUP == 0 and shape[-1] > 0


class SFPCodec(base.Codec):
    def __init__(self, name: str):
        self.name = name

    def pack_fields(self, dtype) -> PackFields:
        return fields_for(self.name, dtype)

    def pack(self, x: torch.Tensor, bits=None) -> base.PackedTensor:
        f = self.pack_fields(x.dtype)
        if _nd_layout(x.shape):
            packed = ops.sfp_compress_nd(x, f, n=bits)
        else:
            packed = ops.sfp_quantize_compress(x, bits, f)
        return base.PackedTensor(self.name, x.shape, x.dtype,
                                 {"payload": packed.payload,
                                  "bases": packed.bases})

    def unpack(self, packed: base.PackedTensor) -> torch.Tensor:
        f = self.pack_fields(packed.dtype)
        raw = ops.Packed(payload=packed.data["payload"],
                         bases=packed.data["bases"])
        if _nd_layout(packed.shape):
            return ops.sfp_decompress_nd(raw, packed.dtype, f)
        return ops.sfp_decompress(raw, packed.shape, packed.dtype, f)

    def packed_bits(self, x: torch.Tensor, bits=None) -> float:
        """Realized bytes of pack(x), in bits: fixed-width, so independent
        of the quantization signal ``bits``. The flat layout pads the tail
        to a full 128-lane row, and those lanes occupy real words or plane
        bits (``payload_bits`` is the realized width in both layouts)."""
        f = self.pack_fields(x.dtype)
        n = int(math.prod(x.shape)) if x.shape else 1
        if _nd_layout(x.shape):
            groups, payload_vals = n // GROUP, n
        else:
            groups = -(-n // GROUP)
            payload_vals = groups * GROUP
        return float(payload_vals * f.payload_bits + groups * 8)
