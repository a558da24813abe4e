"""SFP container codecs with fixed-lane words.

  sfp8   byte = sign<<7 | dexp4<<3 | man3            (bf16-range payload)
  sfp16  word = sign<<15 | dexp5<<10 | manK<<(10-K)  (K=10 f32 / 7 bf16)

One shared 8-bit base exponent per 128-lane group. ``pack(x, bits)``
uses the fused quantize+pack kernel: the Quantum Mantissa truncation and
the container encoding happen in one pass over the tensor. The dense
bit-plane family ``sfp-m{K}e{E}`` and the fixed-lane
``sfp{8|16}-m{K}e{E}`` family are not ported yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch.codecs import base
from repro_torch.core import containers
from repro_torch.kernels import ops
from repro_torch.kernels.ref import GROUP, PackFields

SFP8 = "sfp8"
SFP16 = "sfp16"


def fields_for(name: str, dtype_or_spec) -> PackFields:
    """Resolve a container name + source dtype to its payload geometry."""
    spec = (dtype_or_spec if isinstance(dtype_or_spec, containers.FloatSpec)
            else containers.spec_for(dtype_or_spec))
    if name == SFP8:
        return PackFields(man_keep=3, dexp_bits=4, payload_bits=8)
    if name == SFP16:
        man_keep = 10 if spec.man_bits == 23 else 7
        return PackFields(man_keep=man_keep, dexp_bits=5, payload_bits=16)
    raise ValueError(f"not a ported SFP container: {name!r}")


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
        of the quantization signal ``bits``."""
        f = self.pack_fields(x.dtype)
        n = int(math.prod(x.shape)) if x.shape else 1
        if _nd_layout(x.shape):
            groups, payload_vals = n // GROUP, n
        else:
            groups = -(-n // GROUP)
            payload_vals = groups * GROUP
        return float(payload_vals * f.payload_bits + groups * 8)
