"""bit_exact codec: fake-quant accounting mode.

The payload is the (mantissa-truncated) tensor in its own dtype; no
repacking happens on the device. The quantizer runs for real (the
``mantissa_quantize`` kernel on the card), so accuracy effects are
faithful. Its footprint is what the paper's variable-length encoding
would write: sign + kept mantissa + Gecko-compressed exponents
(``core/footprint.py``).
"""
from __future__ import annotations

import torch

from repro_torch.codecs import base
from repro_torch.core import containers, footprint
from repro_torch.kernels import ops

BIT_EXACT = "bit_exact"


class BitExactCodec(base.Codec):
    name = BIT_EXACT

    def pack(self, x: torch.Tensor, bits=None) -> base.PackedTensor:
        q = x if bits is None else ops.mantissa_quantize(x, bits)
        return base.PackedTensor(self.name, x.shape, x.dtype, {"payload": q})

    def unpack(self, packed: base.PackedTensor) -> torch.Tensor:
        return packed.data["payload"]

    def lossless_for(self, dtype) -> bool:
        return True  # the bits=None pack is the identity

    def packed_bits(self, x: torch.Tensor, bits=None) -> float:
        """The paper's variable-length footprint: sign, the kept mantissa
        bits and the Gecko-compressed exponents."""
        n = containers.spec_for(x).man_bits if bits is None else bits
        return float(footprint.sfp_footprint(x, n).total_bits)
