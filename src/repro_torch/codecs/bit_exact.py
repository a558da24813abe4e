"""bit_exact codec: fake-quant accounting mode.

The payload is the (mantissa-truncated) tensor in its own dtype; no
repacking happens on the device. The quantizer runs for real (the
``mantissa_quantize`` kernel on the card), so accuracy effects are
faithful. Its footprint in the JAX package is the paper's variable-length
model with Gecko-compressed exponents, which waits for the Gecko slice.
"""
from __future__ import annotations

import torch

from repro_torch.codecs import base
from repro_torch.kernels import ops

BIT_EXACT = "bit_exact"


class BitExactCodec(base.Codec):
    name = BIT_EXACT

    def pack(self, x: torch.Tensor, bits=None) -> base.PackedTensor:
        q = x if bits is None else ops.mantissa_quantize(x, bits)
        return base.PackedTensor(self.name, x.shape, x.dtype, {"payload": q})

    def unpack(self, packed: base.PackedTensor) -> torch.Tensor:
        return packed.data["payload"]

    def packed_bits(self, x: torch.Tensor, bits=None) -> float:
        raise base.NotYetPorted("the bit_exact footprint needs Gecko "
                                "exponent compression, not yet ported")
