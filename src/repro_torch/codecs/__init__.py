"""Container codecs of the port (see base.py for the contract).

    codec = codecs.get("sfp8")
    packed = codec.pack(x)
    x_q = codec.unpack(packed)

Ported: sfp8, sfp16, bit_exact, gecko8 (the realized Gecko exponent
stream), and through the factory the dense ``sfp-m{K}e{E}`` and
fixed-lane ``sfp{8|16}-m{K}e{E}`` families: every container of the JAX
package.
"""
from repro_torch.codecs.base import (Codec, PackedTensor, get, names,
                                     register, register_factory,
                                     validate_name)
from repro_torch.codecs.bit_exact import BIT_EXACT, BitExactCodec
from repro_torch.codecs.gecko import GECKO8, Gecko8Codec
from repro_torch.codecs.sfp import (SFP8, SFP16, SFPCodec, dense_fields,
                                    dense_name, fields_for, maybe_codec)

DEFAULT_CONTAINER = SFP8

register(SFPCodec(SFP8))
register(SFPCodec(SFP16))
register(BitExactCodec())
register(Gecko8Codec())
register_factory(maybe_codec)

__all__ = [
    "Codec", "PackedTensor", "get", "names", "register",
    "register_factory", "validate_name", "dense_fields", "dense_name",
    "fields_for", "maybe_codec", "DEFAULT_CONTAINER", "SFP8", "SFP16",
    "SFPCodec", "BIT_EXACT", "BitExactCodec", "GECKO8", "Gecko8Codec",
]
