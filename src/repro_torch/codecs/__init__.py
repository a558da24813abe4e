"""Container codecs of the port (see base.py for the contract).

    codec = codecs.get("sfp8")
    packed = codec.pack(x)
    x_q = codec.unpack(packed)

Ported: sfp8, sfp16 and bit_exact. ``gecko8`` and the parametric
``sfp-m{K}e{E}`` / ``sfp{8|16}-m{K}e{E}`` families raise a "not yet
ported" error.
"""
from repro_torch.codecs.base import (Codec, NotYetPorted, PackedTensor, get,
                                     names, register, validate_name)
from repro_torch.codecs.bit_exact import BIT_EXACT, BitExactCodec
from repro_torch.codecs.sfp import SFP8, SFP16, SFPCodec, fields_for

DEFAULT_CONTAINER = SFP8

register(SFPCodec(SFP8))
register(SFPCodec(SFP16))
register(BitExactCodec())

__all__ = [
    "Codec", "NotYetPorted", "PackedTensor", "get", "names", "register",
    "validate_name", "fields_for", "DEFAULT_CONTAINER", "SFP8", "SFP16",
    "SFPCodec", "BIT_EXACT", "BitExactCodec",
]
