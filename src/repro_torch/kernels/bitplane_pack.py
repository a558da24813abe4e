"""Dense bit-plane SFP pack, fused quantize+pack and unpack: CUDA kernel
wrappers and their plain versions.

Replace the TPU kernels ``src/repro/kernels/bitplane_pack.py:
bitplane_pack``, ``bitplane_quantize_pack`` and ``bitplane_unpack``. The
kernels are in ``csrc/bitplane_pack.cu``: a thread per 8 lanes, two bf16
values encoded or decoded a register, the thread's plane bytes by one
8x8 register bit transpose (two when P > 8), tiles of 16 or 32 rows
staged in shared memory and moved by 16-byte stores and copies; ``n`` read
from device memory. ``ref.bitplane_{pack,unpack}_swar`` mirror them step
for step. All three are bound by memory on the H100: 2 B per bf16 value
one way, P/8 B of planes plus 1/128 B of base the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import PackFields
from repro_torch.kernels.sfp_pack import _pack, _unpack

plain = ref.bitplane_pack_rows       # with n=: the fused pack's plain version
plain_unpack = ref.bitplane_unpack_rows


def bitplane_pack(x: torch.Tensor, fields: PackFields):
    """Pack (R, 128) bf16/f32 rows -> (planes (R, P*16) uint8, bases (R, 1)
    uint8). A CPU tensor takes the plain version; any other tensor
    launches the CUDA kernel or raises."""
    if x.device.type == "cpu":
        return plain(x, fields)
    out = _pack("bitplane_pack", x, fields, dense=True)
    bitplane_pack.launches += 1
    return out


def bitplane_quantize_pack(x: torch.Tensor, n, fields: PackFields):
    """Q(M, n) fused into the dense pack (``n`` an int or a 0-d integer
    tensor on x's device, clamped to [0, man_bits])."""
    if x.device.type == "cpu":
        return plain(x, fields, n)
    out = _pack("bitplane_quantize_pack", x, fields, n, dense=True)
    bitplane_quantize_pack.launches += 1
    return out


def bitplane_unpack(planes: torch.Tensor, bases: torch.Tensor, dtype,
                    fields: PackFields) -> torch.Tensor:
    """(R, P*16) uint8 planes + (R, 1) uint8 bases -> (R, 128) floats of
    ``dtype`` (bf16 or f32)."""
    if planes.device.type == "cpu":
        return plain_unpack(planes, bases, dtype, fields)
    out = _unpack("bitplane_unpack", planes, bases, dtype, fields,
                  dense=True)
    bitplane_unpack.launches += 1
    return out


bitplane_pack.launches = 0
bitplane_quantize_pack.launches = 0
bitplane_unpack.launches = 0
