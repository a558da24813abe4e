"""Fixed-lane SFP pack: CUDA kernel wrapper and its plain version.

Replaces the TPU kernel ``src/repro/kernels/sfp_pack.py:sfp_pack``. The
kernel is ``csrc/sfp_pack.cu`` (one warp per 128-lane group, base by a
warp max of the exponent field); it is bound by memory on the H100: 2 B
read and ~1.008 B written per bf16 value.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref
from repro_torch.kernels.ref import GROUP, PackFields

plain = ref.sfp_pack_rows


def sfp_pack(x: torch.Tensor, fields: PackFields):
    """Pack (R, 128) bf16/f32 rows -> (payload (R, 128) uint8|uint16,
    bases (R, 1) uint8). A CPU tensor takes the plain version; any other
    tensor launches the CUDA kernel or raises."""
    if x.device.type == "cpu":
        return plain(x, fields)
    lib = _lib.load()
    if not x.is_cuda:
        raise ValueError(f"sfp_pack needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"sfp_pack takes bf16 or f32, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != GROUP or not x.is_contiguous():
        raise ValueError(f"sfp_pack takes contiguous (R, {GROUP}) rows, got "
                         f"{tuple(x.shape)}")
    if fields.dense or fields.payload_bits not in (8, 16):
        raise ValueError(f"sfp_pack packs fixed-lane 8/16-bit words, got "
                         f"{fields}")
    if x.data_ptr() % 16:
        raise ValueError("sfp_pack needs a 16-byte aligned input")
    R = x.shape[0]
    payload = torch.empty((R, GROUP), dtype=fields.word_dtype,
                          device=x.device)
    bases = torch.empty((R, 1), dtype=torch.uint8, device=x.device)
    err = lib.sfp_pack_launch(
        x.data_ptr(), payload.data_ptr(), bases.data_ptr(), R,
        32 if x.dtype == torch.float32 else 16, fields.man_keep,
        fields.dexp_bits, fields.payload_bits, _lib.stream_ptr(x))
    _lib.check(err, "sfp_pack")
    sfp_pack.launches += 1
    return payload, bases


sfp_pack.launches = 0
