"""Fixed-lane SFP pack, fused quantize+pack and unpack: CUDA kernel
wrappers and their plain versions.

Replace the TPU kernels ``src/repro/kernels/sfp_pack.py:sfp_pack``,
``sfp_quantize_pack`` and ``sfp_unpack``. The kernels are in
``csrc/sfp_pack.cu``: a thread per 8 lanes (16 a row), two bf16 values
encoded or decoded a register at the word's unpadded width and shifted
across its padding bits (one value a register for f32 and for bf16 delta
fields wider than 8 bits), the row base by a half-warp max, one 16-byte
(sfp16) or 8-byte (sfp8) word access a thread and row; tiles of 16 rows,
or 32 above the rows an H100 holds at once; ``n`` read from device
memory. ``ref.sfp_{pack,unpack}_swar`` mirror them step for step. All
three are bound by memory on the H100: 2 B per bf16 value one way, ~1.008
B of payload and base the other. The wrappers of the bit-plane kernels
(``bitplane_pack.py``) share ``_pack`` and ``_unpack``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref
from repro_torch.kernels.ref import GROUP, PackFields

plain = ref.sfp_pack_rows          # with n=: the fused pack's plain version
plain_unpack = ref.sfp_unpack_rows

_FLOAT_BITS = {torch.bfloat16: 16, torch.float32: 32}


def _check_fields(name: str, fields: PackFields, dense: bool = False
                  ) -> None:
    """The word kernels take fixed-lane 8/16-bit words, the bit-plane
    kernels (``dense``) dense geometries of 3..16 bits."""
    if dense and (not fields.dense or not 3 <= fields.payload_bits <= 16):
        raise ValueError(f"{name} handles dense bit-plane geometries, got "
                         f"{fields}")
    if not dense and (fields.dense or fields.payload_bits not in (8, 16)):
        raise ValueError(f"{name} handles fixed-lane 8/16-bit words, got "
                         f"{fields}")


def _check_rows(name: str, x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if x.dtype not in _FLOAT_BITS:
        raise ValueError(f"{name} takes bf16 or f32, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != GROUP or not x.is_contiguous():
        raise ValueError(f"{name} takes contiguous (R, {GROUP}) rows, got "
                         f"{tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} needs a 16-byte aligned input")


def device_bits(n, device: torch.device) -> torch.Tensor:
    """A bitlength as the 0-d int32 tensor on ``device`` that a kernel
    reads (a tensor already there is used as it is, with no host sync)."""
    if isinstance(n, torch.Tensor):
        if n.device != device:
            raise ValueError(f"bitlength on {n.device}, tensor on {device}")
        return n.reshape(()).to(torch.int32)
    return torch.tensor(int(n), dtype=torch.int32, device=device)


def _pack(name: str, x: torch.Tensor, fields: PackFields, n=None,
          dense: bool = False):
    """Launch the word pack (or, ``dense``, the bit-plane pack of
    ``csrc/bitplane_pack.cu``) on (R, 128) rows; ``n`` selects the fused
    Q(M, n) launcher. Returns (payload (R, 128) words or (R, P*16) plane
    bytes, bases (R, 1))."""
    lib = _lib.load()
    _check_rows(name, x)
    _check_fields(name, fields, dense)
    R = x.shape[0]
    payload = torch.empty((R, fields.group_payload_bytes), dtype=torch.uint8,
                          device=x.device).view(fields.payload_dtype)
    bases = torch.empty((R, 1), dtype=torch.uint8, device=x.device)
    geometry = (R, _FLOAT_BITS[x.dtype], fields.man_keep, fields.dexp_bits,
                fields.payload_bits, _lib.stream_ptr(x))
    prefix = "bitplane" if dense else "sfp"
    if n is None:
        err = getattr(lib, f"{prefix}_pack_launch")(
            x.data_ptr(), payload.data_ptr(), bases.data_ptr(), *geometry)
    else:
        nd = device_bits(n, x.device)
        err = getattr(lib, f"{prefix}_quantize_pack_launch")(
            x.data_ptr(), nd.data_ptr(), payload.data_ptr(), bases.data_ptr(),
            *geometry)
    _lib.check(err, name)
    return payload, bases


def _unpack(name: str, payload: torch.Tensor, bases: torch.Tensor, dtype,
            fields: PackFields, dense: bool = False) -> torch.Tensor:
    """Launch the word unpack (or, ``dense``, the bit-plane unpack) of
    (R, 128) words or (R, P*16) plane bytes and (R, 1) bases into (R, 128)
    floats of ``dtype``."""
    lib = _lib.load()
    _check_fields(name, fields, dense)
    if dtype not in _FLOAT_BITS:
        raise ValueError(f"{name} writes bf16 or f32, got {dtype}")
    for part, t, want in (("payload", payload, fields.payload_dtype),
                          ("bases", bases, torch.uint8)):
        if not t.is_cuda or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: {part} must be a contiguous {want} "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
    R = payload.shape[0]
    cols = fields.group_payload_bytes // payload.element_size()
    if payload.shape != (R, cols) or bases.shape != (R, 1):
        raise ValueError(f"{name} takes (R, {cols}) payload and (R, 1) "
                         f"bases, got {tuple(payload.shape)} "
                         f"{tuple(bases.shape)}")
    # Both unpacks read a thread's words or planes as 16-byte chunks (sfp8
    # words as 8); every caller's payload is a pack's output or rows of one
    # (128, 256 or P * 16 bytes a row).
    if payload.data_ptr() % 16:
        raise ValueError(f"{name} needs a 16-byte aligned payload")
    out = torch.empty((R, GROUP), dtype=dtype, device=payload.device)
    launch = getattr(lib, ("bitplane" if dense else "sfp") + "_unpack_launch")
    err = launch(payload.data_ptr(), bases.data_ptr(), out.data_ptr(), R,
                 _FLOAT_BITS[dtype], fields.man_keep, fields.dexp_bits,
                 fields.payload_bits, _lib.stream_ptr(payload))
    _lib.check(err, name)
    return out


def sfp_pack(x: torch.Tensor, fields: PackFields):
    """Pack (R, 128) bf16/f32 rows -> (payload (R, 128) uint8|uint16,
    bases (R, 1) uint8). A CPU tensor takes the plain version; any other
    tensor launches the CUDA kernel or raises."""
    if x.device.type == "cpu":
        return plain(x, fields)
    out = _pack("sfp_pack", x, fields)
    sfp_pack.launches += 1
    return out


def sfp_quantize_pack(x: torch.Tensor, n, fields: PackFields):
    """Q(M, n) fused into the pack: as ``sfp_pack`` after keeping the top
    ``n`` mantissa bits of every value (``n`` an int or a 0-d integer
    tensor on x's device, clamped to [0, man_bits])."""
    if x.device.type == "cpu":
        return plain(x, fields, n)
    out = _pack("sfp_quantize_pack", x, fields, n)
    sfp_quantize_pack.launches += 1
    return out


def sfp_unpack(payload: torch.Tensor, bases: torch.Tensor, dtype,
               fields: PackFields) -> torch.Tensor:
    """(R, 128) payload words + (R, 1) uint8 bases -> (R, 128) floats of
    ``dtype`` (bf16 or f32)."""
    if payload.device.type == "cpu":
        return plain_unpack(payload, bases, dtype, fields)
    out = _unpack("sfp_unpack", payload, bases, dtype, fields)
    sfp_unpack.launches += 1
    return out


sfp_pack.launches = 0
sfp_quantize_pack.launches = 0
sfp_unpack.launches = 0
