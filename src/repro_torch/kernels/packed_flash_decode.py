"""Fused decompress-attend decode: CUDA kernel wrapper and plain version.

Replaces the TPU kernel ``src/repro/kernels/packed_flash_decode.py:
packed_flash_decode`` for fixed-lane words over a contiguous cache (the
dense bit-plane branch and the ``prefix_planes`` draft mode are not ported
yet). The kernel is ``csrc/packed_flash_decode.cu``: one CTA per (batch
row, KV head), packed tiles expanded in registers inside the online
softmax; it is bound by memory on the H100, (D + D/128) bytes per live
slot for K and again for V.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref
from repro_torch.kernels.ref import GROUP, PackFields

DEFAULT_BLOCK_L = 128


def block_len(L: int, block_l: int = DEFAULT_BLOCK_L) -> int:
    """The KV tile: ``block_l`` shrunk to a divisor of L (the cache is
    never padded; padding would copy it every step)."""
    bl = min(block_l, L)
    while L % bl:
        bl -= 1
    return bl


def plain(q, k_payload, k_bases, v_payload, v_bases, pos,
          fields: PackFields, *, window: Optional[int] = None,
          softcap: Optional[float] = None,
          block_l: int = DEFAULT_BLOCK_L) -> torch.Tensor:
    return ref.packed_flash_decode(q, k_payload, k_bases, v_payload, v_bases,
                                   pos, fields, window=window,
                                   softcap=softcap, block_l=block_l)


def packed_flash_decode(q: torch.Tensor, k_payload: torch.Tensor,
                        k_bases: torch.Tensor, v_payload: torch.Tensor,
                        v_bases: torch.Tensor, pos: torch.Tensor,
                        fields: PackFields, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        block_l: int = DEFAULT_BLOCK_L) -> torch.Tensor:
    """One-token attention: q (B, 1, H, hd), payload (B, L, KH*hd) words,
    bases (B, L, KH*hd // 128) uint8, ``pos`` (B,) int32 decode positions;
    ``window`` not None means an L-slot ring buffer. Returns (B, 1, H, hd).
    A CPU tensor takes the plain version; any other tensor launches the
    kernel or raises."""
    if q.device.type == "cpu":
        return plain(q, k_payload, k_bases, v_payload, v_bases, pos, fields,
                     window=window, softcap=softcap, block_l=block_l)
    lib = _lib.load()
    B, one, H, hd = q.shape
    L, G = k_bases.shape[1], k_bases.shape[2]
    D = G * GROUP
    KH = D // hd
    if one != 1 or KH * hd != D or H % KH:
        raise ValueError(f"packed_flash_decode: q {tuple(q.shape)} does not "
                         f"fit a cache of {G} groups")
    if fields.dense or fields.payload_bits not in (8, 16):
        raise ValueError(f"packed_flash_decode: fixed-lane words only, got "
                         f"{fields}")
    if not q.is_cuda or q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError("packed_flash_decode: q must be contiguous bf16 on "
                         "a CUDA device")
    for name, t, dt, shape in (
            ("k_payload", k_payload, fields.word_dtype, (B, L, D)),
            ("v_payload", v_payload, fields.word_dtype, (B, L, D)),
            ("k_bases", k_bases, torch.uint8, (B, L, G)),
            ("v_bases", v_bases, torch.uint8, (B, L, G)),
            ("pos", pos, torch.int32, (B,))):
        if (t.device != q.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"packed_flash_decode: {name} must be a "
                             f"contiguous {dt} {shape} tensor on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if hd % 4 or hd > 512 or H // KH > 8:
        raise ValueError(f"packed_flash_decode: hd={hd}, rep={H // KH} not "
                         f"supported (hd % 4 == 0, hd <= 512, rep <= 8)")
    out = torch.empty_like(q)
    err = lib.packed_flash_decode_launch(
        q.data_ptr(), k_payload.data_ptr(), k_bases.data_ptr(),
        v_payload.data_ptr(), v_bases.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, L, H, KH, hd, G, block_len(L, block_l),
        -1 if window is None else int(window), fields.man_keep,
        fields.dexp_bits, fields.payload_bits,
        0.0 if softcap is None else float(softcap), 1.0 / (hd ** 0.5),
        _lib.stream_ptr(q))
    _lib.check(err, "packed_flash_decode")
    packed_flash_decode.launches += 1
    return out


packed_flash_decode.launches = 0
