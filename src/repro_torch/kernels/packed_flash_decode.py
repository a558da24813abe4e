"""Fused decompress-attend decode: CUDA kernel wrapper and plain version.

Replaces the TPU kernel ``src/repro/kernels/packed_flash_decode.py:
packed_flash_decode`` over a contiguous cache, for fixed-lane words
(``packed_flash_decode``) and dense bit planes
(``packed_flash_decode_dense``); the ``prefix_planes`` draft mode is not
ported yet. The kernel is ``csrc/packed_flash_decode.cu``: one CTA per
(batch row, KV head), packed tiles expanded to words in shared memory and
decoded in registers inside the online softmax; it is bound by memory on
the H100, (D * P / 8 + D / 128) bytes per live slot for K and again for V.
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


def _launch(name: str, q: torch.Tensor, k_payload: torch.Tensor,
            k_bases: torch.Tensor, v_payload: torch.Tensor,
            v_bases: torch.Tensor, pos: torch.Tensor, fields: PackFields,
            window: Optional[int], softcap: Optional[float],
            block_l: int) -> torch.Tensor:
    lib = _lib.load()
    B, one, H, hd = q.shape
    L, G = k_bases.shape[1], k_bases.shape[2]
    D = G * GROUP
    KH = D // hd
    if one != 1 or KH * hd != D or H % KH:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit a cache "
                         f"of {G} groups")
    if not q.is_cuda or q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous bf16 on a CUDA "
                         f"device")
    cols = fields.nd_payload_cols(D)
    for part, t, dt, shape in (
            ("k_payload", k_payload, fields.payload_dtype, (B, L, cols)),
            ("v_payload", v_payload, fields.payload_dtype, (B, L, cols)),
            ("k_bases", k_bases, torch.uint8, (B, L, G)),
            ("v_bases", v_bases, torch.uint8, (B, L, G)),
            ("pos", pos, torch.int32, (B,))):
        if (t.device != q.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {part} must be a contiguous {dt} "
                             f"{shape} tensor on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if hd % 4 or hd > 512 or H // KH > 8:
        raise ValueError(f"{name}: hd={hd}, rep={H // KH} not supported "
                         f"(hd % 4 == 0, hd <= 512, rep <= 8)")
    out = torch.empty_like(q)
    err = lib.packed_flash_decode_launch(
        q.data_ptr(), k_payload.data_ptr(), k_bases.data_ptr(),
        v_payload.data_ptr(), v_bases.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, L, H, KH, hd, G, block_len(L, block_l),
        -1 if window is None else int(window), fields.man_keep,
        fields.dexp_bits, fields.payload_bits, int(fields.dense),
        0.0 if softcap is None else float(softcap), 1.0 / (hd ** 0.5),
        _lib.stream_ptr(q))
    _lib.check(err, name)
    return out


def packed_flash_decode(q: torch.Tensor, k_payload: torch.Tensor,
                        k_bases: torch.Tensor, v_payload: torch.Tensor,
                        v_bases: torch.Tensor, pos: torch.Tensor,
                        fields: PackFields, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        block_l: int = DEFAULT_BLOCK_L) -> torch.Tensor:
    """One-token attention over fixed-lane words: q (B, 1, H, hd), payload
    (B, L, KH*hd) words, bases (B, L, KH*hd // 128) uint8, ``pos`` (B,)
    int32 decode positions; ``window`` not None means an L-slot ring
    buffer. Returns (B, 1, H, hd). A CPU tensor takes the plain version;
    any other tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return plain(q, k_payload, k_bases, v_payload, v_bases, pos, fields,
                     window=window, softcap=softcap, block_l=block_l)
    if fields.dense or fields.payload_bits not in (8, 16):
        raise ValueError(f"packed_flash_decode: fixed-lane words only, got "
                         f"{fields}")
    out = _launch("packed_flash_decode", q, k_payload, k_bases, v_payload,
                  v_bases, pos, fields, window, softcap, block_l)
    packed_flash_decode.launches += 1
    return out


def packed_flash_decode_dense(q: torch.Tensor, k_payload: torch.Tensor,
                              k_bases: torch.Tensor, v_payload: torch.Tensor,
                              v_bases: torch.Tensor, pos: torch.Tensor,
                              fields: PackFields, *,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              block_l: int = DEFAULT_BLOCK_L
                              ) -> torch.Tensor:
    """As ``packed_flash_decode``, over a dense bit-plane cache: payload
    (B, L, G * P * 16) uint8, each slot's bytes ordered (group, plane,
    16)."""
    if q.device.type == "cpu":
        return plain(q, k_payload, k_bases, v_payload, v_bases, pos, fields,
                     window=window, softcap=softcap, block_l=block_l)
    if not fields.dense or not 3 <= fields.payload_bits <= 16:
        raise ValueError(f"packed_flash_decode_dense: dense bit planes "
                         f"only, got {fields}")
    out = _launch("packed_flash_decode_dense", q, k_payload, k_bases,
                  v_payload, v_bases, pos, fields, window, softcap, block_l)
    packed_flash_decode_dense.launches += 1
    return out


packed_flash_decode.launches = 0
packed_flash_decode_dense.launches = 0
