"""Dispatch between the CUDA kernels and their plain versions.

Every model and serving call goes through here. A CUDA tensor goes to the
kernel (or the kernel's wrapper raises); a CPU tensor goes to the plain
version. ``force_backend("plain")`` is a test hook that sends CUDA tensors
to the plain versions too, so a run on the card can be compared with the
same program without kernels.

The packed representation is a plain (payload, bases) pair.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import packed_flash_decode as _pfd
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sfp_pack as _sp

PackFields = _ref.PackFields
decode_kv_mask = _ref.decode_kv_mask
DECODE_BLOCK_L = _pfd.DEFAULT_BLOCK_L

_FORCED: Optional[str] = None  # None | 'plain'


def force_backend(name: Optional[str]) -> None:
    """Test hook: 'plain' runs the plain versions on every device; None
    restores dispatch by device."""
    global _FORCED
    if name not in (None, "plain"):
        raise ValueError(f"unknown backend {name!r}; use 'plain' or None")
    _FORCED = name


def _kernel(t: torch.Tensor) -> bool:
    return _FORCED is None and t.device.type != "cpu"


class Packed(NamedTuple):
    """SFP-compressed tensor: payload words + per-group uint8 bases."""

    payload: torch.Tensor
    bases: torch.Tensor


# -- SFP containers ----------------------------------------------------------


def sfp_compress_nd(x: torch.Tensor, fields: PackFields) -> Packed:
    """Rank-preserving pack (last dim % 128 == 0): payload has x's shape,
    bases (*x.shape[:-1], D // 128)."""
    if not _kernel(x):
        return Packed(*_ref.sfp_pack_nd(x, fields))
    D = x.shape[-1]
    if D % _ref.GROUP:
        raise ValueError(f"last dim {D} is not a multiple of {_ref.GROUP}")
    payload, bases = _sp.sfp_pack(x.contiguous().reshape(-1, _ref.GROUP),
                                  fields)
    return Packed(payload=payload.reshape(x.shape),
                  bases=bases.reshape(*x.shape[:-1], D // _ref.GROUP))


def sfp_compress(x: torch.Tensor, fields: PackFields) -> Packed:
    """Flat pack over the zero-padded 128-lane rows of the flattened x."""
    rows = _ref.to_rows(x.contiguous())
    if not _kernel(x):
        return Packed(*_ref.sfp_pack_rows(rows, fields))
    return Packed(*_sp.sfp_pack(rows, fields))


def _no_unpack_kernel(t: torch.Tensor) -> None:
    if _kernel(t):
        raise NotImplementedError(
            "the sfp_unpack kernel is not ported yet; the serving path "
            "decompresses inside packed_flash_decode")


def sfp_decompress_nd(packed: Packed, dtype, fields: PackFields
                      ) -> torch.Tensor:
    _no_unpack_kernel(packed.payload)
    return _ref.sfp_unpack_nd(packed.payload, packed.bases, dtype, fields)


def sfp_decompress(packed: Packed, shape: tuple, dtype,
                   fields: PackFields) -> torch.Tensor:
    _no_unpack_kernel(packed.payload)
    return _ref.sfp_unpack(packed.payload, packed.bases, tuple(shape), dtype,
                           fields)


# -- attention ---------------------------------------------------------------


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None) -> torch.Tensor:
    """GQA attention, q (B, Sq, H, D), k/v (B, Sk, KH, D).

    On the kernel route the query head group is folded into the rows
    (row r of the folded axis is position r // rep, group member r % rep),
    so the KH-headed K/V are read once per group and never repeated."""
    if not _kernel(q):
        return _ref.attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    rep = H // KH
    k, v = k.contiguous(), v.contiguous()
    if rep == 1:
        return _fa.flash_attention(q.contiguous(), k, v, causal=causal,
                                   window=window, softcap=softcap)
    qg = q.reshape(B, Sq, KH, rep, D).transpose(2, 3)
    qg = qg.reshape(B, Sq * rep, KH, D).contiguous()
    o = _fa.flash_attention(qg, k, v, causal=causal, window=window,
                            softcap=softcap, q_rep=rep)
    o = o.reshape(B, Sq, rep, KH, D).transpose(2, 3)
    return o.reshape(B, Sq, H, D)


def packed_flash_decode(q, k_packed: Packed, v_packed: Packed, pos, *,
                        fields: PackFields, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """One-token decode attention straight over an SFP-packed KV cache:
    q (B, 1, H, hd); payload (B, L, KH*hd), bases (B, L, KH*hd // 128);
    ``pos`` (B,) per-row decode positions."""
    if not _kernel(q):
        return _ref.packed_flash_decode(
            q, k_packed.payload, k_packed.bases, v_packed.payload,
            v_packed.bases, pos, fields, window=window, softcap=softcap,
            block_l=DECODE_BLOCK_L)
    return _pfd.packed_flash_decode(
        q.contiguous(), k_packed.payload, k_packed.bases, v_packed.payload,
        v_packed.bases, pos.to(torch.int32).contiguous(), fields,
        window=window, softcap=softcap)
