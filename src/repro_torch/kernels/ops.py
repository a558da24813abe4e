"""Dispatch between the CUDA kernels and their plain versions.

Every model, training and serving call goes through here. A CUDA tensor goes to the
kernel (or the kernel's wrapper raises); a CPU tensor goes to the plain
version. ``force_backend("plain")`` is a test hook that sends CUDA tensors
to the plain versions too, so a run on the card can be compared with the
same program without kernels; ``force_backend("plain attention")`` does so
for ``attention`` alone (forward and backward), so such a comparison can
tell the attention kernels' share of a gap from the other kernels'.

The packed representation is a plain (payload, bases) pair. Every SFP
entry point dispatches on ``fields.dense``: fixed-lane geometries go to
the word kernels (``sfp_pack``), dense ones to the bit-plane kernels
(``bitplane_pack``); callers never branch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import bitplane_pack as _bp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gecko_pack as _gp
from repro_torch.kernels import mantissa_quant as _mq
from repro_torch.kernels import packed_flash_decode as _pfd
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sfp_pack as _sp

PackFields = _ref.PackFields
decode_kv_mask = _ref.decode_kv_mask
prefix_fields = _ref.prefix_fields  # truncated geometry of a draft read
DECODE_BLOCK_L = _pfd.DEFAULT_BLOCK_L

_BACKENDS = (None, "plain", "plain attention")
_FORCED: Optional[str] = None


def force_backend(name: Optional[str]) -> None:
    """Test hook: 'plain' runs the plain versions on every device, 'plain
    attention' only attention's; None restores dispatch by device."""
    global _FORCED
    if name not in _BACKENDS:
        raise ValueError(f"unknown backend {name!r}; use one of {_BACKENDS}")
    _FORCED = name


def _kernel(t: torch.Tensor, attention: bool = False) -> bool:
    if _FORCED == "plain" or (attention and _FORCED == "plain attention"):
        return False
    return t.device.type != "cpu"


class Packed(NamedTuple):
    """SFP-compressed tensor: payload words + per-group uint8 bases."""

    payload: torch.Tensor
    bases: torch.Tensor


# -- mantissa quantization ---------------------------------------------------


def mantissa_quantize(x: torch.Tensor, n) -> torch.Tensor:
    """Q(M, n) on any bf16/f32 tensor; ``n`` an int or 0-d integer tensor."""
    if not _kernel(x):
        return _ref.mantissa_truncate(x, n)
    return _mq.mantissa_quantize(x, n)


# -- SFP containers ----------------------------------------------------------


def _pack_rows(rows: torch.Tensor, fields: PackFields, n):
    if fields.dense:
        if n is None:
            return _bp.bitplane_pack(rows, fields)
        return _bp.bitplane_quantize_pack(rows, n, fields)
    if n is None:
        return _sp.sfp_pack(rows, fields)
    return _sp.sfp_quantize_pack(rows, n, fields)


def _plain_rows(rows: torch.Tensor, fields: PackFields, n):
    if fields.dense:
        return _ref.bitplane_pack_rows(rows, fields, n)
    return _ref.sfp_pack_rows(rows, fields, n)


def _unpack_rows(payload: torch.Tensor, bases: torch.Tensor, dtype,
                 fields: PackFields) -> torch.Tensor:
    if fields.dense:
        return _bp.bitplane_unpack(payload, bases, dtype, fields)
    return _sp.sfp_unpack(payload, bases, dtype, fields)


def sfp_compress_nd(x: torch.Tensor, fields: PackFields, n=None) -> Packed:
    """Rank-preserving pack (last dim % 128 == 0): payload
    (*x.shape[:-1], nd_payload_cols(D)) (words, or each position's bit
    planes ordered (group, plane, 16)), bases (*x.shape[:-1], D // 128).
    ``n`` fuses Q(M, n) into the pack (one read of x instead of
    mantissa_quantize then pack)."""
    if not _kernel(x):
        pack_nd = _ref.bitplane_pack_nd if fields.dense else _ref.sfp_pack_nd
        return Packed(*pack_nd(x, fields, n=n))
    D = x.shape[-1]
    if D % _ref.GROUP:
        raise ValueError(f"last dim {D} is not a multiple of {_ref.GROUP}")
    payload, bases = _pack_rows(x.contiguous().reshape(-1, _ref.GROUP),
                                fields, n)
    return Packed(payload=payload.reshape(*x.shape[:-1],
                                          fields.nd_payload_cols(D)),
                  bases=bases.reshape(*x.shape[:-1], D // _ref.GROUP))


def sfp_compress(x: torch.Tensor, fields: PackFields) -> Packed:
    """Flat pack over the zero-padded 128-lane rows of the flattened x."""
    return sfp_quantize_compress(x, None, fields)


def sfp_quantize_compress(x: torch.Tensor, n, fields: PackFields) -> Packed:
    """Fused Q(M, n) + flat pack (``n`` None: the plain pack)."""
    rows = _ref.to_rows(x.contiguous())
    if not _kernel(x):
        return Packed(*_plain_rows(rows, fields, n))
    return Packed(*_pack_rows(rows, fields, n))


def sfp_decompress_nd(packed: Packed, dtype, fields: PackFields
                      ) -> torch.Tensor:
    """Inverse of ``sfp_compress_nd``: floats of shape
    (*bases.shape[:-1], G * 128)."""
    if not _kernel(packed.payload):
        unpack_nd = (_ref.bitplane_unpack_nd if fields.dense
                     else _ref.sfp_unpack_nd)
        return unpack_nd(packed.payload, packed.bases, dtype, fields)
    G = packed.bases.shape[-1]
    cols = fields.group_payload_bytes if fields.dense else _ref.GROUP
    out = _unpack_rows(packed.payload.contiguous().reshape(-1, cols),
                       packed.bases.contiguous().reshape(-1, 1), dtype,
                       fields)
    return out.reshape(*packed.bases.shape[:-1], G * _ref.GROUP)


def sfp_decompress(packed: Packed, shape: tuple, dtype,
                   fields: PackFields) -> torch.Tensor:
    """Inverse of ``sfp_compress``: the first prod(shape) values."""
    if not _kernel(packed.payload):
        unpack = _ref.bitplane_unpack if fields.dense else _ref.sfp_unpack
        return unpack(packed.payload, packed.bases, tuple(shape), dtype,
                      fields)
    out = _unpack_rows(packed.payload.contiguous(),
                       packed.bases.contiguous(), dtype, fields)
    n = 1
    for s in shape:
        n *= s
    return out.reshape(-1)[:n].reshape(shape)


# -- Gecko exponent compression ----------------------------------------------


def gecko_encode(groups: torch.Tensor):
    """(G, 64) uint8 exponent groups -> (bases (G, 8), widths (G, 7),
    planes (G, 63)) uint8."""
    if not _kernel(groups):
        return _ref.gecko_plane_encode(groups)
    return _gp.gecko_pack(groups.contiguous())


def gecko_decode(bases: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """(bases (G, 8), planes (G, 63)) -> (G, 64) uint8 exponents."""
    if not _kernel(bases):
        return _ref.gecko_plane_decode(bases, planes)
    return _gp.gecko_unpack(bases.contiguous(), planes.contiguous())


# -- attention ---------------------------------------------------------------


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, prefix_len: int = 0,
              q_offset: int = 0) -> torch.Tensor:
    """GQA attention, q (B, Sq, H, D), k/v (B, Sk, KH, D); differentiable
    on both routes (autograd through the plain version, or the backward
    kernel). The first ``prefix_len`` keys are visible to every query (a
    prefix-LM); ``q_offset`` is the absolute position of q's first row,
    taken by the plain version only (no path of the model uses it, so on
    the kernel route it raises).

    On the kernel route the query head group is folded into the rows
    (row r of the folded axis is position r // rep, group member r % rep),
    so the KH-headed K/V are read once per group and never repeated."""
    if not _kernel(q, attention=True):
        return _ref.attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, prefix_len=prefix_len,
                              q_offset=q_offset)
    if q_offset:
        raise ValueError(f"attention: the kernels take q_offset 0 only, got "
                         f"{q_offset}")
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    rep = H // KH
    k, v = k.contiguous(), v.contiguous()
    if rep == 1:
        return _fa.flash_attention(q.contiguous(), k, v, causal=causal,
                                   window=window, softcap=softcap,
                                   prefix_len=prefix_len)
    qg = q.reshape(B, Sq, KH, rep, D).transpose(2, 3)
    qg = qg.reshape(B, Sq * rep, KH, D).contiguous()
    o = _fa.flash_attention(qg, k, v, causal=causal, window=window,
                            softcap=softcap, prefix_len=prefix_len,
                            q_rep=rep)
    o = o.reshape(B, Sq, rep, KH, D).transpose(2, 3)
    return o.reshape(B, Sq, H, D)


def packed_flash_decode(q, k_packed: Packed, v_packed: Packed, pos, *,
                        fields: PackFields, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        prefix_planes: Optional[int] = None) -> torch.Tensor:
    """One-token decode attention straight over an SFP-packed KV cache:
    q (B, 1, H, hd); payload (B, L, nd_payload_cols(KH*hd)) words or bit
    planes, bases (B, L, KH*hd // 128); ``pos`` (B,) per-row decode
    positions. ``prefix_planes`` is the speculative draft read: only the
    leading P' payload bits of the same cache are decoded
    (``prefix_fields``)."""
    if not _kernel(q):
        return _ref.packed_flash_decode(
            q, k_packed.payload, k_packed.bases, v_packed.payload,
            v_packed.bases, pos, fields, window=window, softcap=softcap,
            block_l=DECODE_BLOCK_L, prefix_planes=prefix_planes)
    decode = (_pfd.packed_flash_decode_dense if fields.dense
              else _pfd.packed_flash_decode)
    return decode(
        q.contiguous(), k_packed.payload, k_packed.bases, v_packed.payload,
        v_packed.bases, pos.to(torch.int32).contiguous(), fields,
        window=window, softcap=softcap, prefix_planes=prefix_planes)


def packed_flash_decode_shard(q, k_packed: Packed, v_packed: Packed, pos, *,
                              fields: PackFields, slot0: int, L_global: int,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              prefix_planes: Optional[int] = None):
    """The shard view of ``packed_flash_decode``: the packed cache holds a
    rank's slots [slot0, slot0 + L) of an ``L_global``-slot cache whose
    sequence is split over a mesh. Returns f32 (o (B, H, hd), lse (B,
    H)), the partials ``sharding.lse_combine`` joins over the ranks."""
    if not _kernel(q):
        return _ref.packed_flash_decode_shard(
            q, k_packed.payload, k_packed.bases, v_packed.payload,
            v_packed.bases, pos, fields, slot0=slot0, L_global=L_global,
            window=window, softcap=softcap, block_l=DECODE_BLOCK_L,
            prefix_planes=prefix_planes)
    return _pfd.packed_flash_decode_shard(
        q.contiguous(), k_packed.payload, k_packed.bases, v_packed.payload,
        v_packed.bases, pos.to(torch.int32).contiguous(), fields,
        slot0=slot0, L_global=L_global, window=window, softcap=softcap,
        prefix_planes=prefix_planes)


def paged_flash_decode(q, k_packed: Packed, v_packed: Packed, tables, pos, *,
                       fields: PackFields, softcap: Optional[float] = None,
                       prefix_planes: Optional[int] = None) -> torch.Tensor:
    """One-token global decode attention over a paged packed block pool:
    payload (P_blocks, block_l, nd_payload_cols(KH*hd)), bases
    (P_blocks, block_l, KH*hd // 128) shared by every row; ``tables``
    (B, nb) maps each row's logical blocks to physical ones, ``pos`` (B,)
    per-row positions. The kernel reads the table itself; the plain
    version gathers, then runs the contiguous recurrence with block_l =
    the pool block. ``prefix_planes`` as in ``packed_flash_decode``."""
    if not _kernel(q):
        return _ref.paged_flash_decode(
            q, k_packed.payload, k_packed.bases, v_packed.payload,
            v_packed.bases, tables, pos, fields, softcap=softcap,
            prefix_planes=prefix_planes)
    decode = (_pfd.paged_flash_decode_dense if fields.dense
              else _pfd.paged_flash_decode)
    return decode(
        q.contiguous(), k_packed.payload, k_packed.bases, v_packed.payload,
        v_packed.bases, tables.to(torch.int32).contiguous(),
        pos.to(torch.int32).contiguous(), fields, softcap=softcap,
        prefix_planes=prefix_planes)
