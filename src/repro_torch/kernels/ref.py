"""Plain PyTorch versions of the port's kernels.

They repeat the arithmetic of the JAX package's oracles
(``repro.kernels.ref``): mantissa truncation, the SFP word machine (with
the fused Q(M, n)) stored as fixed-lane words or as dense bit planes,
Gecko's exponent plane encode and decode (beside a step-for-step mirror
of its CUDA kernels' SWAR arithmetic, for the tests), the ring-slot
validity mask, the packed decode's block recurrence (contiguous and
paged, full width or the draft's leading-bit prefix) and dense attention.
The CPU path runs them, the tests hold them against the JAX package, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import containers

GROUP = 128
PLANE_BYTES = GROUP // 8  # one byte-aligned bit plane of a 128-lane group
NEG_INF = -1e30


class PackFields(NamedTuple):
    """Payload geometry of an SFP container.

    ``dense=False`` is the fixed-lane layout: one 8/16-bit payload word per
    value. ``dense=True`` is the bit-plane layout: the payload word is
    ``1 + dexp_bits + man_keep`` bits wide (3..16) and each of its bits is
    stored as a byte-aligned plane of 16 bytes over the 128-lane group, so
    a value occupies ``payload_bits`` bits."""

    man_keep: int       # mantissa bits kept in the payload
    dexp_bits: int      # delta-exponent field width
    payload_bits: int   # total payload word width (3..16)
    dense: bool = False  # True -> byte-aligned bit-plane storage

    @property
    def word_dtype(self) -> torch.dtype:
        """Narrowest uint holding one payload word."""
        return torch.uint8 if self.payload_bits <= 8 else torch.uint16

    @property
    def payload_dtype(self) -> torch.dtype:
        """Element dtype of the stored payload (planes are bytes)."""
        return torch.uint8 if self.dense else self.word_dtype

    @property
    def group_payload_bytes(self) -> int:
        """Payload bytes of one 128-lane group (without its base)."""
        if self.dense:
            return self.payload_bits * PLANE_BYTES
        return GROUP * (1 if self.payload_bits <= 8 else 2)

    def nd_payload_cols(self, D: int) -> int:
        """Last-dim width of the rank-preserving payload for a feature dim
        ``D`` (% 128 == 0): D words, or (D // 128) groups of
        ``payload_bits`` 16-byte planes."""
        if self.dense:
            return (D // GROUP) * self.group_payload_bytes
        return D

    @property
    def sign_shift(self) -> int:
        return self.payload_bits - 1

    @property
    def dexp_shift(self) -> int:
        return self.payload_bits - 1 - self.dexp_bits

    @property
    def man_shift(self) -> int:
        return self.payload_bits - 1 - self.dexp_bits - self.man_keep

    @property
    def dexp_max(self) -> int:
        return (1 << self.dexp_bits) - 1


def mantissa_truncate(x: torch.Tensor, n) -> torch.Tensor:
    """Q(M, n): keep the top ``n`` mantissa bits (the function of the
    ``mantissa_quantize`` kernel)."""
    return containers.truncate_mantissa(x, n)


# ---------------------------------------------------------------------------
# Fixed-lane SFP words: one shared max-exponent base per 128-lane group.
# ---------------------------------------------------------------------------


def _pack_words(x: torch.Tensor, f: PackFields,
                spec: containers.FloatSpec, n=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack body over the last (128-lane) axis -> (int32 words, int32
    base with a kept last axis). ``n`` (int or integer tensor) fuses
    Q(M, n) into the same pass. Zero and subnormal inputs flush and lose
    their sign; values more than ``dexp_max`` binades below the group's
    max exponent flush; the base counts zeros too."""
    sign, e, man = containers.split_fields(x)
    if n is not None:
        keep = containers.mantissa_keep_mask(n, spec, x.device)
        man = man & keep.to(torch.int32)
    base = torch.amax(e, dim=-1, keepdim=True)
    dexp = base - e
    man_top = man >> (spec.man_bits - f.man_keep)
    flush = (e == 0) | (dexp > f.dexp_max)
    dexp = torch.where(flush, f.dexp_max, torch.clamp(dexp, max=f.dexp_max))
    man_top = torch.where(flush, 0, man_top)
    sign = torch.where(e == 0, 0, sign)
    word = ((sign << f.sign_shift) | (dexp << f.dexp_shift)
            | (man_top << f.man_shift))
    return word, base


def _unpack_words(p: torch.Tensor, base: torch.Tensor, f: PackFields,
                  spec: containers.FloatSpec) -> torch.Tensor:
    """Inverse of ``_pack_words``: int32 words + broadcastable int32 base
    -> floats of ``spec``. (dexp_max, man 0) decodes to +0."""
    p = p.to(torch.int32)
    sign = (p >> f.sign_shift) & 1
    dexp = (p >> f.dexp_shift) & f.dexp_max
    man_top = (p >> f.man_shift) & ((1 << f.man_keep) - 1)
    e = torch.clamp(base.to(torch.int32) - dexp, min=0)
    man = man_top << (spec.man_bits - f.man_keep)
    flush = (dexp == f.dexp_max) & (man_top == 0)
    e = torch.where(flush, 0, e)
    man = torch.where(flush, 0, man)
    sign = torch.where(flush, 0, sign)
    return containers.combine_fields(sign, e, man, spec)


def sfp_pack_rows(x: torch.Tensor, fields: PackFields, n=None):
    """(R, 128) floats -> (payload (R, 128) words, bases (R, 1) uint8):
    the function of the ``sfp_pack`` kernel, and with ``n`` of the fused
    ``sfp_quantize_pack`` kernel."""
    spec = containers.spec_for(x)
    word, base = _pack_words(x, fields, spec, n)
    return word.to(fields.word_dtype), base.to(torch.uint8)


def sfp_unpack_rows(payload: torch.Tensor, bases: torch.Tensor,
                    dtype: torch.dtype, fields: PackFields) -> torch.Tensor:
    """(R, 128) words + (R, 1) bases -> (R, 128) floats: the function of
    the ``sfp_unpack`` kernel."""
    return _unpack_words(payload, bases.to(torch.int32), fields,
                         containers.spec_for(dtype))


def to_rows(x: torch.Tensor) -> torch.Tensor:
    """Flatten to (rows, 128) lane groups, zero-padding the tail."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % GROUP
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, GROUP)


def sfp_unpack(payload: torch.Tensor, bases: torch.Tensor, shape: tuple,
               dtype: torch.dtype, fields: PackFields) -> torch.Tensor:
    spec = containers.spec_for(dtype)
    out = _unpack_words(payload, bases, fields, spec)
    n = 1
    for s in shape:
        n *= s
    return out.reshape(-1)[:n].reshape(shape)


def sfp_pack_nd(x: torch.Tensor, fields: PackFields, n=None):
    """Rank-preserving pack: groups along the last dim (% 128 == 0).
    payload has x's shape; bases (*x.shape[:-1], D // 128) uint8. ``n``
    fuses Q(M, n) into the pack."""
    D = x.shape[-1]
    if D % GROUP:
        raise ValueError(f"last dim {D} is not a multiple of {GROUP}")
    payload, base = sfp_pack_rows(x.reshape(-1, GROUP), fields, n)
    return (payload.reshape(x.shape),
            base.reshape(*x.shape[:-1], D // GROUP))


def sfp_unpack_nd(payload: torch.Tensor, bases: torch.Tensor,
                  dtype: torch.dtype, fields: PackFields) -> torch.Tensor:
    spec = containers.spec_for(dtype)
    D = payload.shape[-1]
    p = payload.reshape(*payload.shape[:-1], D // GROUP, GROUP)
    out = _unpack_words(p, bases.to(torch.int32)[..., None], fields, spec)
    return out.reshape(payload.shape)


def prefix_fields(fields: PackFields, prefix_planes: int) -> PackFields:
    """Geometry of the leading ``prefix_planes`` bits of a payload word
    (the speculative draft read). The word is most-significant-first
    (sign, delta exponent, mantissa top), so ``word >> (P - P')`` is the
    narrow pack of the same values with ``man_keep - (P - P')`` mantissa
    bits; a wide flush word truncates to the narrow flush word. Dense
    planes are stored LSB-plane first, so the prefix is the last P'
    planes of each group. P' must keep one mantissa bit:
    ``dexp_bits + 2 <= prefix_planes <= payload_bits``."""
    P = int(prefix_planes)
    if not fields.dexp_bits + 2 <= P <= fields.payload_bits:
        raise ValueError(
            f"prefix_planes={P} outside [{fields.dexp_bits + 2}, "
            f"{fields.payload_bits}] for {fields}")
    drop = fields.payload_bits - P
    return PackFields(man_keep=fields.man_keep - drop,
                      dexp_bits=fields.dexp_bits, payload_bits=P,
                      dense=fields.dense)


def prefix_plane_view(payload: torch.Tensor, fields: PackFields,
                      prefix_planes: int) -> torch.Tensor:
    """A dense group payload (..., P*16) cut to its leading-bit prefix
    (..., P'*16): the last P' planes in storage order."""
    P, Pp = fields.payload_bits, int(prefix_planes)
    lead = payload.shape[:-1]
    pl = payload.reshape(*lead, P, PLANE_BYTES)
    return pl[..., P - Pp:, :].reshape(*lead, Pp * PLANE_BYTES)


def unpack_tile(payload: torch.Tensor, bases: torch.Tensor,
                fields: PackFields, spec: containers.FloatSpec, *, rows: int,
                KH: int, hd: int, prefix_planes: Optional[int] = None
                ) -> torch.Tensor:
    """Tile decompressor of the packed decode: payload (rows,
    nd_payload_cols(KH*hd)) words or bit planes and bases (rows, G) ->
    (rows, KH, hd) float32. Groups span the flattened KH*hd axis, so a
    group may straddle heads. ``prefix_planes`` P' < P is the draft read:
    only the leading P' bits of each word are decoded, as the geometry
    ``prefix_fields`` gives (dense: the last P' planes; words: shifted
    right by P - P')."""
    G = (KH * hd) // GROUP
    b = bases.to(torch.int32).reshape(rows, G, 1)
    f = fields
    if prefix_planes is not None and prefix_planes != fields.payload_bits:
        f = prefix_fields(fields, prefix_planes)
    if fields.dense:
        planes = payload.reshape(rows, G, fields.group_payload_bytes)
        if f is not fields:
            planes = prefix_plane_view(planes, fields, f.payload_bits)
        x = unpack_planes(planes, b, f, spec)
    else:
        p = payload.to(torch.int32).reshape(rows, G, GROUP)
        p = p >> (fields.payload_bits - f.payload_bits)
        x = _unpack_words(p, b, f, spec)
    return x.reshape(rows, KH, hd).to(torch.float32)


# ---------------------------------------------------------------------------
# Dense bit-plane containers: P = 1 + E + K payload bits per value stored as
# P byte-aligned planes per 128-lane group. Plane p of a group is 16 bytes;
# byte i holds bit p of the words of lanes 8i..8i+7 (bit j <-> lane 8i+j);
# planes are stored LSB-plane first. A plain int32 bit loop: the JAX
# package's SWAR transpose and uint8 fast path are speed devices with the
# same bits.
# ---------------------------------------------------------------------------


def _lane_bits(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.int32, device=device)


def plane_pack_words(words: torch.Tensor, payload_bits: int) -> torch.Tensor:
    """Payload words (..., 128) -> bit planes (..., P*16) uint8."""
    lead = words.shape[:-1]
    w = words.to(torch.int32).reshape(*lead, PLANE_BYTES, 8)
    j = _lane_bits(words.device)
    planes = [torch.sum(((w >> p) & 1) << j, dim=-1, dtype=torch.int32)
              for p in range(payload_bits)]
    return torch.stack(planes, dim=-2).to(torch.uint8).reshape(
        *lead, payload_bits * PLANE_BYTES)


def plane_unpack_words(planes: torch.Tensor, payload_bits: int
                       ) -> torch.Tensor:
    """Inverse of ``plane_pack_words``: (..., P*16) uint8 -> (..., 128)
    int32 words."""
    lead = planes.shape[:-1]
    b = planes.to(torch.int32).reshape(*lead, payload_bits, PLANE_BYTES, 1)
    j = _lane_bits(planes.device)
    w = torch.zeros((*lead, PLANE_BYTES, 8), dtype=torch.int32,
                    device=planes.device)
    for p in range(payload_bits):
        w |= ((b[..., p, :, :] >> j) & 1) << p
    return w.reshape(*lead, GROUP)


def _delta_swap(a, b, sh: int, mask: int):
    """The bits of b under mask >> sh trade places with those of a under
    mask (``delta_swap`` of csrc/swar.cuh)."""
    t = (a ^ (b << sh)) & mask
    return a ^ t, b ^ (t >> sh)


def _swar_transpose8(x):
    """SWAR 8x8 bit-matrix transpose (Hacker's Delight delta-swaps) of 8
    int64 tensors holding uint32 values, 4 byte-matrices side by side:
    byte i of x[p] is row p of matrix i on entry, byte i of x[j] its
    column j on exit (the JAX package's ``_reg_transpose8``)."""
    x = list(x)
    for sh, mask, pairs in ((1, 0xAAAAAAAA, ((0, 1), (2, 3), (4, 5), (6, 7))),
                            (2, 0xCCCCCCCC, ((0, 2), (1, 3), (4, 6), (5, 7))),
                            (4, 0xF0F0F0F0, ((0, 4), (1, 5), (2, 6), (3, 7)))):
        for i, j in pairs:
            x[i], x[j] = _delta_swap(x[i], x[j], sh, mask)
    return x


def _swar_words32(u: torch.Tensor, Pr: int) -> torch.Tensor:
    """One 32-lane chunk: (..., Pr) int64 uint32s (the chunk's uint32 of
    each plane row read, LSB plane first) -> (..., 32) int64 words by the
    register SWAR transpose, 8 planes a transpose."""
    zero = torch.zeros_like(u[..., 0])
    words = torch.zeros((*u.shape[:-1], 32), dtype=torch.int64)
    for lo in range(0, Pr, 8):
        y = _swar_transpose8([u[..., lo + r] if lo + r < Pr else zero
                              for r in range(8)])
        # byte i of y[j] is the byte of lane 8i + j
        byt = torch.stack([torch.stack([(yj >> (8 * i)) & 0xFF for yj in y],
                                       dim=-1) for i in range(4)], dim=-2)
        words |= byt.reshape(*u.shape[:-1], 32) << lo
    return words


def _plane_uint32s(planes: torch.Tensor, payload_bits: int,
                   prefix_planes: Optional[int]):
    """(..., G*P*16) uint8 planes -> (..., G, Pr, 4) int64: uint32 k of
    plane row p of each group, rows P - Pr .. P - 1 (the draft's) only."""
    P = payload_bits
    Pr = P if prefix_planes is None else int(prefix_planes)
    lead = planes.shape[:-1]
    b = planes.reshape(*lead, -1, P, 4, 4)[..., P - Pr:, :, :].to(
        torch.int64)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def plane_words_swar(planes: torch.Tensor, payload_bits: int,
                     prefix_planes: Optional[int] = None) -> torch.Tensor:
    """The decode kernel's plane expansion: (..., P*16) uint8 planes ->
    (..., 128) int32 words by the register SWAR transpose, one uint32 of
    each plane (32 lanes) at a time, 8 planes a transpose. With
    ``prefix_planes`` P' only planes P - P' .. P - 1 are read, as rows
    0 .. P' - 1: the P'-bit words of the draft geometry. Equal to
    ``plane_unpack_words`` (of ``prefix_plane_view``); for the tests."""
    Pr = payload_bits if prefix_planes is None else int(prefix_planes)
    u = _plane_uint32s(planes, payload_bits, prefix_planes)[..., 0, :, :]
    words = torch.stack([_swar_words32(u[..., k], Pr) for k in range(4)],
                        dim=-2)
    return words.reshape(*planes.shape[:-1], GROUP).to(torch.int32)


class Chunk(NamedTuple):
    """One 32-lane chunk of a head, on the absolute grid of the flattened
    KH*hd axis: flat chunk ``index`` (uint32 ``index % 4`` of each plane
    row of group ``index // 4``), and the head's features ``[lo, hi)`` in
    it, at chunk lanes ``[lo + offset, hi + offset)``."""
    index: int
    lo: int
    hi: int
    offset: int


def head_chunks(h: int, hd: int) -> Tuple[Chunk, ...]:
    """The chunks head ``h`` covers (``csrc/packed_flash_decode.cu``: warp
    c owns chunk c), in the order the kernel adds their partial scores:
    ceil(hd / 32) of them, each in one 128-lane group. A head starting 16
    lanes into a chunk (hd = 16 mod 32, odd h) has its first chunk's low
    half from the previous head; one ending 16 lanes into a chunk its last
    chunk's high half from the next."""
    if hd % 16:
        raise ValueError(f"head dim {hd} is not a multiple of 16")
    C0, o = divmod(h * hd, 32)
    return tuple(Chunk(C0 + c, max(0, 32 * c - o), min(hd, 32 * c - o + 32),
                       o - 32 * c) for c in range(-(-hd // 32)))


def head_words_swar(planes: torch.Tensor, payload_bits: int, h: int,
                    hd: int, prefix_planes: Optional[int] = None
                    ) -> torch.Tensor:
    """The decode kernel's plane expansion for one head: (..., G*P*16)
    uint8 planes of the flattened KH*hd axis -> (..., hd) int32 words of
    head ``h``, chunk by chunk of ``head_chunks`` (each chunk's uint32 of
    each plane row of its group, transposed whole; the lanes outside the
    head are dropped). Equal to the head's slice of
    ``plane_unpack_words``; for the tests."""
    Pr = payload_bits if prefix_planes is None else int(prefix_planes)
    u = _plane_uint32s(planes, payload_bits, prefix_planes)
    parts = []
    for ch in head_chunks(h, hd):
        w = _swar_words32(u[..., ch.index // 4, :, ch.index % 4], Pr)
        parts.append(w[..., ch.lo + ch.offset:ch.hi + ch.offset])
    return torch.cat(parts, -1).to(torch.int32)


def unpack_planes(planes: torch.Tensor, bases: torch.Tensor,
                  fields: PackFields, spec: containers.FloatSpec
                  ) -> torch.Tensor:
    """Dense plane decode: (..., P*16) planes + broadcastable bases ->
    (..., 128) floats of ``spec``."""
    words = plane_unpack_words(planes, fields.payload_bits)
    return _unpack_words(words, bases.to(torch.int32), fields, spec)


def bitplane_pack_rows(x: torch.Tensor, fields: PackFields, n=None):
    """(R, 128) floats -> (planes (R, P*16) uint8, bases (R, 1) uint8):
    the function of the ``bitplane_pack`` kernel, and with ``n`` of the
    fused ``bitplane_quantize_pack`` kernel."""
    word, base = _pack_words(x, fields, containers.spec_for(x), n)
    return (plane_pack_words(word, fields.payload_bits),
            base.to(torch.uint8))


def bitplane_unpack_rows(planes: torch.Tensor, bases: torch.Tensor,
                         dtype: torch.dtype, fields: PackFields
                         ) -> torch.Tensor:
    """(R, P*16) planes + (R, 1) bases -> (R, 128) floats: the function of
    the ``bitplane_unpack`` kernel."""
    return unpack_planes(planes, bases, fields, containers.spec_for(dtype))


def bitplane_pack(x: torch.Tensor, fields: PackFields, n=None):
    """Flat dense pack over the zero-padded 128-lane rows of x."""
    return bitplane_pack_rows(to_rows(x), fields, n)


def bitplane_unpack(planes: torch.Tensor, bases: torch.Tensor, shape: tuple,
                    dtype: torch.dtype, fields: PackFields) -> torch.Tensor:
    out = bitplane_unpack_rows(planes, bases, dtype, fields)
    n = 1
    for s in shape:
        n *= s
    return out.reshape(-1)[:n].reshape(shape)


def bitplane_pack_nd(x: torch.Tensor, fields: PackFields, n=None):
    """Rank-preserving dense pack (last dim % 128 == 0): payload
    (*x.shape[:-1], (D // 128) * P * 16) uint8, each position's bytes
    ordered (group, plane, 16); bases (*x.shape[:-1], D // 128)."""
    D = x.shape[-1]
    if D % GROUP:
        raise ValueError(f"last dim {D} is not a multiple of {GROUP}")
    lead = x.shape[:-1]
    xg = x.reshape(*lead, D // GROUP, GROUP)
    words, base = _pack_words(xg, fields, containers.spec_for(x), n)
    planes = plane_pack_words(words, fields.payload_bits)
    return (planes.reshape(*lead, fields.nd_payload_cols(D)),
            base[..., 0].to(torch.uint8))


def bitplane_unpack_nd(planes: torch.Tensor, bases: torch.Tensor,
                       dtype: torch.dtype, fields: PackFields
                       ) -> torch.Tensor:
    G = bases.shape[-1]
    lead = planes.shape[:-1]
    p = planes.reshape(*lead, G, fields.group_payload_bytes)
    out = unpack_planes(p, bases[..., None], fields,
                        containers.spec_for(dtype))
    return out.reshape(*lead, G * GROUP)


# ---------------------------------------------------------------------------
# Gecko delta-mode exponent compression (the function of gecko_pack and
# gecko_unpack). Each 64-exponent group is an 8x8 matrix: row 0 holds the 8
# column bases, rows 1..7 sign+magnitude deltas against them, stored as bit
# planes: byte [row, p] holds bit p of all 8 columns (bit c <-> column c);
# p = 0 is the sign plane, p = 1..8 the magnitude planes, so a row whose
# largest |delta| needs w bits has w + 1 meaningful bytes and zeros above.
# ---------------------------------------------------------------------------

GECKO_GROUP = 64   # exponents per group (8 rows x 8 columns)
GECKO_ROWS = 7     # delta rows (row 0 is the bases)
GECKO_PLANES = 9   # sign plane + 8 magnitude bit planes
GECKO_PLANE_BYTES = GECKO_ROWS * GECKO_PLANES  # 63 dense bytes per group


def gecko_encode_block(g: torch.Tensor):
    """(G, 64) int32 groups -> int32 (bases (G, 8), widths (G, 7), planes
    (G, 63)). Deltas span -255..255; a row's width is the bit length of
    its largest magnitude (0..8); a zero delta has no sign bit."""
    g = g.reshape(-1, 8, 8)
    bases = g[:, 0, :]
    d = g[:, 1:, :] - bases[:, None, :]           # (G, 7, 8)
    sign = (d < 0).to(torch.int32)
    mag = torch.abs(d)
    row_max = torch.amax(mag, dim=2)
    width = torch.zeros_like(row_max)
    for b in range(8, -1, -1):                    # 255 needs 8 bits
        width = torch.where((row_max >> b) > 0,
                            torch.clamp(width, min=b + 1), width)
    col = torch.arange(8, dtype=torch.int32, device=g.device)
    planes = [torch.sum(sign << col, dim=2, dtype=torch.int32)]
    for b in range(8):
        planes.append(torch.sum(((mag >> b) & 1) << col, dim=2,
                                dtype=torch.int32))
    return bases, width, torch.stack(planes, dim=2).reshape(
        -1, GECKO_PLANE_BYTES)


def gecko_decode_block(bases: torch.Tensor, planes: torch.Tensor
                       ) -> torch.Tensor:
    """Inverse of ``gecko_encode_block`` (int32 in and out): every plane
    of every row is read, whatever the row's width."""
    pl = planes.reshape(-1, GECKO_ROWS, GECKO_PLANES)
    col = torch.arange(8, dtype=torch.int32, device=planes.device)
    sign = (pl[:, :, 0:1] >> col) & 1                          # (G, 7, 8)
    mag = torch.zeros_like(sign)
    for b in range(8):
        mag = mag | (((pl[:, :, b + 1:b + 2] >> col) & 1) << b)
    d = torch.where(sign == 1, -mag, mag)
    b0 = bases[:, None, :]
    return torch.cat([b0, b0 + d], dim=1).reshape(-1, GECKO_GROUP)


def gecko_plane_encode(groups: torch.Tensor):
    """(G, 64) uint8 exponent groups -> uint8 (bases (G, 8), widths
    (G, 7), planes (G, 63)): the function of the ``gecko_pack`` kernel."""
    bases, width, planes = gecko_encode_block(groups.to(torch.int32))
    return (bases.to(torch.uint8), width.to(torch.uint8),
            planes.to(torch.uint8))


def gecko_plane_decode(bases: torch.Tensor, planes: torch.Tensor
                       ) -> torch.Tensor:
    """(bases (G, 8), planes (G, 63)) uint8 -> (G, 64) uint8 exponents
    (``base + delta`` wraps to a byte): the function of ``gecko_unpack``."""
    return gecko_decode_block(bases.to(torch.int32),
                              planes.to(torch.int32)).to(torch.uint8)


# The gecko_pack / gecko_unpack kernels' SWAR arithmetic (csrc/gecko_pack.cu,
# swar.cuh) step for step, on uint32 words held in int64 tensors: the
# byte-SIMD intrinsics, the 8x8 bit transpose, the assembly of a group's
# 63-byte record and its unaligned reads and writes in a warp tile's
# shared-memory slot (32 groups, one a lane). For the tests: equal to
# gecko_plane_encode / gecko_plane_decode; the kernels can only be run on
# the card.

GECKO_TILE = 32                       # groups a warp tile
_U32 = 0xFFFFFFFF


def _lanes4(x):
    return [(x >> (8 * i)) & 0xFF for i in range(4)]


def _word(b):
    return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)


def _vadd4(a, b):
    return _word([(x + y) & 0xFF for x, y in zip(_lanes4(a), _lanes4(b))])


def _vabsdiffu4(a, b):
    return _word([(x - y).abs() for x, y in zip(_lanes4(a), _lanes4(b))])


def _vcmpltu4(a, b):
    return _word([(x < y).to(torch.int64) * 0xFF
                  for x, y in zip(_lanes4(a), _lanes4(b))])


def _bitlength8(v):
    """``32 - __clz(v)`` for v in 0..255."""
    return sum(((v >> b) != 0).to(torch.int64) for b in range(8))


def _funnelshift_r(lo, hi, sh: int):
    return lo if sh == 0 else ((lo >> sh) | (hi << (32 - sh))) & _U32


def _funnelshift_l(lo, hi, sh: int):
    return hi if sh == 0 else ((hi << sh) | (lo >> (32 - sh))) & _U32


def _byte_perm(a, b, sel: int):
    src = _lanes4(a) + _lanes4(b)
    return _word([src[(sel >> (4 * k)) & 7] for k in range(4)])


def _delta_swap1(x, sh: int, mask: int):
    t = (x ^ (x >> sh)) & mask
    return (x ^ t ^ (t << sh)) & _U32


def _transpose8x8(lo, hi):
    """``transpose8x8``: one 8x8 bit matrix, rows 0-3 in lo, 4-7 in hi."""
    lo = _delta_swap1(lo, 7, 0x00AA00AA)
    hi = _delta_swap1(hi, 7, 0x00AA00AA)
    lo = _delta_swap1(lo, 14, 0x0000CCCC)
    hi = _delta_swap1(hi, 14, 0x0000CCCC)
    return _delta_swap(lo, hi, 4, 0xF0F0F0F0)


def _movemask4(m):
    return ((m & 0x01010101) * 0x10204080 & _U32) >> 28


def _spread4(x):
    return ((x * 0x00204081) & 0x01010101) * 0xFF


def _put_row(R, r: int, s, lo, hi):
    w, q = 9 * r // 4, 8 * ((9 * r) % 4)
    v0 = _byte_perm(s, lo, 0x6540)
    v1 = _byte_perm(lo, hi, 0x6543)
    v2 = hi >> 24
    R[w] = R[w] | ((v0 << q) & _U32)
    R[w + 1] = R[w + 1] | _funnelshift_l(v0, v1, q)
    R[w + 2] = R[w + 2] | _funnelshift_l(v1, v2, q)


def _get_row(R, r: int):
    w, q = (9 * r + 1) // 4, 8 * ((9 * r + 1) % 4)
    s = (R[9 * r // 4] >> (8 * ((9 * r) % 4))) & 0xFF
    return s, _funnelshift_r(R[w], R[w + 1], q), _funnelshift_r(
        R[w + 1], R[w + 2], q)


def _load_record(slot, o: int, n: int):
    """``load_record``: the n words of the (4n - 1)-byte record at byte o
    of every tile's slot (T, bytes), from n + 1 aligned words."""
    a0 = o & ~3
    w = [_word([slot[:, a0 + 4 * j + i] for i in range(4)])
         for j in range(n + 1)]
    return [_funnelshift_r(w[m], w[m + 1], 8 * (o & 3)) for m in range(n)]


def _store_record(slot, o: int, R) -> None:
    """``store_record``: aligned interior words and three edge bytes."""
    n, h = len(R), (-o) & 3
    for m in range(n - 1):
        for i, b in enumerate(_lanes4(_funnelshift_r(R[m], R[m + 1],
                                                     8 * h))):
            slot[:, o + h + 4 * m + i] = b
    for e in range(3):
        if e < h:
            slot[:, o + e] = (R[0] >> (8 * e)) & 0xFF
        else:
            slot[:, o + 4 * n - 4 + e] = (R[n - 1] >> (8 * e)) & 0xFF


def _tiles(rows: torch.Tensor, cols: int) -> torch.Tensor:
    """(G, cols) bytes -> (T, 32 * cols) int64 warp tiles; the lanes past G
    hold zeros."""
    G = rows.shape[0]
    t = torch.zeros((-(-G // GECKO_TILE) * GECKO_TILE, cols),
                    dtype=torch.int64)
    t[:G] = rows.cpu()
    return t.reshape(-1, GECKO_TILE * cols)


def _untile(words, G: int) -> torch.Tensor:
    """(T, 32) words (one per lane) in order -> (G, 4 * len(words)) uint8."""
    b = torch.stack([torch.stack(_lanes4(w), -1) for w in words], -2)
    return b.reshape(-1, 4 * len(words))[:G].to(torch.uint8)


def gecko_plane_encode_swar(groups: torch.Tensor):
    """``gecko_pack``'s arithmetic: (G, 64) uint8 -> uint8 (bases (G, 8),
    widths (G, 7), planes (G, 63)), equal to ``gecko_plane_encode``."""
    G = groups.shape[0]
    b = _tiles(groups, GECKO_GROUP).reshape(-1, GECKO_TILE, 16, 4)
    x = [_word([b[..., k, i] for i in range(4)]) for k in range(16)]
    zero = torch.zeros_like(x[0])
    R, W = [zero] * 16, [zero] * 2
    for r in range(GECKO_ROWS):
        a, c = x[2 * r + 2], x[2 * r + 3]
        lo, hi = _vabsdiffu4(a, x[0]), _vabsdiffu4(c, x[1])
        sign = (_movemask4(_vcmpltu4(a, x[0]))
                | (_movemask4(_vcmpltu4(c, x[1])) << 4))
        m = lo | hi
        m = m | (m >> 16)
        m = m | (m >> 8)
        W[r // 4] = W[r // 4] | (_bitlength8(m & 0xFF) << (8 * (r % 4)))
        lo, hi = _transpose8x8(lo, hi)
        _put_row(R, r, sign, lo, hi)
    T = x[0].shape[0]
    slot = torch.zeros((T, GECKO_TILE * (GECKO_PLANE_BYTES + GECKO_ROWS)),
                       dtype=torch.int64)
    wbase = GECKO_TILE * GECKO_PLANE_BYTES
    for lane in range(GECKO_TILE):
        _store_record(slot, GECKO_PLANE_BYTES * lane,
                      [w[:, lane] for w in R])
        _store_record(slot, wbase + GECKO_ROWS * lane,
                      [w[:, lane] for w in W])
    planes = slot[:, :wbase].reshape(-1, GECKO_PLANE_BYTES)[:G]
    widths = slot[:, wbase:].reshape(-1, GECKO_ROWS)[:G]
    return (_untile(x[:2], G), widths.to(torch.uint8),
            planes.to(torch.uint8))


def gecko_plane_decode_swar(bases: torch.Tensor, planes: torch.Tensor
                            ) -> torch.Tensor:
    """``gecko_unpack``'s arithmetic: (bases (G, 8), planes (G, 63)) uint8
    -> (G, 64) uint8, equal to ``gecko_plane_decode``."""
    G = bases.shape[0]
    nb = GECKO_TILE * 8
    slot = torch.cat([_tiles(bases, 8), _tiles(planes, GECKO_PLANE_BYTES),
                      torch.zeros((-(-G // GECKO_TILE), 16),
                                  dtype=torch.int64)], dim=1)
    base = [_word([slot[:, 8 * torch.arange(GECKO_TILE) + 4 * k + i]
                   for i in range(4)]) for k in range(2)]
    recs = [_load_record(slot, nb + GECKO_PLANE_BYTES * lane, 16)
            for lane in range(GECKO_TILE)]
    R = [torch.stack([rec[m] for rec in recs], -1) for m in range(16)]
    y = list(base)
    for r in range(GECKO_ROWS):
        sign, lo, hi = _get_row(R, r)
        lo, hi = _transpose8x8(lo, hi)
        for bw, mag, neg in ((base[0], lo, _spread4(sign & 0xF)),
                             (base[1], hi, _spread4(sign >> 4))):
            y.append(_vadd4(bw ^ neg, mag) ^ neg)
    return _untile(y, G)


# The dense bit-plane kernels' arithmetic (csrc/bitplane_pack.cu) step for
# step, on uint32 words held in int64 tensors: a thread per 8 lanes (16 a
# row), the pair encode and decode of two bf16 values a register, the row
# base as a max over the row's threads, the one or two 8x8 bit transposes
# of each thread's word bytes and the shared-memory image of a tile of rows
# (row r of a tile at byte r * P * 16, byte t of plane p of it at 16 p + t,
# the tile's bases after its largest image). For the tests: equal to
# plane_pack_words / plane_unpack_words and bitplane_pack_rows /
# bitplane_unpack_rows; the kernels can only be run on the card.

BITPLANE_ROW_THREADS = 16                 # threads a row: 8 lanes each
BITPLANE_PASS_ROWS = 16                   # rows a 256-thread block's pass
# Rows an H100 holds at once with one pass (8 blocks on each of 132 SMs);
# above, a tile is two passes.
BITPLANE_ONE_PASS_ROWS = 8 * 132 * BITPLANE_PASS_ROWS
_IMAGE_ROW = 16 * PLANE_BYTES             # image bytes a row of 16 planes


def bitplane_tile_rows(rows: int) -> int:
    """Rows of the kernels' tile for ``rows`` rows: 16 (one pass) up to
    ``BITPLANE_ONE_PASS_ROWS``, 32 (two passes) above."""
    return BITPLANE_PASS_ROWS * (1 if rows <= BITPLANE_ONE_PASS_ROWS else 2)


def _twice(v):
    return v * 0x10001


def _pair_fields(f: PackFields, keep: int) -> dict:
    """``pair_fields``: the constants of the pair encode and decode."""
    K, P, dmax = f.man_keep, f.payload_bits, f.dexp_max
    return dict(emask2=_twice(0xFF << K),
                mkeep2=_twice((keep & 0x7F) >> (7 - K)),
                magm2=_twice((1 << (P - 1)) - 1), flush2=_twice(dmax << K),
                flush7=_twice(dmax << 7), man_shift=7 - K, sign_shift=16 - P)


def _encode_pair(u2, y2, ek2, c2, baseK2, c: dict):
    """``encode_pair``: two bf16 values (the halves of u2) -> two payload
    words, by 16-bit SIMD."""
    ok2 = (ek2 + c2) & 0x80008000
    okm = ok2 - (ok2 >> 15)
    mag = (baseK2 - ek2) | (y2 & c["mkeep2"])
    nz2 = (ek2 + 0x7FFF7FFF) & 0x80008000
    sgn = (u2 & nz2) >> c["sign_shift"]
    return sgn | (mag & okm) | (c["flush2"] & ~okm & _U32)


def _decode_pair(p2, base2, c: dict):
    """``decode_pair``: two payload words -> two bf16 bit patterns."""
    s = (p2 & c["magm2"]) << c["man_shift"]
    nz = ((s ^ c["flush7"]) + 0x7FFF7FFF) & 0x80008000
    t2 = base2 - (s & 0x7F807F80)
    m = t2 & nz
    e = t2 & (m - (m >> 8))
    return (((p2 << c["sign_shift"]) & _U32) & nz) | e | (s & 0x007F007F)


def _thread_pairs(vals):
    """(R, 128) int64 16-bit values -> the 4 pair registers of each of the
    row's 16 threads, each (R, 16): value 8t + 2k in the low half of
    register k of thread t, 8t + 2k + 1 in its high half."""
    v = vals.reshape(-1, BITPLANE_ROW_THREADS, 8)
    return [v[..., 2 * k] | (v[..., 2 * k + 1] << 16) for k in range(4)]


def _put_planes(w, P: int):
    """``put_planes``: a thread's 4 word pairs -> byte t of planes 0..P-1
    (bytes p of lo, hi, lo2, hi2)."""
    lo, hi = _transpose8x8(_byte_perm(w[0], w[1], 0x6420),
                           _byte_perm(w[2], w[3], 0x6420))
    zero = torch.zeros_like(lo)
    lo2, hi2 = ((_transpose8x8(_byte_perm(w[0], w[1], 0x7531),
                               _byte_perm(w[2], w[3], 0x7531)))
                if P > 8 else (zero, zero))
    regs = (lo, hi, lo2, hi2)
    return [(regs[p >> 2] >> (8 * (p & 3))) & 0xFF for p in range(P)]


def _get_planes(b, P: int):
    """``get_planes``: byte t of planes 0..P-1 -> the thread's 4 word
    pairs."""
    q = [torch.zeros_like(b[0]) for _ in range(4)]
    for p in range(P):
        q[p >> 2] = q[p >> 2] | (b[p] << (8 * (p & 3)))
    q[0], q[1] = _transpose8x8(q[0], q[1])
    if P > 8:
        q[2], q[3] = _transpose8x8(q[2], q[3])
    return [_byte_perm(q[0], q[2], 0x5140), _byte_perm(q[0], q[2], 0x7362),
            _byte_perm(q[1], q[3], 0x5140), _byte_perm(q[1], q[3], 0x7362)]


def _image_offsets(R: int, P: int):
    """(tile index, image byte) of byte t of plane p of every row: (R, 16)
    tensors for each p."""
    tile = bitplane_tile_rows(R)
    r = torch.arange(R).reshape(R, 1)
    t = torch.arange(BITPLANE_ROW_THREADS).reshape(1, -1)
    return tile, r // tile, [(r % tile) * 16 * P + 16 * p + t
                             for p in range(P)]


def _pack_image(w, base, R: int, P: int):
    """Each thread's plane bytes and each row's base into its tile's
    shared-memory image, then the images out as the kernel's 16-byte
    stores copy them: (planes (R, P*16) uint8, bases (R, 1) uint8)."""
    tile, ti, offs = _image_offsets(R, P)
    T = -(-R // tile)
    img = torch.zeros((T, tile * _IMAGE_ROW + tile), dtype=torch.int64)
    for off, byte in zip(offs, _put_planes(w, P)):
        img[ti.expand_as(off), off] = byte
    r = torch.arange(R)
    img[r // tile, tile * _IMAGE_ROW + r % tile] = base.reshape(R)
    planes = torch.cat([img[i, :min(tile, R - i * tile) * 16 * P]
                        for i in range(T)])
    bases = torch.cat([img[i, tile * _IMAGE_ROW:][:min(tile, R - i * tile)]
                       for i in range(T)])
    return (planes.reshape(R, 16 * P).to(torch.uint8),
            bases.reshape(R, 1).to(torch.uint8))


def _unpack_image(planes: torch.Tensor, P: int):
    """The tile images the unpack's 16-byte copies fill, and each thread's
    P plane bytes gathered from them -> its 4 word pairs."""
    R = planes.shape[0]
    tile, ti, offs = _image_offsets(R, P)
    T = -(-R // tile)
    img = torch.zeros((T, tile * _IMAGE_ROW), dtype=torch.int64)
    flat = planes.reshape(-1).to(torch.int64)
    for i in range(T):
        n = min(tile, R - i * tile) * 16 * P
        img[i, :n] = flat[i * tile * 16 * P:][:n]
    return _get_planes([img[ti.expand_as(off), off] for off in offs], P)


def _pairs_to_words(w, R: int):
    """4 pair registers of each thread -> (R, 128) int32 words."""
    lanes = [x for k in range(4) for x in (w[k] & 0xFFFF, w[k] >> 16)]
    return torch.stack(lanes, -1).reshape(R, GROUP).to(torch.int32)


def bitplane_encode_swar(words: torch.Tensor, payload_bits: int
                         ) -> torch.Tensor:
    """The pack kernel's plane assembly: (R, 128) payload words of
    ``payload_bits`` bits -> (R, P*16) uint8 planes, equal to
    ``plane_pack_words``."""
    R = words.shape[0]
    w = _thread_pairs(words.to(torch.int64) & 0xFFFF)
    return _pack_image(w, torch.zeros(R, dtype=torch.int64), R,
                       payload_bits)[0]


def bitplane_decode_swar(planes: torch.Tensor, payload_bits: int
                         ) -> torch.Tensor:
    """The unpack kernel's plane reads: (R, P*16) uint8 -> (R, 128) int32
    words, equal to ``plane_unpack_words``."""
    return _pairs_to_words(_unpack_image(planes, payload_bits),
                           planes.shape[0])


def _unpadded(f: PackFields) -> PackFields:
    """``unpadded``: the pair geometry of a word, P' = 1 + E + K bits (a
    fixed-lane word's man_shift padding bits below its mantissa off)."""
    return PackFields(f.man_keep, f.dexp_bits, 1 + f.dexp_bits + f.man_keep)


def pair_route(dtype: torch.dtype, fields: PackFields) -> bool:
    """Whether the kernels encode and decode two values a register: bf16
    with a delta field of at most 8 bits, which the pair decode holds. f32
    and wider bf16 delta fields (``sfp16-m3e10``, ``sfp16-m1e14``) take
    ``sfp_encode_word`` / ``sfp_decode_word``, one value a register."""
    return dtype == torch.bfloat16 and fields.dexp_bits <= 8


def _pack_pairs(x: torch.Tensor, fields: PackFields, n=None):
    """The pack kernels' encode: (R, 128) bf16/f32 -> (each thread's 4
    word pairs, (R, 16) each; the row bases (R, 1) int64). On the pair
    route (``pair_route``) by the pair encode at P', each pair shifted
    left by the word's padding; else by ``sfp_encode_word``, one value a
    register."""
    if not pair_route(x.dtype, fields):
        words, base = _pack_words(x, fields, containers.spec_for(x), n)
        return (_thread_pairs(words.to(torch.int64) & 0xFFFF),
                base.to(torch.int64))
    K = fields.man_keep
    keep = containers.mantissa_keep_mask(7 if n is None else n,
                                         containers.spec_for(x))
    c = _pair_fields(_unpadded(fields), int(keep))
    u2 = _thread_pairs(x.view(torch.int16).to(torch.int64) & 0xFFFF)
    y2 = [u >> c["man_shift"] for u in u2]
    ek2 = [y & c["emask2"] for y in y2]
    mh = torch.stack(ek2).amax(0)                         # high halves
    ml = torch.stack([(e << 16) & _U32 for e in ek2]).amax(0)
    emax = torch.maximum(mh, ml) >> 16                    # (R, 16) threads
    baseK = emax.amax(-1, keepdim=True)                   # half-warp max
    base = baseK >> K
    lo = torch.clamp(base - fields.dexp_max, min=1)
    c2 = _twice(0x8000 - (lo << K))
    return [_encode_pair(u, y, e, c2, _twice(baseK), c) << fields.man_shift
            for u, y, e in zip(u2, y2, ek2)], base


def _unpack_pairs(w, bases: torch.Tensor, dtype: torch.dtype,
                  fields: PackFields) -> torch.Tensor:
    """The unpack kernels' decode: each thread's 4 word pairs and the row
    bases (R, 1) -> (R, 128) floats. On the pair route by the pair decode
    at P' of each pair shifted right by the word's padding (the high
    word's padding lands in the low half's bits P'..15, which the decode
    masks off); else by ``sfp_decode_word``, one value a register."""
    R = bases.shape[0]
    if not pair_route(dtype, fields):
        return _unpack_words(_pairs_to_words(w, R), bases.to(torch.int32),
                             fields, containers.spec_for(dtype))
    b2 = _twice((bases.to(torch.int64) + 256) << 7)
    c = _pair_fields(_unpadded(fields), 0x7F)
    bits = _pairs_to_words([_decode_pair(p >> fields.man_shift, b2, c)
                            for p in w], R)
    return bits.to(torch.int16).view(torch.bfloat16)


def bitplane_pack_swar(x: torch.Tensor, fields: PackFields, n=None):
    """``bitplane_pack`` (``n``: ``bitplane_quantize_pack``) as the kernel
    computes it: (R, 128) bf16/f32 -> (planes (R, P*16), bases (R, 1))
    uint8, equal to ``bitplane_pack_rows``."""
    w, base = _pack_pairs(x, fields, n)
    return _pack_image(w, base, x.shape[0], fields.payload_bits)


def bitplane_unpack_swar(planes: torch.Tensor, bases: torch.Tensor,
                         dtype: torch.dtype, fields: PackFields
                         ) -> torch.Tensor:
    """``bitplane_unpack`` as the kernel computes it: (R, P*16) planes +
    (R, 1) bases -> (R, 128) floats, equal to ``bitplane_unpack_rows``."""
    return _unpack_pairs(_unpack_image(planes, fields.payload_bits), bases,
                         dtype, fields)


# The fixed-lane word kernels' arithmetic (csrc/sfp_pack.cu) step for
# step, on the bit-plane kernels' pair encode and decode: a thread per 8
# lanes, its 8 words stored and loaded as one 16-byte (sfp16) or 8-byte
# (sfp8: the pairs' low bytes by __byte_perm) chunk at byte 16 t or 8 t of
# its row, the row's base stored by its first thread. For the tests: equal
# to sfp_pack_rows / sfp_unpack_rows; the kernels can only be run on the
# card.


def sfp_pack_swar(x: torch.Tensor, fields: PackFields, n=None):
    """``sfp_pack`` (``n``: ``sfp_quantize_pack``) as the kernel computes
    it: (R, 128) bf16/f32 -> (payload (R, 128) words, bases (R, 1) uint8),
    equal to ``sfp_pack_rows``."""
    R = x.shape[0]
    w, base = _pack_pairs(x, fields, n)
    regs = w if fields.payload_bits == 16 else [
        _byte_perm(w[0], w[1], 0x6420), _byte_perm(w[2], w[3], 0x6420)]
    chunk = torch.stack([b for reg in regs for b in _lanes4(reg)], -1)
    payload = chunk.reshape(R, -1).to(torch.uint8).view(fields.word_dtype)
    return payload, base.reshape(R, 1).to(torch.uint8)


def sfp_unpack_swar(payload: torch.Tensor, bases: torch.Tensor,
                    dtype: torch.dtype, fields: PackFields) -> torch.Tensor:
    """``sfp_unpack`` as the kernel computes it: (R, 128) words + (R, 1)
    bases -> (R, 128) floats, equal to ``sfp_unpack_rows``."""
    R = payload.shape[0]
    chunk = payload.contiguous().view(torch.uint8).reshape(
        R, BITPLANE_ROW_THREADS, -1).to(torch.int64)
    regs = [_word([chunk[..., 4 * j + i] for i in range(4)])
            for j in range(chunk.shape[-1] // 4)]
    if fields.payload_bits == 8:     # bytes 2k, 2k + 1 into the halves
        zero = torch.zeros_like(regs[0])
        regs = [_byte_perm(regs[k >> 1], zero, 0x4342 if k & 1 else 0x4140)
                for k in range(4)]
    return _unpack_pairs(regs, bases, dtype, fields)


# ---------------------------------------------------------------------------
# Decode over the packed KV cache
# ---------------------------------------------------------------------------


def decode_kv_mask(pos, L: int, window: Optional[int] = None, slots=None):
    """Validity of each KV-cache slot for a decode query at ``pos``.

    Global caches store position p at slot p. Local caches are L-slot
    ring buffers: slot s holds the latest position p <= pos with
    p = s (mod L), valid inside the window. The modulus is a floor mod
    (``torch.remainder``), as in the JAX package."""
    if slots is None:
        slots = torch.arange(L, device=pos.device if isinstance(
            pos, torch.Tensor) else None)
    if window is None:
        return (slots <= pos) & (slots < L)
    k_pos = pos - torch.remainder(pos - slots, L)
    return ((k_pos >= 0) & (k_pos <= pos) & (k_pos > pos - window)
            & (slots < L))


def _decode_blocks(q, k_payload, k_bases, v_payload, v_bases, pos,
                   fields: PackFields, *, window, softcap, bl: int,
                   prefix_planes, slot0: int, L_global: int):
    """The online-softmax block recurrence of the packed decode over a
    cache's L slots, slots [slot0, slot0 + L) of an L_global-slot cache,
    in ``bl``-slot blocks (the last one partial where bl does not divide
    L). Returns f32 (m, l, acc): (B, KH, rep, 1), (B, KH, rep, 1) and
    (B, KH, rep, hd)."""
    B, _, H, hd = q.shape
    L, G = k_bases.shape[1], k_bases.shape[2]
    D = G * GROUP
    KH = D // hd
    rep = H // KH
    spec = containers.spec_for(q.dtype)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=q.device)
    pos = pos.reshape(-1).expand(B)

    def unp(payload, bases):
        x = unpack_tile(payload.reshape(B * L, -1), bases.reshape(B * L, G),
                        fields, spec, rows=B * L, KH=KH, hd=hd,
                        prefix_planes=prefix_planes)
        return x.reshape(B, L, KH, hd)

    k = unp(k_payload, k_bases)
    v = unp(v_payload, v_bases)
    qf = q.reshape(B, KH, rep, hd).to(torch.float32)
    scale = 1.0 / (hd ** 0.5)
    m = torch.full((B, KH, rep, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KH, rep, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KH, rep, hd), dtype=torch.float32, device=q.device)
    for lo in range(0, L, bl):
        hi = min(lo + bl, L)
        k_c, v_c = k[:, lo:hi], v[:, lo:hi]
        s = torch.einsum("bhgd,blhd->bhgl", qf, k_c) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        slots = slot0 + torch.arange(lo, hi, device=q.device)
        valid = decode_kv_mask(pos[:, None], L_global, window,
                               slots=slots[None])
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_cur = torch.amax(s, dim=-1, keepdim=True)
        m_new = torch.maximum(m, m_cur)
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgl,blhd->bhgd", p, v_c)
        m = m_new
    return m, l, acc


def _divisor_block(L: int, block_l: Optional[int]) -> int:
    """``block_l`` shrunk to a divisor of L (L itself when None)."""
    bl = L if block_l is None else min(block_l, L)
    while L % bl:
        bl -= 1
    return bl


def packed_flash_decode(q: torch.Tensor, k_payload: torch.Tensor,
                        k_bases: torch.Tensor, v_payload: torch.Tensor,
                        v_bases: torch.Tensor, pos, fields: PackFields, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        block_l: Optional[int] = None,
                        prefix_planes: Optional[int] = None) -> torch.Tensor:
    """Unpack-then-attend decode over a packed contiguous cache.

    q (B, 1, H, hd); payload (B, L, nd_payload_cols(KH*hd)) words or bit
    planes; bases (B, L, KH*hd//128);
    ``pos`` scalar or (B,). Same online-softmax block recurrence over
    ``block_l``-slot blocks as the kernel (the block shrinks to a divisor
    of L); batch rows are independent, so they run side by side.
    ``prefix_planes`` is the draft read mode (see ``unpack_tile``)."""
    B, _, H, hd = q.shape
    L = k_bases.shape[1]
    _, l, acc = _decode_blocks(
        q, k_payload, k_bases, v_payload, v_bases, pos, fields,
        window=window, softcap=softcap, bl=_divisor_block(L, block_l),
        prefix_planes=prefix_planes, slot0=0, L_global=L)
    o = acc / torch.clamp(l, min=1e-30)
    return o.reshape(B, 1, H, hd).to(q.dtype)


def packed_flash_decode_shard(q: torch.Tensor, k_payload: torch.Tensor,
                              k_bases: torch.Tensor, v_payload: torch.Tensor,
                              v_bases: torch.Tensor, pos,
                              fields: PackFields, *, slot0: int,
                              L_global: int, window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              block_l: Optional[int] = None,
                              prefix_planes: Optional[int] = None):
    """The shard view of ``packed_flash_decode``: the cache holds slots
    [slot0, slot0 + L) of an ``L_global``-slot cache (a ring of L_global
    slots under ``window``), each masked at its global slot. The blocks
    are ``block_l`` shrunk to a divisor of L_global, counted from the
    shard's first slot, the last one partial. Returns f32 (o (B, H, hd),
    lse (B, H)): the normalized softmax over the shard's visible slots
    and the log-sum-exp of their scores, -inf where none is visible (so
    ``sharding.lse_combine`` gives it weight 0)."""
    B, _, H, hd = q.shape
    m, l, acc = _decode_blocks(
        q, k_payload, k_bases, v_payload, v_bases, pos, fields,
        window=window, softcap=softcap,
        bl=_divisor_block(L_global, block_l), prefix_planes=prefix_planes,
        slot0=slot0, L_global=L_global)
    # A block with no visible slot before the first visible one adds
    # exp(0) terms that the next visible block's alpha of 0 removes; m
    # stays NEG_INF only where no slot is visible.
    seen = m > NEG_INF
    o = torch.where(seen, acc / torch.clamp(l, min=1e-30), 0.0)
    lse = torch.where(seen, m + torch.log(l), -torch.inf)
    return o.reshape(B, H, hd), lse.reshape(B, H)


def paged_gather(part: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Pool blocks gathered into per-row contiguous sequences: ``part``
    (P_blocks, block_l, ...), ``tables`` (B, nb) physical block ids per
    logical block -> (B, nb * block_l, ...)."""
    g = part[tables.long()]
    return g.reshape(g.shape[0], -1, *g.shape[3:])


def paged_flash_decode(q: torch.Tensor, k_payload: torch.Tensor,
                       k_bases: torch.Tensor, v_payload: torch.Tensor,
                       v_bases: torch.Tensor, tables: torch.Tensor, pos,
                       fields: PackFields, *,
                       softcap: Optional[float] = None,
                       prefix_planes: Optional[int] = None) -> torch.Tensor:
    """Gather-unpack-attend decode over a paged pool: pool parts
    (P_blocks, block_l, cols) / (P_blocks, block_l, G), ``tables`` (B, nb),
    ``pos`` (B,) or scalar. The block recurrence of ``packed_flash_decode``
    with block_l = the pool block, global attention only (logical slots
    past ``pos`` are masked, so trash-block entries are no-ops)."""
    block_l = k_payload.shape[1]
    return packed_flash_decode(
        q, paged_gather(k_payload, tables), paged_gather(k_bases, tables),
        paged_gather(v_payload, tables), paged_gather(v_bases, tables),
        pos, fields, window=None, softcap=softcap, block_l=block_l,
        prefix_planes=prefix_planes)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, prefix_len: int = 0,
              q_offset: int = 0, q_rep: int = 1) -> torch.Tensor:
    """Dense GQA attention in f32, O(Sq*Sk). q (B, Sq, H, D), k/v
    (B, Sk, KH, D); q head h reads kv head h // (H // KH).

    The mask is the JAX package's: causal and window terms, then the first
    ``prefix_len`` keys visible to every query (a prefix-LM's
    conditioning). ``q_offset`` is the absolute position of q's first row.
    ``q_rep`` > 1 is the folded layout of the flash kernel: q is
    (B, S*q_rep, KH, D), rows ordered (seq, group member), so the causal
    position of query row r is q_offset + r // q_rep."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    rep = H // KH
    kq = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vq = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          kq.to(torch.float32)) * scale.to(q.device)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    q_pos = q_offset + (torch.arange(Sq, device=q.device) // q_rep)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = k_pos <= q_pos
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    if prefix_len > 0:
        mask = mask | (k_pos < prefix_len)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vq.to(torch.float32))
    return out.to(q.dtype)
