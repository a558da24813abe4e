"""gecko8: the paper's delta-mode exponent compression, realized.

``core/gecko.py`` counts the bits of the 8x8 delta scheme; this codec
builds it. A float tensor becomes

  signman  one byte per value: sign << 7 | the top 7 mantissa bits (after
           the Q(M, n) truncation, fused into the byte build);
  bases    (G, 8) uint8 Gecko column bases (row 0 of each 8x8 group);
  widths   (G, 7) uint8 magnitude bitwidths of the delta rows (the
           reference encoder's ``row_widths``);
  planes   (G, 63) uint8 dense sign+magnitude bit planes (a row of width
           w has w + 1 meaningful plane bytes, the rest are 0),

with the exponents flattened into G edge-padded groups of 64. The device
form keeps the planes dense (fixed shapes); ``stream_from_parts``
compacts them on the host into the byte-aligned stream

  [bases: 8G bytes][widths: two 4-bit nibbles per byte, 4G bytes]
  [row payload in (group, row, plane) order: w + 1 bytes per row, rows
   with w == 0 left out]

which costs exactly ``core.gecko.delta_bits`` plus 11 bits per group (the
width fields byte-aligned to nibbles instead of 3 bits), and which
``packed_bits`` prices. bf16 round-trips bit for bit: sign and all 7
mantissa bits live in signman, the exponents are Gecko-lossless.

The exponent planes go through ``ops.gecko_encode`` / ``gecko_decode``:
the ``gecko_pack`` / ``gecko_unpack`` CUDA kernels on the card, their
plain versions on the CPU. ``encode_host`` packs a tensor on its own
device (a CUDA tensor through the kernel, only the parts crossing to the
host) and a numpy array on the CPU, into the same bytes; ``decode_host``
unpacks on the device it is given and returns a tensor (numpy has no
bf16).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.codecs import base
from repro_torch.core import containers
from repro_torch.kernels import ops
from repro_torch.kernels.ref import GECKO_GROUP, GECKO_PLANES, GECKO_ROWS

GECKO8 = "gecko8"
_SIGNMAN_BITS = 8           # 1 sign + 7 mantissa bits per value
_WIDTH_BYTES = 4            # 7 x 4-bit width nibbles, byte-aligned
_HEADER_BYTES = 8 + _WIDTH_BYTES  # per-group bases + widths


def _exponent_groups(e: torch.Tensor) -> torch.Tensor:
    """A uint8 exponent stream as edge-padded (G, 64) groups (edge
    replication keeps padded deltas at zero cost, as in core/gecko)."""
    flat = e.reshape(-1)
    pad = (-flat.numel()) % GECKO_GROUP
    if pad:
        flat = torch.cat([flat, flat[-1:].expand(pad)])
    return flat.reshape(-1, GECKO_GROUP)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class Gecko8Codec(base.Codec):
    name = GECKO8

    def pack(self, x: torch.Tensor, bits=None) -> base.PackedTensor:
        spec = containers.spec_for(x)
        sign, e, man = containers.split_fields(x)
        if bits is not None:
            keep = containers.mantissa_keep_mask(bits, spec, x.device)
            man = man & keep.to(torch.int32)
        man_top = man >> (spec.man_bits - 7)
        signman = ((sign << 7) | man_top).to(torch.uint8)
        bases, widths, planes = ops.gecko_encode(
            _exponent_groups(e.to(torch.uint8)))
        return base.PackedTensor(self.name, x.shape, x.dtype, {
            "signman": signman, "bases": bases, "widths": widths,
            "planes": planes})

    def unpack(self, packed: base.PackedTensor) -> torch.Tensor:
        spec = containers.spec_for(packed.dtype)
        n = math.prod(packed.shape)
        e = ops.gecko_decode(packed.data["bases"], packed.data["planes"])
        e = e.reshape(-1)[:n].reshape(packed.shape).to(torch.int32)
        b = packed.data["signman"].reshape(packed.shape).to(torch.int32)
        sign = (b >> 7) & 1
        man = (b & 0x7F) << (spec.man_bits - 7)
        return containers.combine_fields(sign, e, man, spec)

    def lossless_for(self, dtype) -> bool:
        """Bit-exact exactly when the source mantissa fits in 7 bits."""
        return containers.spec_for(dtype).man_bits <= 7

    def packed_bits(self, x: torch.Tensor, bits=None) -> float:
        """The byte-aligned stream's bits: signman plus the compacted
        exponent stream (independent of ``bits``)."""
        _, e, _ = containers.split_fields(x)
        _, widths, _ = ops.gecko_encode(_exponent_groups(e.to(torch.uint8)))
        return float(x.numel() * _SIGNMAN_BITS + _stream_bits(widths))

    # -- host-side byte-aligned stream --------------------------------------

    def encode_host(self, arr, bits: Optional[int] = None
                    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Pack an array or a tensor into one uint8 stream (signman, then
        the compacted exponent stream) and its JSON-able meta."""
        packed = self.pack(base.as_tensor(arr), bits)
        signman = _host(packed.data["signman"]).reshape(-1)
        gecko_stream = stream_from_parts(*(_host(packed.data[k]) for k in
                                           ("bases", "widths", "planes")))
        meta = {"n_values": int(signman.size),
                "n_groups": int(packed.data["bases"].shape[0])}
        if bits is not None:
            meta["bits"] = int(bits)
        return np.concatenate([signman, gecko_stream]), meta

    def decode_host(self, stream: np.ndarray, meta: Dict[str, Any],
                    shape: Tuple[int, ...], dtype: torch.dtype,
                    device=None) -> torch.Tensor:
        """Invert ``encode_host``: a tensor of ``shape`` and ``dtype``,
        unpacked on ``device`` (default the CPU)."""
        n, g = int(meta["n_values"]), int(meta["n_groups"])
        bases, widths, planes = parts_from_stream(stream[n:], g)
        parts = {"signman": np.array(stream[:n]).reshape(shape),
                 "bases": bases, "widths": widths, "planes": planes}
        packed = base.PackedTensor(self.name, shape, dtype, {
            k: torch.from_numpy(v).to(device) for k, v in parts.items()})
        return self.unpack(packed)


# ---------------------------------------------------------------------------
# Exponent-stream entry points (the §IV-C mechanism itself; the float codec
# above composes them with the signman byte).
# ---------------------------------------------------------------------------


def pack_exponent_stream(e) -> Tuple[np.ndarray, int]:
    """uint8 exponent stream -> (byte-aligned packed stream, n_values)."""
    e = base.as_tensor(e)
    bases, widths, planes = ops.gecko_encode(_exponent_groups(e))
    return stream_from_parts(_host(bases), _host(widths),
                             _host(planes)), int(e.numel())


def unpack_exponent_stream(stream: np.ndarray, n_values: int) -> np.ndarray:
    """Invert ``pack_exponent_stream`` bit for bit."""
    n_groups = -(-n_values // GECKO_GROUP)
    bases, _, planes = parts_from_stream(np.asarray(stream), n_groups)
    e = ops.gecko_decode(torch.from_numpy(bases), torch.from_numpy(planes))
    return e.numpy().reshape(-1)[:n_values]


def _row_lengths(widths: np.ndarray) -> np.ndarray:
    """Payload bytes per delta row: w + 1 plane bytes, 0 for all-zero
    rows."""
    w = widths.astype(np.int64)
    return np.where(w > 0, w + 1, 0)


def _stream_bits(widths) -> int:
    lengths = _row_lengths(_host(widths))
    g = lengths.shape[0]
    return int(8 * (g * _HEADER_BYTES + lengths.sum()))


def stream_bytes(widths) -> int:
    """Exact size of the byte-aligned stream for the given row widths."""
    return _stream_bits(widths) // 8


def _pack_width_nibbles(widths: np.ndarray) -> np.ndarray:
    """(G, 7) widths (0..8) -> (G, 4) bytes, two 4-bit nibbles per byte."""
    w = np.concatenate([widths.astype(np.uint8),
                        np.zeros((widths.shape[0], 1), np.uint8)], axis=1)
    return (w[:, 0::2] | (w[:, 1::2] << 4)).astype(np.uint8)


def _unpack_width_nibbles(nib: np.ndarray) -> np.ndarray:
    w = np.zeros((nib.shape[0], 8), np.uint8)
    w[:, 0::2] = nib & 0x0F
    w[:, 1::2] = nib >> 4
    return w[:, :GECKO_ROWS]


def _plane_mask(widths: np.ndarray) -> np.ndarray:
    """(G, 7) -> (G, 7, 9) bool: the dense plane bytes the stream keeps,
    the first w + 1 planes of each row with w > 0. Flattened, the mask's
    order (group, row, plane) is the stream's payload order, so
    compaction is one boolean gather."""
    lengths = _row_lengths(widths)
    p = np.arange(GECKO_PLANES)
    return p[None, None, :] < lengths[..., None]


def stream_from_parts(bases: np.ndarray, widths: np.ndarray,
                      planes: np.ndarray) -> np.ndarray:
    """Compact the dense kernel outputs into the byte-aligned stream."""
    mask = _plane_mask(widths).reshape(-1)
    payload = planes.reshape(-1)[mask]
    return np.concatenate([
        bases.reshape(-1).astype(np.uint8),
        _pack_width_nibbles(widths).reshape(-1),
        payload.astype(np.uint8)])


def parts_from_stream(stream: np.ndarray, n_groups: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand a byte-aligned stream back into dense (bases, widths,
    planes)."""
    g = n_groups
    bases = stream[:8 * g].reshape(g, 8)
    nib = stream[8 * g:8 * g + _WIDTH_BYTES * g].reshape(g, _WIDTH_BYTES)
    widths = _unpack_width_nibbles(nib)
    payload = stream[(8 + _WIDTH_BYTES) * g:]
    mask = _plane_mask(widths).reshape(-1)
    planes = np.zeros(g * GECKO_ROWS * GECKO_PLANES, np.uint8)
    planes[np.flatnonzero(mask)] = payload[:int(mask.sum())]
    return (bases.astype(np.uint8), widths,
            planes.reshape(g, GECKO_ROWS * GECKO_PLANES))
