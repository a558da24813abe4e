"""Gecko delta-mode exponent pack and unpack: CUDA kernel wrappers and
their plain versions.

Replace the TPU kernels ``src/repro/kernels/gecko_pack.py:gecko_pack`` and
``gecko_unpack``. The kernels are in ``csrc/gecko_pack.cu``: a lane per
group, each row's planes built or read by a register SWAR bit transpose and
byte-SIMD deltas, warps striding over 32-group tiles staged through shared
memory with 16-byte ``cp.async`` copies, two tiles in flight. Any group
count G works, with no padding. Both are bound by memory on the H100: 64 +
78 bytes per group for the pack, 71 + 64 for the unpack.
``ref.gecko_plane_{encode,decode}_swar`` mirror their arithmetic on the
CPU, for the tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref
from repro_torch.kernels.ref import GECKO_GROUP, GECKO_PLANE_BYTES

plain = ref.gecko_plane_encode
plain_unpack = ref.gecko_plane_decode


def _check(name: str, part: str, t: torch.Tensor, cols: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors, got {part} on "
                         f"{t.device}")
    if t.dtype != torch.uint8 or t.dim() != 2 or t.shape[1] != cols:
        raise ValueError(f"{name} takes {part} as (G, {cols}) uint8, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous, 16-byte aligned "
                         f"{part}")


def gecko_pack(groups: torch.Tensor):
    """(G, 64) uint8 exponent groups -> (bases (G, 8), widths (G, 7),
    planes (G, 63)) uint8. A CPU tensor takes the plain version; any other
    tensor launches the CUDA kernel or raises."""
    if groups.device.type == "cpu":
        return plain(groups)
    lib = _lib.load()
    _check("gecko_pack", "groups", groups, GECKO_GROUP)
    G = groups.shape[0]
    bases, widths, planes = (torch.empty((G, c), dtype=torch.uint8,
                                         device=groups.device)
                             for c in (8, ref.GECKO_ROWS, GECKO_PLANE_BYTES))
    err = lib.gecko_pack_launch(groups.data_ptr(), bases.data_ptr(),
                                widths.data_ptr(), planes.data_ptr(), G,
                                _lib.stream_ptr(groups))
    _lib.check(err, "gecko_pack")
    gecko_pack.launches += 1
    return bases, widths, planes


def gecko_unpack(bases: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """(bases (G, 8), planes (G, 63)) uint8 -> (G, 64) uint8 exponents."""
    if bases.device.type == "cpu":
        return plain_unpack(bases, planes)
    lib = _lib.load()
    _check("gecko_unpack", "bases", bases, 8)
    _check("gecko_unpack", "planes", planes, GECKO_PLANE_BYTES)
    G = bases.shape[0]
    if planes.shape[0] != G:
        raise ValueError(f"gecko_unpack: {G} bases rows but "
                         f"{planes.shape[0]} planes rows")
    out = torch.empty((G, GECKO_GROUP), dtype=torch.uint8,
                      device=bases.device)
    err = lib.gecko_unpack_launch(bases.data_ptr(), planes.data_ptr(),
                                  out.data_ptr(), G, _lib.stream_ptr(bases))
    _lib.check(err, "gecko_unpack")
    gecko_unpack.launches += 1
    return out


gecko_pack.launches = 0
gecko_unpack.launches = 0
