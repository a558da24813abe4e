"""Mantissa truncation Q(M, n): CUDA kernel wrapper and its plain version.

Replaces the TPU kernel ``src/repro/kernels/mantissa_quant.py:
mantissa_quantize``. The kernel is ``csrc/mantissa_quant.cu``: a
grid-stride pass over 16-byte vectors that ANDs every 16- or 32-bit word
with the mask keeping sign, exponent and the top ``n`` mantissa bits
(``n`` read from device memory). It is bound by memory on the H100: each
word is read once and written once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref
from repro_torch.kernels.sfp_pack import device_bits

plain = ref.mantissa_truncate

_FLOAT_BITS = {torch.bfloat16: 16, torch.float32: 32}


def mantissa_quantize(x: torch.Tensor, n) -> torch.Tensor:
    """Truncate the mantissas of ``x`` (any shape, bf16/f32) to ``n`` bits
    (an int or a 0-d integer tensor on x's device). A CPU tensor takes the
    plain version; any other tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return plain(x, n)
    lib = _lib.load()
    if not x.is_cuda:
        raise ValueError(f"mantissa_quantize needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _FLOAT_BITS:
        raise ValueError(f"mantissa_quantize takes bf16 or f32, got "
                         f"{x.dtype}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("mantissa_quantize needs a 16-byte aligned input")
    nd = device_bits(n, x.device)
    out = torch.empty_like(x)
    err = lib.mantissa_quantize_launch(x.data_ptr(), nd.data_ptr(),
                                       out.data_ptr(), x.numel(),
                                       _FLOAT_BITS[x.dtype],
                                       _lib.stream_ptr(x))
    _lib.check(err, "mantissa_quantize")
    mantissa_quantize.launches += 1
    return out


mantissa_quantize.launches = 0
