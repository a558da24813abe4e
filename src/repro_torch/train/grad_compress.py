"""Compressed gradients with error feedback (the port of
``repro.train.grad_compress``).

Gradients go through a registry codec's pack -> unpack round trip, as
they would before a cross-device reduction, and the quantization error is
kept in a local *error-feedback* residual that is added back next step
(the usual convergence-preserving trick for biased compressors). The wire
format is the codec's: ``bit_exact`` (the default) truncates mantissas
(the ``mantissa_quantize`` kernel on the card), ``sfp8`` / ``sfp16`` are
fixed-lane words, ``sfp-m{K}e{E}`` dense bit planes, ``gecko8`` the Gecko
exponent stream.

The train step runs the round trip on each rank's local gradient shards
(``compress_grads`` works leaf by leaf and shard by shard, as JAX's does
under GSPMD). ``psum_compressed`` is the collective building block: the
round trip, then the bf16 payloads summed over a process group and
averaged.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch import codecs
from repro_torch.core.stash import float_leaves, substitute
from repro_torch.kernels.sfp_pack import device_bits
from repro_torch.optim import adamw


def compress_grads(grads: Any, residual: Any, bits,
                   codec: str = codecs.BIT_EXACT) -> Tuple[Any, Any]:
    """Error-feedback codec round trip of a nest of gradients (dicts and
    lists of tensors) against an f32 residual of the same structure:
    per leaf ``gf = g.float() + r``, ``q = roundtrip(gf, bits)``, new
    residual ``gf - q``. Returns (the q nest, the new residual nest).

    In place, leaf by leaf: the new residual is written over ``residual``,
    and an f32 gradient's ``gf`` and then its ``q`` over the gradient
    itself, so the caller holds no second copy of either (at gemma2-2b's
    full width the embedding's gradient alone is 2.36 GB). ``bits`` is an
    int or a 0-d integer tensor on the gradients' device; an int goes to
    the device once for all leaves."""
    cd = codecs.get(codec)
    g_leaves = float_leaves(grads)
    r_leaves = [r for _, r in float_leaves(residual)]
    out = {}
    with torch.no_grad():
        for (path, g), r in zip(g_leaves, r_leaves):
            bits = device_bits(bits, g.device)
            gf = g.add_(r) if g.dtype == torch.float32 else g.float() + r
            q = cd.roundtrip(gf, bits=bits)
            torch.sub(gf, q, out=r)
            if gf is g:
                out[path] = g.copy_(q)
            else:
                out[path] = q
    return substitute(grads, out), residual


def init_residual(grads_like: Any) -> Any:
    """An f32 zero residual shaped like ``grads_like`` (a nest of dicts and
    lists of tensors), on their devices."""
    return adamw.zeros_like(grads_like)


def psum_compressed(grads: Any, residual: Any, bits, group,
                    codec: str = codecs.BIT_EXACT) -> Tuple[Any, Any]:
    """The error-feedback round trip of this rank's ``grads`` (in place, as
    ``compress_grads``), then each leaf's bf16 payload all-reduced over
    ``group`` and divided by its size, in f32. Returns (the mean nest, the
    new residual nest). The wire carries bf16 containers with
    ``bits``-bit mantissas (the Gecko exponent packing applies on top in
    the hardware realization). The backend sums the bf16 payloads in its
    own order, so the mean can differ from JAX's (whose XLA:CPU psum
    accumulates in f32) by the rounding of a bf16 sum."""
    q, new_res = compress_grads(grads, residual, bits, codec)
    n = dist.get_world_size(group)
    out = {}
    for path, t in float_leaves(q):
        wire = t.to(torch.bfloat16)
        dist.all_reduce(wire, group=group)
        out[path] = wire.to(torch.float32) / n
    return substitute(q, out), new_res
