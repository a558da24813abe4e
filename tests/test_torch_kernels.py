"""The port's plain kernel versions against the JAX package.

Inputs are made with numpy from a seed and handed to both frameworks bit
for bit. The JAX side runs its Pallas kernels in interpret mode, or its
jnp oracles (``repro.kernels.ref``) for the bit machines.

Tolerances: the SFP word machine is integer arithmetic, so pack/unpack
and the ring mask must be equal. Attention and packed decode are compared
in f32 (inputs, accumulators and outputs), where the two sides differ
only in summation order and in exp/tanh rounding: a few f32 ulps on O(1)
outputs, held to atol = rtol = 2e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import codecs as jcodecs
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import packed_flash_decode as jpfd
from repro.kernels import ref as jref
from repro.kernels import sfp_pack as jsp
from repro_torch import codecs as tcodecs
from repro_torch.convert import to_tensor
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import packed_flash_decode as tpfd
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sfp_pack as tsp

torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=2e-5)


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy with the same bits (bf16 -> ml_dtypes bf16)."""
    if t.dtype == torch.bfloat16:
        return np.asarray(jax.lax.bitcast_convert_type(
            jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16))
    if t.dtype == torch.uint16:
        return t.to(torch.int32).numpy().astype(np.uint16)
    return t.numpy()


def _wide_range(rng, shape, dtype):
    """Values over a wide dynamic range with planted zeros, negative
    zeros and subnormals, so every flush and saturation rule fires."""
    x = rng.standard_normal(shape) * np.exp2(rng.integers(-40, 40, shape))
    flat = x.reshape(-1)
    idx = rng.permutation(flat.size)
    n = flat.size // 16
    flat[idx[:n]] = 0.0
    flat[idx[n:2 * n]] = -0.0
    flat[idx[2 * n:3 * n]] = 1e-39 * rng.standard_normal(n)  # subnormals
    t = torch.from_numpy(x.astype(np.float32)).to(dtype)
    return t


@pytest.mark.parametrize("container", ["sfp8", "sfp16"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sfp_pack_unpack_bit_exact(container, dtype):
    rng = np.random.default_rng(0)
    x = _wide_range(rng, (3, 5, 384), dtype)
    tf = tcodecs.fields_for(container, dtype)
    jf = jcodecs.fields_for(container, jnp.dtype(_np(x).dtype))
    assert tuple(tf) == tuple(jf)
    tp, tb = tref.sfp_pack_nd(x, tf)
    jp, jb = jref.sfp_pack_nd(jnp.asarray(_np(x)), jf)
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # The kernel wrapper on a CPU tensor is the plain version, row layout.
    kp, kb = tsp.sfp_pack(x.reshape(-1, 128), tf)
    jkp, jkb = jsp.sfp_pack(jnp.asarray(_np(x)).reshape(-1, 128), fields=jf,
                            interpret=True)
    np.testing.assert_array_equal(_np(kp), np.asarray(jkp))
    np.testing.assert_array_equal(kb.numpy(), np.asarray(jkb))
    # Unpack is the JAX oracle's, bit for bit.
    tu = tref.sfp_unpack_nd(tp, tb, dtype, tf)
    ju = jref.sfp_unpack_nd(jp, jb, jnp.dtype(_np(x).dtype), jf)
    np.testing.assert_array_equal(_np(tu).view(np.uint8),
                                  np.asarray(ju).view(np.uint8))


@pytest.mark.parametrize("container", ["sfp8", "sfp16"])
def test_codec_roundtrip_matches_jax(container):
    rng = np.random.default_rng(1)
    x = _wide_range(rng, (2, 7, 256), torch.bfloat16)
    tc = tcodecs.get(container)
    jc = jcodecs.get(container)
    tpk = tc.pack(x)
    jpk = jc.pack(jnp.asarray(_np(x)))
    np.testing.assert_array_equal(_np(tpk.data["payload"]),
                                  np.asarray(jpk.data["payload"]))
    np.testing.assert_array_equal(_np(tc.unpack(tpk)).view(np.uint16),
                                  np.asarray(jc.unpack(jpk)).view(np.uint16))
    assert tc.packed_bits(x) == jc.packed_bits(jnp.asarray(_np(x)))
    # Flat layout (last dim not a multiple of 128): tail padded to a row.
    y = _wide_range(rng, (3, 50), torch.bfloat16)
    tpk, jpk = tc.pack(y), jc.pack(jnp.asarray(_np(y)))
    np.testing.assert_array_equal(_np(tpk.data["payload"]),
                                  np.asarray(jpk.data["payload"]))
    np.testing.assert_array_equal(_np(tc.unpack(tpk)).view(np.uint16),
                                  np.asarray(jc.unpack(jpk)).view(np.uint16))


@pytest.mark.parametrize("L", [16, 40, 128])
@pytest.mark.parametrize("window", [None, 8, 16, 200])
def test_decode_kv_mask_grid(L, window):
    pos = np.arange(0, 3 * L + 5)
    slots = np.arange(L)
    want = np.asarray(jref.decode_kv_mask(jnp.asarray(pos)[:, None], L,
                                          window, slots=jnp.asarray(slots)))
    got = tref.decode_kv_mask(torch.from_numpy(pos)[:, None], L, window,
                              slots=torch.from_numpy(slots)[None])
    np.testing.assert_array_equal(got.numpy(), want)


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("window,softcap", [(None, None), (None, 50.0),
                                            (24, 50.0), (7, None)])
def test_flash_attention_plain_vs_jax_kernel(window, softcap):
    """Folded GQA (q_rep 2), head_dim 192, causal, in f32."""
    rng = np.random.default_rng(2)
    B, S, KH, rep, D = 2, 40, 2, 2, 192
    q = _f32(rng, (B, S * rep, KH, D))
    k = _f32(rng, (B, S, KH, D))
    v = _f32(rng, (B, S, KH, D))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, window=window, softcap=softcap,
                               q_rep=rep, block_q=32, block_k=16,
                               interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=window,
                              softcap=softcap, q_rep=rep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_ops_attention_gqa_fold_vs_jax():
    """The port's dispatch (plain route on the CPU) against the JAX
    dispatch in interpret mode, which folds the GQA group into rows."""
    rng = np.random.default_rng(3)
    B, S, H, KH, D = 1, 33, 4, 2, 192
    q, k, v = _f32(rng, (B, S, H, D)), _f32(rng, (B, S, KH, D)), \
        _f32(rng, (B, S, KH, D))
    jops.force_backend("interpret")
    try:
        want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=16, softcap=50.0)
    finally:
        jops.force_backend(None)
    got = tops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=True, window=16,
                         softcap=50.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("container", ["sfp8", "sfp16"])
@pytest.mark.parametrize("window,pos,L", [
    (None, [47, 47], 48),     # global, cache full
    (None, [10, 30], 48),     # global, per-row positions, masked tail
    (None, [39, 5], 40),      # L not a multiple of the block
    (16, [5, 9], 16),         # local ring, not yet wrapped
    (16, [37, 50], 16),       # local ring, wrapped
    (12, [40, 41], 16),       # ring longer than the window
])
def test_packed_flash_decode_plain_vs_jax_kernel(container, window, pos, L):
    """Identical packed inputs (packed once, by the JAX oracle) through the
    JAX kernel in interpret mode and the port's plain version, in f32,
    GQA rep 2, head_dim 192 (groups straddle heads)."""
    rng = np.random.default_rng(4)
    B, KH, rep, hd = 2, 2, 2, 192
    D = KH * hd
    f = jcodecs.fields_for(container, jnp.float32)
    k = jnp.asarray(_f32(rng, (B, L, D)))
    v = jnp.asarray(_f32(rng, (B, L, D)))
    q = _f32(rng, (B, 1, KH * rep, hd))
    kp, kb = jref.sfp_pack_nd(k, f)
    vp, vb = jref.sfp_pack_nd(v, f)
    posa = np.asarray(pos, np.int32)
    want = jpfd.packed_flash_decode(jnp.asarray(q), kp, kb, vp, vb,
                                    jnp.asarray(posa), fields=f,
                                    window=window, softcap=50.0, block_l=16,
                                    interpret=True)
    tf = tcodecs.fields_for(container, torch.float32)
    t = lambda a: to_tensor(np.asarray(a))
    got = tpfd.packed_flash_decode(torch.from_numpy(q), t(kp), t(kb), t(vp),
                                   t(vb), torch.from_numpy(posa), tf,
                                   window=window, softcap=50.0, block_l=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
