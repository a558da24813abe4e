"""The split-KV decode's two ideas on the CPU: the register SWAR plane
transpose (``ref.plane_words_swar``) and the split recurrence with its
merge (``packed_flash_decode.split_plan`` / ``split_decode_plain``),
against the port's plain decode and the JAX package's oracles.

Inputs are made with numpy from a seed and packed by the JAX oracles.
The plane expansion is integer work and must be bit-equal. The split
recurrence sums each split's softmax from scratch and merges the splits
afterwards, where the plain decode runs one online recurrence over the
tiles: both in f32, in another order, so they are held to 2e-5 absolute
and relative (as ``tests/test_torch_paged.py`` holds the port's decode to
JAX's).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro import codecs as jcodecs
from repro.kernels import ref as jref
from repro_torch import codecs as tcodecs
from repro_torch.kernels import packed_flash_decode as tpfd
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=2e-5)
CONTAINERS = ["sfp8", "sfp16", "sfp-m2e4", "sfp-m5e4"]


def _fields(container):
    return (jcodecs.fields_for(container, jnp.float32),
            tcodecs.fields_for(container, torch.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _values(rng, shape):
    """Normal values over 2^+-3 with zeros and subnormals (flush words).
    Wider ranges make outputs that cancel summands 2^20 times larger,
    where any change of summation order shows at 2e-5."""
    x = rng.standard_normal(shape) * np.exp2(rng.integers(-3, 3, shape))
    x[rng.random(shape) < 0.05] = 0.0
    x[rng.random(shape) < 0.03] = 1e-39
    return x.astype(np.float32)


def _pack(x, jf):
    pack = jref.bitplane_pack_nd if jf.dense else jref.sfp_pack_nd
    p, b = pack(jnp.asarray(x), jf)
    return np.asarray(p), np.asarray(b)


def _draft(jf):
    return max(jf.payload_bits - 1, jf.dexp_bits + 2)


# -- the SWAR plane transpose -------------------------------------------


@pytest.mark.parametrize("P", range(3, 17))
def test_plane_words_swar_bit_equal(P):
    """Random plane bytes (every bit pattern a plane can hold), each
    prefix P' from 3 (the shallowest draft of any geometry) to P: equal
    to the port's bit loop and to JAX's SWAR expansion of the same
    planes."""
    rng = np.random.default_rng(P)
    planes = rng.integers(0, 256, (6, 5, P * 16), dtype=np.uint8)
    for pp in range(3, P + 1):
        got = tref.plane_words_swar(_t(planes), P,
                                    None if pp == P else pp)
        sub = np.ascontiguousarray(
            planes.reshape(6, 5, P, 16)[..., P - pp:, :]).reshape(6, 5, -1)
        assert torch.equal(got, tref.plane_unpack_words(_t(sub), pp)), pp
        bs = jref._plane_unpack_bytes(jnp.asarray(sub), pp)
        want = np.asarray(bs[0]).astype(np.int32)
        if len(bs) > 1:
            want = want | (np.asarray(bs[1]).astype(np.int32) << 8)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("container", ["sfp-m2e4", "sfp-m5e4", "sfp-m1e2",
                                       "sfp-m7e7"])
def test_plane_words_swar_of_packed_cache(container):
    """Planes packed from values: the SWAR words are the words the pack
    transposed, and a draft's are their leading P' bits."""
    jf, tf = _fields(container)
    rng = np.random.default_rng(7)
    x = _values(rng, (16, 256))
    p, _ = _pack(x, jf)
    planes = _t(p).reshape(16, 2, jf.payload_bits * 16)
    full = tref.plane_unpack_words(planes, jf.payload_bits)
    for pp in range(jf.dexp_bits + 2, jf.payload_bits + 1):
        got = tref.plane_words_swar(planes, jf.payload_bits, pp)
        assert torch.equal(got, full >> (jf.payload_bits - pp)), pp


# -- the split plan -------------------------------------------------------


def test_split_plan_fills_the_card_and_ignores_batch():
    """At the smoke's shapes the split grid holds at least one CTA per
    SM (132 on the H100), and the split boundaries are a function of the
    slot and the tile alone."""
    p = tpfd.split_plan(4, 4, 288, 1152)
    assert (p.block_l, p.split_l, p.splits, p.ctas, p.threads) == (
        128, 64, 18, 288, 288)
    p = tpfd.split_plan(8, 4, 288, 1280, 128, paged=True)
    assert (p.block_l, p.split_l, p.splits, p.ctas) == (128, 64, 20, 640)
    assert min(p.ctas, tpfd.split_plan(4, 4, 288, 1152).ctas) >= 132
    for L, bl, sl in ((1152, 128, 64), (1280, 128, 64), (48, 48, 48),
                      (100, 100, 50), (4096, 128, 64), (7, 7, 7)):
        plans = [tpfd.split_plan(B, 4, 288, L) for B in (1, 2, 3, 4, 8)]
        assert {(q.block_l, q.split_l, q.splits) for q in plans} == {
            (bl, sl, L // sl)}
        assert [q.ctas for q in plans] == [B * 4 * (L // sl)
                                           for B in (1, 2, 3, 4, 8)]
    # A pool's tile is its block, whatever L is.
    assert tpfd.split_plan(2, 4, 288, 96, 32, paged=True).split_l == 32


# -- the split recurrence -------------------------------------------------


def _contiguous_case(container, L, window, pos, draft, seed):
    jf, tf = _fields(container)
    rng = np.random.default_rng(seed)
    B, H, KH, hd = len(pos), 4, 2, 64
    q = (rng.standard_normal((B, 1, H, hd)) * 3).astype(np.float32)
    k = _pack(_values(rng, (B, L, KH * hd)), jf)
    v = _pack(_values(rng, (B, L, KH * hd)), jf)
    pp = _draft(jf) if draft else None
    kw = dict(window=window, softcap=50.0, prefix_planes=pp)
    tin = (torch.from_numpy(q), *map(_t, (*k, *v)),
           torch.tensor(pos, dtype=torch.int32), tf)
    got = tpfd.split_decode_plain(*tin, **kw)
    want = tref.packed_flash_decode(*tin, block_l=tpfd.DEFAULT_BLOCK_L, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    jwant = jref.packed_flash_decode(
        jnp.asarray(q), *map(jnp.asarray, (*k, *v)),
        jnp.asarray(pos, jnp.int32), jf, block_l=tpfd.DEFAULT_BLOCK_L,
        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **F32_TOL)


@pytest.mark.parametrize("container", CONTAINERS)
@pytest.mark.parametrize("draft", [False, True])
def test_split_decode_global_rows(container, draft):
    """L = 1152 (18 splits of 64): rows at 0, 5, 127 and 128, whose later
    splits are all masked, and rows filling 16 and 18 splits."""
    _contiguous_case(container, 1152, None, [0, 5, 127, 128, 1000, 1151],
                     draft, seed=1)


@pytest.mark.parametrize("container", CONTAINERS)
@pytest.mark.parametrize("draft", [False, True])
def test_split_decode_ring_wraps(container, draft):
    """A 256-slot ring (4 splits) under a 96-position window: windows that
    wrap past slot 0, lie inside one split, or straddle two."""
    _contiguous_case(container, 256, 96, [300, 1000, 255, 5, 128, 200],
                     draft, seed=2)


@pytest.mark.parametrize("container", ["sfp8", "sfp-m2e4"])
@pytest.mark.parametrize("window", [None, 32])
def test_split_decode_shrunk_tile(container, window):
    """L = 48 shrinks the tile, and the split, to 48 slots: one split of
    two sub-tiles, the second 16 slots long."""
    _contiguous_case(container, 48, window, [47, 20, 0, 100], False, seed=3)


@pytest.mark.parametrize("container", CONTAINERS)
@pytest.mark.parametrize("draft", [False, True])
def test_split_decode_paged_trash_blocks(container, draft):
    """A pool of 128-slot blocks (two splits each): trailing logical blocks
    on the trash block 0 (no-ops), a row idle at 0 on the trash block,
    rows at 127 and 128 (a block boundary); against the plain paged read
    and JAX's."""
    jf, tf = _fields(container)
    rng = np.random.default_rng(4)
    KH, hd, bl, n_phys, H = 2, 64, 128, 8, 4
    k = _pack(_values(rng, (n_phys * bl, KH * hd)), jf)
    v = _pack(_values(rng, (n_phys * bl, KH * hd)), jf)
    pool = [a.reshape(n_phys, bl, -1) for a in (*k, *v)]
    tables = np.array([[1, 4, 2], [7, 0, 0], [0, 0, 0], [3, 5, 0],
                       [6, 0, 0]], np.int32)
    pos = np.array([300, 9, 0, 128, 127], np.int32)
    q = (rng.standard_normal((5, 1, H, hd)) * 3).astype(np.float32)
    pp = _draft(jf) if draft else None
    tin = (torch.from_numpy(q), *map(_t, pool))
    got = tpfd.split_decode_plain(*tin, _t(pos), tf, softcap=30.0,
                                  prefix_planes=pp, tables=_t(tables))
    want = tref.paged_flash_decode(*tin, _t(tables), _t(pos), tf,
                                   softcap=30.0, prefix_planes=pp)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    jwant = jref.paged_flash_decode(
        jnp.asarray(q), *map(jnp.asarray, pool), jnp.asarray(tables),
        jnp.asarray(pos), jf, softcap=30.0, prefix_planes=pp)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **F32_TOL)
    # Trailing trash blocks are exact no-ops of the split recurrence too:
    # their splits see no slot and weigh 0.
    short, long = (tpfd.split_decode_plain(
        tin[0][1:2], *tin[1:], _t(pos[1:2]), tf, softcap=30.0,
        prefix_planes=pp, tables=_t(tables[1:2, :n])) for n in (1, 3))
    assert torch.equal(short, long)
