"""The port's paged KV layer against the JAX package: the draft geometry
(``prefix_fields``), the plain paged and draft decode reads, the block
checksums, the paged pool slices and the block pool.

Inputs are made with numpy from a seed and packed by the JAX oracles
(whose bytes the port's packs reproduce, ``tests/test_torch_dense.py``);
the JAX side runs its ``ref`` backend. The decode reads accumulate in f32
on both sides in the same block order but through different einsum
kernels, so they are held to 2e-5 (absolute and relative); the decoded
tiles, the checksums and the pool are integer work and must be equal.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro import codecs as jcodecs, configs as jconfigs
from repro.core import containers as jcontainers
from repro.kernels import ref as jref
from repro.serve import kvcache as jkv
from repro.serve import pool as jpool
from repro_torch import codecs as tcodecs, configs as tconfigs
from repro_torch.core import containers as tcontainers
from repro_torch.kernels import _lib
from repro_torch.kernels import ops as tops
from repro_torch.kernels import packed_flash_decode as tpfd
from repro_torch.kernels import ref as tref
from repro_torch.serve import kvcache as tkv
from repro_torch.serve.pool import TRASH_BLOCK, BlockPool, blocks_for

torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=2e-5)
# (container, source dtype) pairs with fixed-lane words and dense planes.
GEOMETRIES = [("sfp8", "float32"), ("sfp16", "float32"),
              ("sfp-m2e4", "float32"), ("sfp-m5e4", "float32")]


def _fields(container, dtype):
    return (jcodecs.fields_for(container, jnp.dtype(dtype)),
            tcodecs.fields_for(container, getattr(torch, dtype)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _wide(rng, shape):
    """Normal values over 2^+-20 with zeros and subnormals: flush words
    (zero, below the group's dexp range) in every group."""
    x = rng.standard_normal(shape) * np.exp2(rng.integers(-20, 20, shape))
    x[rng.random(shape) < 0.05] = 0.0
    x[rng.random(shape) < 0.03] = 1e-39
    return x.astype(np.float32)


def _pack(x, jf):
    pack = jref.bitplane_pack_nd if jf.dense else jref.sfp_pack_nd
    p, b = pack(jnp.asarray(x), jf)
    return np.asarray(p), np.asarray(b)


def _drafts(jf):
    """Every valid draft depth, full width included."""
    return list(range(jf.dexp_bits + 2, jf.payload_bits + 1))


# -- draft geometry ------------------------------------------------------


@pytest.mark.parametrize("container", ["sfp8", "sfp16", "sfp-m2e4",
                                       "sfp-m1e2", "sfp-m7e7", "sfp8-m2e5"])
def test_prefix_fields_matches_jax(container):
    jf, tf = _fields(container, "bfloat16")
    assert tuple(tf) == tuple(jf)
    for p in range(0, jf.payload_bits + 3):
        try:
            want = jref.prefix_fields(jf, p)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tops.prefix_fields(tf, p)
            assert str(got.value) == str(e)
            continue
        assert tuple(tops.prefix_fields(tf, p)) == tuple(want)


@pytest.mark.parametrize("container,dtype", GEOMETRIES)
def test_draft_unpack_tile_bit_exact(container, dtype):
    """The draft read's decoded tile equals JAX's bit for bit at every
    depth, on groups with flush words; P' = P is the full read."""
    jf, tf = _fields(container, dtype)
    rng = np.random.default_rng(1)
    rows, KH, hd = 24, 2, 192
    p, b = _pack(_wide(rng, (rows, KH * hd)), jf)
    jspec = jcontainers.spec_for(jnp.dtype(dtype))
    tspec = tcontainers.spec_for(getattr(torch, dtype))
    full = tref.unpack_tile(_t(p), _t(b), tf, tspec, rows=rows, KH=KH, hd=hd)
    for pp in _drafts(jf):
        want = np.asarray(jref.unpack_tile(jnp.asarray(p), jnp.asarray(b),
                                           jf, jspec, rows=rows, KH=KH,
                                           hd=hd, prefix_planes=pp))
        got = tref.unpack_tile(_t(p), _t(b), tf, tspec, rows=rows, KH=KH,
                               hd=hd, prefix_planes=pp)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
        if pp == jf.payload_bits:
            assert torch.equal(got, full)


@pytest.mark.parametrize("container,dtype", GEOMETRIES)
@pytest.mark.parametrize("window,pos", [(None, (40, 17)), (24, (100, 63))])
def test_draft_decode_matches_jax_ref(container, dtype, window, pos):
    """The contiguous decode in the draft mode: q (2, 1, 4, 192) over 2 KV
    heads (3 groups straddle the heads), global and ring."""
    jf, tf = _fields(container, dtype)
    rng = np.random.default_rng(2)
    B, L, H, KH, hd = 2, 48, 4, 2, 192
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = _pack(rng.standard_normal((B, L, KH * hd)).astype(np.float32), jf)
    v = _pack(rng.standard_normal((B, L, KH * hd)).astype(np.float32), jf)
    pp = max(jf.payload_bits - 1, jf.dexp_bits + 2)
    want = jref.packed_flash_decode(
        jnp.asarray(q), *map(jnp.asarray, (*k, *v)),
        jnp.asarray(pos, jnp.int32), jf, window=window, softcap=50.0,
        block_l=128, prefix_planes=pp)
    got = tops.packed_flash_decode(
        torch.from_numpy(q), tops.Packed(*map(_t, k)),
        tops.Packed(*map(_t, v)), torch.tensor(pos), fields=tf,
        window=window, softcap=50.0, prefix_planes=pp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# -- paged decode --------------------------------------------------------


def _pool_parts(rng, n_phys, bl, D, jf):
    k = _pack(_wide(rng, (n_phys * bl, D)), jf)
    v = _pack(_wide(rng, (n_phys * bl, D)), jf)
    return [a.reshape(n_phys, bl, -1) for a in (*k, *v)]


@pytest.mark.parametrize("container,dtype", GEOMETRIES)
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("draft", [False, True])
def test_paged_decode_matches_jax_ref(container, dtype, rep, draft):
    """Rows at different fill levels; row 1 has trailing logical blocks on
    the trash block, row 2 is idle at position 0."""
    jf, tf = _fields(container, dtype)
    rng = np.random.default_rng(3)
    B, KH, hd, bl, n_phys = 3, 2, 64, 16, 8
    H = KH * rep
    pool = _pool_parts(rng, n_phys, bl, KH * hd, jf)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    tables = np.array([[1, 4, 2], [7, 0, 0], [0, 0, 0]], np.int32)
    pos = np.array([40, 9, 0], np.int32)
    pp = max(jf.payload_bits - 1, jf.dexp_bits + 2) if draft else None
    want = jref.paged_flash_decode(
        jnp.asarray(q), *map(jnp.asarray, pool), jnp.asarray(tables),
        jnp.asarray(pos), jf, softcap=30.0, prefix_planes=pp)
    got = tops.paged_flash_decode(
        torch.from_numpy(q), tops.Packed(_t(pool[0]), _t(pool[1])),
        tops.Packed(_t(pool[2]), _t(pool[3])), _t(tables), _t(pos),
        fields=tf, softcap=30.0, prefix_planes=pp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_paged_plain_equals_contiguous_over_gather():
    """The plain paged read is the contiguous recurrence over the gathered
    cache with block_l = the pool block, bit for bit (what the kernel is
    held to on the card)."""
    jf, tf = _fields("sfp-m2e4", "float32")
    rng = np.random.default_rng(4)
    pool = [_t(a) for a in _pool_parts(rng, 6, 16, 128, jf)]
    q = torch.from_numpy(rng.standard_normal((2, 1, 2, 64)).astype(
        np.float32))
    tables = torch.tensor([[2, 5, 1], [4, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([47, 3], dtype=torch.int32)
    for pp in (None, 6):
        got = tpfd.paged_flash_decode_dense(q, *pool, tables, pos, tf,
                                            prefix_planes=pp)
        gathered = [tref.paged_gather(t, tables) for t in pool]
        want = tpfd.packed_flash_decode_dense(q, *gathered, pos, tf,
                                              block_l=16, prefix_planes=pp)
        assert torch.equal(got, want)


def test_trailing_trash_blocks_are_exact_noops():
    jf, tf = _fields("sfp16", "float32")
    rng = np.random.default_rng(5)
    pool = [_t(a) for a in _pool_parts(rng, 5, 16, 128, jf)]
    q = torch.from_numpy(rng.standard_normal((1, 1, 2, 64)).astype(
        np.float32))
    pos = torch.tensor([14], dtype=torch.int32)
    a = tpfd.paged_flash_decode(q, *pool, torch.tensor([[3]]), pos, tf)
    b = tpfd.paged_flash_decode(q, *pool, torch.tensor([[3, 0, 0, 0]]), pos,
                                tf)
    assert torch.equal(a, b)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _paged_calls():
    sfp8 = tcodecs.fields_for("sfp8", torch.bfloat16)
    dense = tcodecs.fields_for("sfp-m2e4", torch.bfloat16)
    q = _meta((2, 1, 4, 192), torch.bfloat16)
    pay = _meta((5, 128, 384), torch.uint8)
    dpay = _meta((5, 128, 3 * dense.group_payload_bytes), torch.uint8)
    bas = _meta((5, 128, 3), torch.uint8)
    cpay = _meta((2, 128, 384), torch.uint8)
    cbas = _meta((2, 128, 3), torch.uint8)
    tab = _meta((2, 3), torch.int32)
    pos = _meta((2,), torch.int32)
    return [
        lambda: tpfd.paged_flash_decode(q, pay, bas, pay, bas, tab, pos,
                                        sfp8),
        lambda: tpfd.paged_flash_decode_dense(q, dpay, bas, dpay, bas, tab,
                                              pos, dense, prefix_planes=6),
        lambda: tpfd.packed_flash_decode(q, cpay, cbas, cpay, cbas, pos,
                                         sfp8, prefix_planes=7),
        lambda: tops.paged_flash_decode(
            q, tops.Packed(pay, bas), tops.Packed(pay, bas), tab, pos,
            fields=sfp8, prefix_planes=7),
        lambda: tops.paged_flash_decode(
            q, tops.Packed(dpay, bas), tops.Packed(dpay, bas), tab, pos,
            fields=dense),
    ]


@pytest.mark.parametrize("i", range(5))
def test_paged_and_draft_wrappers_raise_when_library_cannot_load(
        monkeypatch, i):
    """A tensor off the CPU goes to the kernel or raises: never to the
    plain version."""
    def fail():
        raise _lib.KernelUnavailable("mocked: no kernel library")
    monkeypatch.setattr(_lib, "load", fail)
    with pytest.raises(_lib.KernelUnavailable, match="mocked"):
        _paged_calls()[i]()


def test_draft_wrappers_check_depth_and_kind():
    """An invalid draft depth or the other layout's geometry raises before
    any launch; a CPU tensor takes the plain version and counts nothing."""
    sfp8 = tcodecs.fields_for("sfp8", torch.bfloat16)
    q = _meta((2, 1, 4, 192), torch.bfloat16)
    pay, bas = _meta((5, 128, 384), torch.uint8), _meta((5, 128, 3),
                                                        torch.uint8)
    tab, pos = _meta((2, 3), torch.int32), _meta((2,), torch.int32)
    with pytest.raises(ValueError, match="prefix_planes=5"):
        tpfd.paged_flash_decode(q, pay, bas, pay, bas, tab, pos, sfp8,
                                prefix_planes=5)
    with pytest.raises(ValueError, match="dense bit planes only"):
        tpfd.paged_flash_decode_dense(q, pay, bas, pay, bas, tab, pos, sfp8)
    before = (tpfd.paged_flash_decode.launches,
              tpfd.paged_flash_decode.draft_launches)
    jf, tf = _fields("sfp8", "float32")
    rng = np.random.default_rng(6)
    pool = [_t(a) for a in _pool_parts(rng, 3, 16, 128, jf)]
    qc = torch.zeros((1, 1, 2, 64))
    tpfd.paged_flash_decode(qc, *pool, torch.tensor([[1, 2]]),
                            torch.tensor([20], dtype=torch.int32), tf,
                            prefix_planes=6)
    assert (tpfd.paged_flash_decode.launches,
            tpfd.paged_flash_decode.draft_launches) == before


# -- paged pool slices and checksums -------------------------------------


@pytest.mark.parametrize("container", ["sfp8", "sfp16", "sfp-m2e4",
                                       "sfp-m1e2"])
def test_paged_block_bytes_and_spec_match_jax(container):
    jc, tc = jconfigs.get("gemma2-2b"), tconfigs.get("gemma2-2b")
    assert (tkv.paged_block_bytes(tc, 128, container)
            == jkv.paged_block_bytes(jc, 128, container))
    want = jkv.paged_block_spec(jc, 11, 128, container)
    got = tkv.paged_block_spec(tc, 11, 128, container)
    for (shape, dt), w in zip(got, want):
        assert shape == tuple(w.shape)
        assert torch.empty((), dtype=dt).numpy().dtype == np.dtype(w.dtype)
    init = tkv.paged_block_init(tc, 3, 128, container, device="cpu")
    assert all(not t.any() for t in init)


@pytest.mark.parametrize("container", ["gecko8", "bit_exact"])
def test_unpageable_codecs_raise_as_jax(container):
    jc, tc = jconfigs.get("gemma2-2b"), tconfigs.get("gemma2-2b")
    with pytest.raises(ValueError) as want:
        jkv.paged_block_spec(jc, 2, 128, container)
    with pytest.raises(ValueError) as got:
        tkv.paged_block_spec(tc, 2, 128, container)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("container", ["sfp8", "sfp16", "sfp-m2e4"])
@pytest.mark.parametrize("layers", [None, 3])
@pytest.mark.parametrize("salt", [0, 1, 0xFFFFFFFF + 7])
def test_block_checksums_bit_equal_to_jax(container, layers, salt):
    """uint32 per-block sums, for one pool slice (P, block_l, cols) and for
    layers stacked on a leading axis, with large payload words (sfp16) and
    a salt past 2^32; the port also takes the layers as a list and a
    subset of block ids."""
    jf, _ = _fields(container, "float32")
    rng = np.random.default_rng(7)
    n_phys, bl, D = 5, 16, 256
    lead = () if layers is None else (layers,)
    parts = [rng.integers(0, np.iinfo(a.dtype).max, lead + a.shape,
                          dtype=np.int64).astype(a.dtype)
             for a in _pool_parts(rng, n_phys, bl, D, jf)]
    want = np.asarray(jkv.paged_block_checksums(
        jkv.PagedKV(*map(jnp.asarray, parts)), salt=salt))
    assert want.dtype == np.uint32
    kv = tkv.PagedKV(*map(_t, parts))
    got = tkv.paged_block_checksums(kv, salt=salt)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    if layers is not None:
        per_layer = [tkv.PagedKV(*(a[k] for a in kv)) for k in range(layers)]
        ids = torch.tensor([3, 1])
        sub = tkv.paged_block_checksums(per_layer, salt=salt, ids=ids)
        np.testing.assert_array_equal(sub.numpy().astype(np.uint32),
                                      want[[3, 1]])


def test_block_checksum_sees_every_single_bit_flip():
    jf, _ = _fields("sfp8", "float32")
    rng = np.random.default_rng(8)
    kv = tkv.PagedKV(*map(_t, _pool_parts(rng, 3, 16, 128, jf)))
    base = tkv.paged_block_checksums(kv, salt=1)
    for field in range(4):
        for bit in range(8):
            arr = kv[field]
            col = 7 % arr.shape[-1]
            arr[2, 5, col] ^= 1 << bit
            s = tkv.paged_block_checksums(kv, salt=1)
            assert s[2] != base[2] and torch.equal(s[:2], base[:2])
            arr[2, 5, col] ^= 1 << bit


# -- block pool (a copy of the JAX package's, held to its behaviour) -------


def test_pool_alloc_free_trash_invariants():
    pool = BlockPool(num_blocks=4, max_slots=2, max_logical=3, block_l=16)
    assert blocks_for(0, 16) == 0 and blocks_for(1, 16) == 1
    assert blocks_for(16, 16) == 1 and blocks_for(17, 16) == 2
    assert pool.free_blocks == 4
    assert pool.alloc_upto(0, 33)
    assert pool.used_blocks == 3
    assert TRASH_BLOCK not in pool.tables[0, :3]
    assert not pool.alloc_upto(1, 17)
    assert pool.free_blocks == 1
    assert pool.alloc_upto(1, 16)
    assert pool.free_blocks == 0
    assert pool.free_slot(0) == 3
    assert (pool.tables[0] == TRASH_BLOCK).all()
    assert pool.alloc_upto(1, 8) and pool.used_blocks == 1
    with pytest.raises(ValueError):
        pool.alloc_upto(1, 16 * 3 + 1)


def test_pool_hardening_rejects_misuse():
    pool = BlockPool(num_blocks=4, max_slots=2, max_logical=3, block_l=16)
    with pytest.raises(ValueError, match="slot 2 out of range"):
        pool.alloc_upto(2, 16)
    with pytest.raises(ValueError, match="n_tokens"):
        pool.alloc_upto(0, -5)
    with pytest.raises(KeyError, match="double free"):
        pool.free_slot(0)
    assert pool.alloc_upto(0, 20)
    pool.verify_invariants()
    with pytest.raises(ValueError, match="not owned"):
        pool.free_slot(0, quarantine=(99,))
    with pytest.raises(ValueError, match="trash block"):
        pool.free_slot(0, quarantine=(TRASH_BLOCK,))
    owned = pool.owned_ids()
    assert pool.free_slot(0, quarantine=owned[:1]) == 1
    pool.verify_invariants()
    assert pool.free_blocks == 3 and pool.quarantined_blocks == owned[:1]
    with pytest.raises(ValueError, match="not quarantined"):
        pool.rehabilitate(owned[1])
    pool.rehabilitate(owned[0])
    assert pool.free_blocks == 4
    pool.verify_invariants()


def test_pool_admission_gate_keeps_decode_headroom():
    pool = BlockPool(num_blocks=3, max_slots=2, max_logical=4, block_l=16)
    assert pool.can_admit(47) and not pool.can_admit(48)
    pool.alloc_upto(0, 17)
    assert pool.can_admit(15) and not pool.can_admit(16)
    tiny = BlockPool(num_blocks=1, max_slots=1, max_logical=1, block_l=128)
    assert tiny.can_admit(120) and not tiny.can_admit(128)


def test_pool_matches_jax_pool_on_a_random_op_sequence():
    """The same seeded sequence of allocations, byte-priced allocations,
    frees, quarantines and rehabilitations gives the same tables, free
    list, stats and errors in both pools."""
    rng = np.random.RandomState(9)
    kw = dict(num_blocks=12, max_slots=4, max_logical=5, block_l=16,
              block_bytes=100, budget_bytes=1500)
    pools = (BlockPool(**kw), jpool.BlockPool(**kw))
    for _ in range(300):
        op = rng.randint(4)
        slot = int(rng.randint(-1, 5))
        n = int(rng.randint(-2, 90))
        rate = int(rng.choice([100, 60]))
        q = bool(rng.randint(2))
        outs = []
        for p in pools:
            try:
                if op == 0:
                    r = p.alloc_upto(slot, n, block_bytes=rate)
                elif op == 1:
                    ids = p.owned_ids()
                    quarantine = tuple(ids[:1]) if q and ids else ()
                    r = p.free_slot(slot, quarantine=quarantine)
                elif op == 2:
                    r = p.can_admit(n)
                else:
                    qb = p.quarantined_blocks
                    r = p.rehabilitate(qb[0]) if qb else None
            except (ValueError, KeyError) as e:
                r = (type(e), str(e))
            outs.append(r)
            p.verify_invariants()
        assert outs[0] == outs[1]
        np.testing.assert_array_equal(pools[0].tables, pools[1].tables)
        assert (dataclasses.asdict(pools[0].stats())
                == dataclasses.asdict(pools[1].stats()))
