"""The fixed-lane SFP word kernels' arithmetic on the CPU.

``ref.sfp_pack_swar`` / ``sfp_unpack_swar`` repeat ``csrc/sfp_pack.cu``
step for step: a thread per 8 lanes, the encode and decode of two bf16
values a register at the word's unpadded width P' = 1 + E + K (one value
a register for f32 and for delta fields wider than 8 bits), shifted
across the word's padding bits (``man_shift``: 3 for sfp16 on bf16, 1 for
sfp8-m2e4), the row base as a max over the row's 16 threads, and each
thread's words as one 16-byte (sfp16) or 8-byte (sfp8) chunk. They are
held byte for byte to the port's plain versions, to the JAX package's
oracles (``repro.kernels.ref``) and to its Pallas kernels in interpret
mode, on the same numpy inputs from a seed. Tolerance: exact (integer
arithmetic). The split into one- and two-pass tiles is not visible here:
every row is the same arithmetic, and the card tests
(``tests/test_torch_cuda.py``) cover both tiles.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import codecs as jcodecs
from repro.kernels import ref as jref
from repro.kernels import sfp_pack as jsp
from repro_torch import codecs as tcodecs
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

# (container, dtype): every fixed-lane geometry the port's paths pack,
# with the padding widths 0, 1 (sfp8-m2e4) and 3 (sfp16 on bf16), a full
# 8-bit exponent delta (sfp16-m7e8), and bf16 delta fields wider than 8
# bits (sfp16-m3e10 with 2 padding bits, sfp16-m1e14 with none), which the
# kernels encode and decode one value a register.
GEOMETRIES = [("sfp8", torch.bfloat16), ("sfp16", torch.bfloat16),
              ("sfp8-m2e4", torch.bfloat16), ("sfp16-m7e8", torch.bfloat16),
              ("sfp16-m3e10", torch.bfloat16),
              ("sfp16-m1e14", torch.bfloat16),
              ("sfp8", torch.float32), ("sfp16", torch.float32)]
# The kernels' route of each geometry: two values a register (the pair
# code) or one.
PAIR_ROUTE = {("sfp8", torch.bfloat16): True, ("sfp16", torch.bfloat16): True,
              ("sfp8-m2e4", torch.bfloat16): True,
              ("sfp16-m7e8", torch.bfloat16): True,
              ("sfp16-m3e10", torch.bfloat16): False,
              ("sfp16-m1e14", torch.bfloat16): False,
              ("sfp8", torch.float32): False, ("sfp16", torch.float32): False}
# One row, around the 16-row pass, one token of the serving shape (36),
# around the 32-row two-pass tile and ragged many-tile counts.
ROW_COUNTS = [1, 15, 16, 17, 36, 47, 48, 333]
_IDS = [f"{c}-{'bf16' if d == torch.bfloat16 else 'f32'}"
        for c, d in GEOMETRIES]


def _fields(container: str, dtype):
    """The port's and the JAX package's geometry (equal tuples)."""
    tf = tcodecs.fields_for(container, dtype)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jf = jcodecs.fields_for(container, jnp.dtype(jd))
    assert tuple(tf) == tuple(jf) and not tf.dense
    return tf, jf


def _top(dtype) -> int:
    return 7 if dtype == torch.bfloat16 else 23


def _ns(tf, dtype):
    """n none (the plain pack), 0, 1, man_keep and man_bits."""
    return (None, 0, 1, tf.man_keep, _top(dtype))


def _jax(t: torch.Tensor):
    """A tensor as a JAX array with the same bits."""
    if t.dtype == torch.bfloat16:
        return jax.lax.bitcast_convert_type(
            jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16)
    if t.dtype == torch.uint16:
        return jnp.asarray(t.to(torch.int32).numpy().astype(np.uint16))
    return jnp.asarray(t.numpy())


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint16:
        return t.to(torch.int32).numpy().astype(np.uint16)
    return t.numpy()


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16 if a.dtype == torch.bfloat16
                      else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _from_bits(bits: np.ndarray, dtype) -> torch.Tensor:
    """Raw sign/exponent/mantissa bit patterns as a bf16 or f32 tensor."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(bits.astype(np.uint32).view(np.int32)).view(
        torch.float32)


def _value_bits(rng, dtype, e, n: int) -> np.ndarray:
    """n bit patterns of biased exponent e (int or array), random sign and
    mantissa."""
    man_bits = _top(dtype)
    sign = rng.integers(0, 2, n).astype(np.int64)
    man = rng.integers(0, 1 << man_bits, n).astype(np.int64)
    return (sign << (man_bits + 8)) | (np.asarray(e, np.int64) << man_bits) \
        | man


def _edge_rows(rng, dtype, dexp_max: int) -> torch.Tensor:
    """Rows of every edge: a row of base 200 with values at the base,
    exactly dexp_max and dexp_max + 1 binades below it, +-0 and
    subnormals; a row of base 255 with +-inf, NaNs with payloads and
    values dexp_max and dexp_max + 1 below 255; a row of base 0 (zeros and
    subnormals of both signs); a row of base 1 (the smallest normals)."""
    man_bits = _top(dtype)
    inf = 0xFF << man_bits
    sign = 1 << (man_bits + 8)
    rows = []
    for eb in (200, 255):
        r = _value_bits(rng, dtype, rng.integers(max(1, eb - dexp_max - 3),
                                                 eb + 1, 128), 128)
        r[:8] = _value_bits(rng, dtype, max(eb - dexp_max, 0), 8)
        r[8:16] = _value_bits(rng, dtype, max(eb - dexp_max - 1, 0), 8)
        r[16:20] = [0, sign, 1, sign | 3]              # +-0, subnormals
        r[20] = _value_bits(rng, dtype, min(eb, 254), 1)[0]
        if eb == 255:
            r[21:28] = [inf, inf | sign, inf | 1, inf | sign | 5,
                        inf | (1 << (man_bits - 1)), inf | 0x7F,
                        inf | sign | (1 << (man_bits - 1)) | 1]
        rows.append(r)
    sub = rng.integers(0, 1 << man_bits, 128).astype(np.int64)
    sub[::3] = 0
    rows.append(sub | (rng.integers(0, 2, 128).astype(np.int64)
                       << (man_bits + 8)))
    small = _value_bits(rng, dtype, 1, 128)
    small[::4] &= ~np.int64(inf)                       # subnormals beside
    rows.append(small)
    return _from_bits(np.stack(rows), dtype)


def _wide_range(rng, R: int, dtype) -> torch.Tensor:
    """(R, 128) values over a wide dynamic range with planted zeros,
    negative zeros and subnormals."""
    x = rng.standard_normal((R, 128)) * np.exp2(rng.integers(-40, 40,
                                                             (R, 128)))
    flat = x.reshape(-1)
    idx = rng.permutation(flat.size)
    n = max(1, flat.size // 16)
    flat[idx[:n]] = 0.0
    flat[idx[n:2 * n]] = -0.0
    flat[idx[2 * n:3 * n]] = 1e-39 * rng.standard_normal(n)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _inputs(seed: int, R: int, dtype, dexp_max: int) -> torch.Tensor:
    """R rows: the edge rows first (as many as fit), the rest wide-range."""
    rng = np.random.default_rng(seed)
    x = _wide_range(rng, R, dtype)
    edges = _edge_rows(rng, dtype, dexp_max)
    k = min(R, edges.shape[0])
    x[:k] = edges[:k]
    return x


def _assert_equal_unpack(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _assert_pack_equal(got, want) -> None:
    (gp, gb), (wp, wb) = got, want
    np.testing.assert_array_equal(_np(gp), np.asarray(
        _np(wp) if isinstance(wp, torch.Tensor) else wp))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(
        wb.numpy() if isinstance(wb, torch.Tensor) else wb))


@pytest.mark.parametrize("container,dtype", GEOMETRIES, ids=_IDS)
def test_route_of_each_geometry(container, dtype):
    """bf16 words with a delta field of at most 8 bits take the pair code,
    wider ones (whose deltas the pair decode cannot hold) and f32 one value
    a register; the widths of the two wide geometries."""
    tf, _ = _fields(container, dtype)
    assert tref.pair_route(dtype, tf) is PAIR_ROUTE[(container, dtype)]
    if container in ("sfp16-m3e10", "sfp16-m1e14"):
        assert (tf.man_keep, tf.dexp_bits, tf.man_shift) == (
            (3, 10, 2) if container == "sfp16-m3e10" else (1, 14, 0))


@pytest.mark.parametrize("R", ROW_COUNTS)
@pytest.mark.parametrize("container,dtype", GEOMETRIES, ids=_IDS)
def test_swar_matches_plain(container, dtype, R):
    """Every geometry, row count and n against the plain versions; the
    unpack of all the packs' rows at once."""
    tf, _ = _fields(container, dtype)
    x = _inputs(R, R, dtype, tf.dexp_max)
    payloads, bases = [], []
    for n in _ns(tf, dtype):
        got = tref.sfp_pack_swar(x, tf, n)
        assert got[0].dtype == tf.word_dtype and got[0].shape == (R, 128)
        _assert_pack_equal(got, tref.sfp_pack_rows(x, tf, n))
        payloads.append(got[0])
        bases.append(got[1])
    p, b = torch.cat(payloads), torch.cat(bases)
    _assert_equal_unpack(tref.sfp_unpack_swar(p, b, dtype, tf),
                         tref.sfp_unpack_rows(p, b, dtype, tf))


def _by_block(call, R: int):
    """``call(lo, hi)`` of JAX's interpret kernel on rows lo:hi, one of its
    64-row grid blocks at a time: over more than one block the interpret
    kernels return NaNs with their payload canonicalized."""
    outs = [call(lo, min(lo + jsp.DEFAULT_BLOCK_ROWS, R))
            for lo in range(0, R, jsp.DEFAULT_BLOCK_ROWS)]
    if isinstance(outs[0], (tuple, list)):
        return tuple(np.concatenate(part) for part in zip(*outs))
    return np.concatenate(outs)


@pytest.mark.parametrize("container,dtype", GEOMETRIES, ids=_IDS)
def test_swar_matches_jax(container, dtype):
    """333 rows (edge rows first) for every n, against JAX's oracles and
    its interpret kernels (six 64-row grid blocks); the unpack against
    both."""
    tf, jf = _fields(container, dtype)
    R = 333
    x = _inputs(7, R, dtype, tf.dexp_max)
    jx = _jax(x)
    for n in _ns(tf, dtype):
        p, b = tref.sfp_pack_swar(x, tf, n)
        kernel = _by_block(
            lambda lo, hi: jsp.sfp_pack(jx[lo:hi], fields=jf, interpret=True)
            if n is None else jsp.sfp_quantize_pack(
                jx[lo:hi], jnp.int32(n), fields=jf, interpret=True), R)
        for want in (jref.sfp_pack(jx, jf, n), kernel):
            _assert_pack_equal((p, b), want)
        out = tref.sfp_unpack_swar(p, b, dtype, tf)
        jp, jb = _jax(p), jnp.asarray(b.numpy())
        _assert_equal_unpack(out, jref.sfp_unpack(jp, jb, (R, 128),
                                                  jx.dtype, jf))
        _assert_equal_unpack(out, _by_block(lambda lo, hi: jsp.sfp_unpack(
            jp[lo:hi], jb[lo:hi], shape=(hi - lo, 128), dtype=jx.dtype,
            fields=jf, interpret=True), R))


@pytest.mark.parametrize("container,dtype", GEOMETRIES, ids=_IDS)
def test_unpack_of_any_word_bytes(container, dtype):
    """Words the pack never writes (nonzero padding bits, flush codes with
    a sign, rebuilt exponents below 0) and bases of 0..255 decode as the
    plain versions, JAX's oracle and its interpret kernel do."""
    tf, jf = _fields(container, dtype)
    rng = np.random.default_rng(11)
    R = 37
    raw = rng.integers(0, 256, (R, 128 * tf.payload_bits // 8))
    p = torch.from_numpy(raw.astype(np.uint8)).view(tf.word_dtype)
    b = torch.from_numpy(rng.integers(0, 256, (R, 1)).astype(np.uint8))
    b[:3, 0] = torch.tensor([0, 255, 1], dtype=torch.uint8)
    out = tref.sfp_unpack_swar(p, b, dtype, tf)
    _assert_equal_unpack(out, tref.sfp_unpack_rows(p, b, dtype, tf))
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp, jb = _jax(p), jnp.asarray(b.numpy())
    _assert_equal_unpack(out, jref.sfp_unpack(jp, jb, (R, 128), jd, jf))
    _assert_equal_unpack(out, jsp.sfp_unpack(jp, jb, shape=(R, 128),
                                             dtype=jd, fields=jf,
                                             interpret=True))
    if tf.man_shift:
        # The padding bits are ignored: clearing them decodes the same.
        words = p.to(torch.int32) & ~((1 << tf.man_shift) - 1)
        clear = words.to(tf.word_dtype)
        _assert_equal_unpack(tref.sfp_unpack_swar(clear, b, dtype, tf), out)


def test_swar_hypothesis_edges():
    """Two rows of drawn edge values around a drawn base exponent (zeros
    of both signs, subnormals, +-inf, NaN, values exactly dexp_max binades
    below the base and one more, the base itself, ordinary values) and a
    drawn n, against the plain versions and JAX's oracles."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @st.composite
    def cases(draw):
        container, dtype = draw(st.sampled_from(GEOMETRIES))
        tf, _ = _fields(container, dtype)
        man_bits = _top(dtype)
        e_base = draw(st.integers(1, 254))
        kinds = st.sampled_from(["zero", "subnormal", "inf", "nan",
                                 "at_dmax", "below_dmax", "base", "normal"])
        inf = 0xFF << man_bits
        bits = []
        for _ in range(2 * 128):
            kind = draw(kinds)
            sign = draw(st.integers(0, 1)) << (man_bits + 8)
            man = draw(st.integers(0, (1 << man_bits) - 1))
            if kind == "zero":
                v = 0
            elif kind == "subnormal":
                v = man
            elif kind == "inf":
                v = inf
            elif kind == "nan":
                v = inf | max(man, 1)
            else:
                e = {"at_dmax": e_base - tf.dexp_max,
                     "below_dmax": e_base - tf.dexp_max - 1,
                     "base": e_base,
                     "normal": draw(st.integers(1, e_base))}[kind]
                v = 0 if e < 1 else (e << man_bits) | man
            bits.append(sign | v)
        x = _from_bits(np.array(bits, np.int64).reshape(2, 128), dtype)
        n = draw(st.one_of(st.none(), st.integers(0, man_bits)))
        return container, x, n

    @hyp.settings(max_examples=40, deadline=None)
    @hyp.given(cases())
    def check(case):
        container, x, n = case
        tf, jf = _fields(container, x.dtype)
        got = tref.sfp_pack_swar(x, tf, n)
        jx = _jax(x)
        for want in (tref.sfp_pack_rows(x, tf, n), jref.sfp_pack(jx, jf, n)):
            _assert_pack_equal(got, want)
        out = tref.sfp_unpack_swar(*got, x.dtype, tf)
        _assert_equal_unpack(out, tref.sfp_unpack_rows(*got, x.dtype, tf))
        _assert_equal_unpack(out, jref.sfp_unpack(
            _jax(got[0]), jnp.asarray(got[1].numpy()), (2, 128), jx.dtype,
            jf))

    check()
