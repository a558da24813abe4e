"""The dense bit-plane kernels' arithmetic on the CPU.

``ref.bitplane_encode_swar`` / ``bitplane_decode_swar`` repeat the plane
assembly of ``csrc/bitplane_pack.cu``: a thread per 8 lanes, one 8x8 bit
transpose of its words' low bytes (a second of their high bytes when P >
8) and the shared-memory image of a tile of rows. ``bitplane_pack_swar``
/ ``bitplane_unpack_swar`` repeat the whole kernels, with the encode and
decode of two bf16 values a register. They are held byte for byte to the
port's plain versions, to the JAX package's oracles
(``repro.kernels.ref``) and to its Pallas kernels in interpret mode, on
the same numpy inputs from a seed. Tolerance: exact (integer arithmetic).
"""
import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch

from repro.kernels import bitplane_pack as jbp
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

PAYLOAD_BITS = list(range(3, 17))
DTYPES = [torch.bfloat16, torch.float32]
# A one-token row count off the 16-row tile (the serving shape has 36),
# and one row.
ROW_COUNTS = [37, 1]



def _fields(P: int, dtype):
    """A dense geometry of P payload bits for ``dtype``: the port's and
    the JAX package's (equal tuples)."""
    man_bits = 7 if dtype == torch.bfloat16 else 23
    dexp = min(4, P - 2)
    man = P - 1 - dexp
    if man > man_bits:
        man, dexp = man_bits, P - 1 - man_bits
    return (tref.PackFields(man, dexp, P, dense=True),
            jref.PackFields(man, dexp, P, dense=True))


def _jax(t: torch.Tensor):
    """A tensor as a JAX array with the same bits."""
    if t.dtype == torch.bfloat16:
        return jax.lax.bitcast_convert_type(
            jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16 if a.dtype == torch.bfloat16
                      else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


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


def _assert_pack_all_equal(x: torch.Tensor, tf, jf, ns, oracle_ns=None,
                           kernels: bool = True) -> None:
    """Pack by the mirror, the plain versions, JAX's oracles (for the n of
    ``oracle_ns``, default all: they run eagerly, ~0.2 s a call) and
    (``kernels``) JAX's interpret kernels, for every n of ``ns`` (None: the
    plain pack); then unpack all the packs' rows at once by each."""
    jx = _jax(x)
    packed = []
    for n in ns:
        planes, bases = tref.bitplane_pack_swar(x, tf, n)
        wants = [tref.bitplane_pack_rows(x, tf, n)]
        if oracle_ns is None or n in oracle_ns:
            wants.append(jref.bitplane_pack(jx, jf, n))
        if kernels:
            wants.append(
                jbp.bitplane_pack(jx, fields=jf, interpret=True) if n is None
                else jbp.bitplane_quantize_pack(jx, jnp.int32(n), fields=jf,
                                                interpret=True))
        for wp, wb in wants:
            np.testing.assert_array_equal(planes.numpy(), np.asarray(wp))
            np.testing.assert_array_equal(bases.numpy(), np.asarray(wb))
        packed.append((planes, bases))
    planes = torch.cat([p for p, _ in packed])
    bases = torch.cat([b for _, b in packed])
    R = planes.shape[0]
    out = tref.bitplane_unpack_swar(planes, bases, x.dtype, tf)
    jp, jb = jnp.asarray(planes.numpy()), jnp.asarray(bases.numpy())
    wants = [tref.bitplane_unpack_rows(planes, bases, x.dtype, tf),
             jref.bitplane_unpack(jp, jb, (R, 128), jx.dtype, jf)]
    if kernels:
        # One pack at a time: over more than one grid block the interpret
        # kernel returns NaNs with their payload canonicalized.
        wants.append(np.concatenate([jbp.bitplane_unpack(
            jnp.asarray(p.numpy()), jnp.asarray(b.numpy()),
            shape=(p.shape[0], 128), dtype=jx.dtype, fields=jf,
            interpret=True) for p, b in packed]))
    for want in wants:
        np.testing.assert_array_equal(_bits(out), _bits(want))


@pytest.mark.parametrize("P", PAYLOAD_BITS)
def test_plane_words_match_plain_and_jax(P):
    """Words <-> planes alone: one transpose for P <= 8, two above."""
    rng = np.random.default_rng(P)
    for R in ROW_COUNTS:
        words = torch.from_numpy(rng.integers(0, 1 << P, (R, 128))
                                 .astype(np.int32))
        planes = tref.bitplane_encode_swar(words, P)
        assert planes.dtype == torch.uint8 and planes.shape == (R, 16 * P)
        jw = jnp.asarray(words.numpy())
        for want in (tref.plane_pack_words(words, P),
                     jref.plane_pack_words(jw, P)):
            np.testing.assert_array_equal(planes.numpy(), np.asarray(want))
        back = tref.bitplane_decode_swar(planes, P)
        np.testing.assert_array_equal(back.numpy(), words.numpy())
        jp = jnp.asarray(planes.numpy())
        for want in (tref.plane_unpack_words(planes, P),
                     jref.plane_unpack_words(jp, P)):
            np.testing.assert_array_equal(back.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P", PAYLOAD_BITS)
def test_swar_matches_plain_and_jax(P, dtype):
    """Every payload width, both containers, n none, 0, 1, man_keep and
    man_bits, against the plain versions and JAX's interpret kernels, and
    at n none, 1 and man_bits against JAX's oracles (row 0 holds +-inf and
    NaN, rows 1 and 2 the smallest normals, which flush with their
    sign)."""
    tf, jf = _fields(P, dtype)
    top = 7 if dtype == torch.bfloat16 else 23
    x = _wide_range(np.random.default_rng(100 + P), ROW_COUNTS[0], dtype)
    x[0, :3] = torch.tensor([float("inf"), -float("inf"), float("nan")])
    x[1:3, :4] = torch.tensor([-1.5, -1.5, 1.0, -1.75]) * 2.0 ** -126
    _assert_pack_all_equal(x, tf, jf, (None, 0, 1, tf.man_keep, top),
                           oracle_ns=(None, 1, top))


def test_unpack_of_any_plane_bytes():
    """Planes and bases the pack never writes (flush codes with a sign,
    rebuilt exponents below 0) decode as the plain versions do."""
    rng = np.random.default_rng(5)
    for dtype in DTYPES:
        for P in (3, 7, 9, 15, 16):
            tf, jf = _fields(P, dtype)
            planes = torch.from_numpy(rng.integers(0, 256, (37, 16 * P))
                                      .astype(np.uint8))
            bases = torch.from_numpy(rng.integers(0, 256, (37, 1))
                                     .astype(np.uint8))
            out = tref.bitplane_unpack_swar(planes, bases, dtype, tf)
            jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
            for want in (tref.bitplane_unpack_rows(planes, bases, dtype, tf),
                         jref.bitplane_unpack(jnp.asarray(planes.numpy()),
                                              jnp.asarray(bases.numpy()),
                                              (37, 128), jd, jf)):
                np.testing.assert_array_equal(_bits(out), _bits(want))


@pytest.mark.parametrize("R", [300 * 16 + 5,
                               tref.BITPLANE_ONE_PASS_ROWS + 5])
def test_tile_staging(R):
    """Many one-pass (16-row) tiles, and rows past the switch to two-pass
    (32-row) tiles, each with a 5-row last tile: the tile images' offsets
    against the plain versions."""
    assert tref.bitplane_tile_rows(R) == (
        16 if R <= tref.BITPLANE_ONE_PASS_ROWS else 32)
    tf, _ = _fields(7, torch.bfloat16)
    x = _wide_range(np.random.default_rng(R), R, torch.bfloat16)
    planes, bases = tref.bitplane_pack_swar(x, tf, 1)
    want = tref.bitplane_pack_rows(x, tf, 1)
    assert torch.equal(planes, want[0]) and torch.equal(bases, want[1])
    out = tref.bitplane_unpack_swar(planes, bases, torch.bfloat16, tf)
    want = tref.bitplane_unpack_rows(planes, bases, torch.bfloat16, tf)
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))


# -- edge rows ----------------------------------------------------------------

_GEOMETRIES = [(3, torch.bfloat16), (7, torch.bfloat16),
               (15, torch.bfloat16), (16, torch.bfloat16),
               (7, torch.float32), (15, torch.float32)]


@st.composite
def _edge_rows(draw):
    """Two rows of edge values around a drawn base exponent: zeros of both
    signs, subnormals, +-inf, NaN, values exactly dexp_max binades below
    the base and one more, the base itself, and ordinary values; n drawn
    from 0..man_bits or None."""
    P, dtype = draw(st.sampled_from(_GEOMETRIES))
    tf, _ = _fields(P, dtype)
    man_bits = 7 if dtype == torch.bfloat16 else 23
    e_base = draw(st.integers(1, 254))
    kinds = st.sampled_from(["zero", "subnormal", "inf", "nan", "at_dmax",
                             "below_dmax", "base", "normal"])
    vals = []
    for _ in range(2 * 128):
        kind = draw(kinds)
        sign = draw(st.sampled_from([1.0, -1.0]))
        man = draw(st.integers(0, (1 << man_bits) - 1))
        frac = 1.0 + man / (1 << man_bits)
        if kind == "zero":
            v = 0.0
        elif kind == "subnormal":
            v = man / (1 << man_bits) * 2.0 ** -126
        elif kind == "inf":
            v = np.inf
        elif kind == "nan":
            v = np.nan
        else:
            e = {"at_dmax": e_base - tf.dexp_max,
                 "below_dmax": e_base - tf.dexp_max - 1, "base": e_base,
                 "normal": draw(st.integers(1, e_base))}[kind]
            v = 0.0 if e < 1 else frac * 2.0 ** (e - 127)
        vals.append(sign * v)
    x = torch.tensor(np.array(vals, np.float32).reshape(2, 128))
    n = draw(st.one_of(st.none(), st.integers(0, man_bits)))
    return x.to(dtype), P, n


@settings(max_examples=20, deadline=None)
@given(_edge_rows())
@example((torch.zeros((2, 128), dtype=torch.bfloat16), 7, 0))
@example((torch.full((2, 128), float("nan"), dtype=torch.float32), 15, None))
def test_swar_hypothesis_edges(case):
    x, P, n = case
    tf, jf = _fields(P, x.dtype)
    _assert_pack_all_equal(x, tf, jf, (n,), kernels=False)
