"""The Gecko kernels' SWAR arithmetic on the CPU.

``ref.gecko_plane_encode_swar`` / ``gecko_plane_decode_swar`` repeat the
body of ``csrc/gecko_pack.cu`` step for step: the byte-SIMD magnitudes and
sign masks, the 8x8 bit transpose, the assembly of a group's 63-byte
record and its unaligned reads and writes in a 32-group warp tile. They
are held byte for byte to the port's plain versions, to the JAX package's
oracles (``repro.kernels.ref.gecko_plane_{encode,decode}``) and to its
Pallas kernels in interpret mode, on the same numpy inputs from a seed.
Tolerance: exact (integer arithmetic).
"""
import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

from repro.kernels import gecko_pack as jgp
from repro.kernels import ref as jref
from repro_torch.core import containers as tcontainers
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

# Around the 32-group warp tile and its 16-group alignment; 72 is the
# one-token decode shape (B 4 x 1152 / 64).
GROUP_COUNTS = [1, 15, 16, 17, 72, 129]
FAMILIES = ["uniform", "normal", "e3", "e4"]


def _exponent_groups(family: str, G: int, seed: int) -> np.ndarray:
    """(G, 64) uint8 exponents: uniform bytes (deltas over -255..255, with
    0 and 255 in one column), or the bf16 exponents of normal values with
    zeros and subnormals, as they are or after the exponent truncation to
    3 or 4 bits."""
    rng = np.random.default_rng(seed)
    if family == "uniform":
        e = rng.integers(0, 256, (G, 64)).astype(np.uint8)
        e[0, 0], e[0, 8], e[0, 16] = 0, 255, 0
        return e
    x = rng.standard_normal((G, 64))
    x[rng.random((G, 64)) < 0.03] = 0.0
    x[rng.random((G, 64)) < 0.03] = 1e-39
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    if family != "normal":
        x = tcontainers.truncate_exponent(x, int(family[1:]))
    return tcontainers.exponent_field(x).numpy()


def _assert_all_equal(e: np.ndarray) -> None:
    """Encode and decode by the mirror, the plain versions, JAX's oracles
    and JAX's interpret kernels: every output byte-equal, and the decode
    returns the input."""
    t = torch.from_numpy(e)
    got = tref.gecko_plane_encode_swar(t)
    for want in (tref.gecko_plane_encode(t),
                 jref.gecko_plane_encode(jnp.asarray(e)),
                 jgp.gecko_pack(jnp.asarray(e), interpret=True)):
        for a, b in zip(got, want):
            assert a.dtype == torch.uint8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bases, _, planes = got
    out = tref.gecko_plane_decode_swar(bases, planes)
    np.testing.assert_array_equal(out.numpy(), e)
    jb, jp = jnp.asarray(bases.numpy()), jnp.asarray(planes.numpy())
    for want in (tref.gecko_plane_decode(bases, planes),
                 jref.gecko_plane_decode(jb, jp),
                 jgp.gecko_unpack(jb, jp, interpret=True)):
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("G", GROUP_COUNTS)
def test_swar_matches_plain_and_jax(G, family):
    _assert_all_equal(_exponent_groups(family, G, seed=G))


def _edge_group() -> np.ndarray:
    """One group whose rows hit every edge: deltas of +255 and -255, an
    all-zero row, a width-8 row, zero deltas beside negative ones, and
    deltas of +-128 and +-127."""
    e = np.zeros((8, 8), np.uint8)
    e[0] = [0, 255, 0, 255, 128, 127, 1, 254]
    e[1] = [255, 0, 255, 0, 0, 0, 0, 0]          # +255, -255
    e[2] = e[0]                                   # all zero deltas
    e[3] = [128, 127, 200, 0, 255, 0, 129, 126]   # width 8, both signs
    e[4] = [0, 255, 0, 254, 128, 126, 1, 254]     # zeros beside -1s
    e[5] = [1, 254, 1, 254, 129, 128, 2, 253]     # +-1
    e[6] = [128, 127, 128, 127, 0, 255, 129, 126]  # +-128, +-127
    e[7] = [0, 0, 0, 0, 0, 0, 0, 0]
    return e.reshape(1, 64)


def test_swar_edge_rows():
    e = _edge_group()
    bases, widths, planes = tref.gecko_plane_encode_swar(torch.from_numpy(e))
    assert widths.tolist() == [[8, 0, 8, 1, 1, 8, 8]]
    sign = planes.reshape(7, 9)[:, 0].tolist()
    assert sign[0] == 0b11111010        # -255 at columns 1 and 3
    assert sign[1] == 0                 # all-zero row: no sign bit
    assert sign[3] == 0b00101000        # -1 at 3 and 5, zeros beside
    _assert_all_equal(e)


_BYTE = st.one_of(st.sampled_from([0, 1, 126, 127, 128, 129, 254, 255]),
                  st.integers(0, 255))
# "copy": the row equals the bases (all-zero deltas); "half": columns
# 0-3 equal the bases, columns 4-7 free.
_ROW = st.sampled_from(["free", "copy", "half"])


@st.composite
def _edge_groups(draw):
    G = draw(st.sampled_from([1, 17]))   # shapes compiled above
    e = np.array(draw(st.lists(_BYTE, min_size=64 * G, max_size=64 * G)),
                 np.uint8).reshape(G, 8, 8)
    for i, mode in enumerate(draw(st.lists(_ROW, min_size=7 * G,
                                           max_size=7 * G))):
        g, r = divmod(i, 7)
        if mode == "copy":
            e[g, r + 1] = e[g, 0]
        elif mode == "half":
            e[g, r + 1, :4] = e[g, 0, :4]
    return e.reshape(G, 64)


@settings(max_examples=40, deadline=None)
@given(_edge_groups())
@example(np.tile(_edge_group(), (17, 1)))
@example(np.zeros((17, 64), np.uint8))
def test_swar_hypothesis_edges(e):
    _assert_all_equal(e)
