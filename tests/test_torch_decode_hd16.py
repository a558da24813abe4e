"""Head dims of 16 (mod 32) on the CPU: the decode kernel's chunk plan and
mirrors, and the attention kernels' recurrence without a softcap.

gemma3-12b's heads are 240 wide (and gemma2-27b's 144): on the flattened
KH*hd axis of a packed cache every odd KV head starts 16 lanes into a
32-lane chunk, so its first chunk's low half is the previous head's and a
chunk counted from the head's start would straddle two 128-lane groups.
The decode kernel counts chunks on the absolute 32-lane grid
(``ref.head_chunks``): each chunk lies in one group and one uint32 of each
plane row. Here, at head dims 48 (the CPU tests' stand-in), 144 and 240:
- the chunk plan covers each head once, one group a chunk;
- ``ref.head_words_swar`` (the kernel's plane expansion chunk by chunk)
  equals the head's slice of the plain bit loop, at full width and as a
  draft: integer work, bit-equal;
- ``split_decode_plain`` (the split recurrence with the scores summed
  chunk by chunk) against the port's plain decode and JAX's
  ``ref.packed_flash_decode`` / ``paged_flash_decode``, words and planes,
  full width and draft, contiguous, ring and paged, in f32 to 2e-5 (the
  order of the sums differs; ``tests/test_torch_decode_split.py``);
- ``flash_attention.plain_tiled`` / ``plain_bwd_tiled`` (the kernels'
  recurrences, which run these head dims in 32-column panels whose last
  16 columns are zeros) against the plain versions and JAX's dense oracle
  without a softcap, to one bf16 ulp and 2^-6 of each gradient's largest
  (``chip_smoke.KERNEL_RTOL`` / ``GRAD_TOL``).
Inputs are made with numpy from a seed and packed by the JAX oracles.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import codecs as jcodecs
from repro.kernels import ref as jref
from repro_torch import codecs as tcodecs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import packed_flash_decode as tpfd
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=2e-5)
OUT_RTOL, OUT_ATOL, GRAD_TOL = 2 ** -7, 1e-3, 2 ** -6
HEAD_DIMS = [48, 144, 240]
KH = 8   # KH * hd a multiple of 128 for each head dim above


def _fields(container):
    return (jcodecs.fields_for(container, jnp.float32),
            tcodecs.fields_for(container, torch.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _values(rng, shape):
    """Normal values over 2^+-3 with zeros and subnormals (flush words)."""
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


# -- the chunk plan ---------------------------------------------------------


@pytest.mark.parametrize("hd", [48, 64, 144, 240, 288])
def test_head_chunks_cover_each_head_once(hd):
    """ceil(hd / 32) chunks a head, whatever its offset; each chunk in one
    128-lane group and on the absolute 32-lane grid; the head's features
    covered once, in order; half chunks only when hd = 16 (mod 32)."""
    for h in range(KH):
        chunks = tref.head_chunks(h, hd)
        assert len(chunks) == -(-hd // 32)
        feats = []
        for c in chunks:
            lanes = range(c.lo + c.offset, c.hi + c.offset)
            assert 0 <= lanes[0] and lanes[-1] < 32
            flat = [32 * c.index + lane for lane in lanes]
            assert flat == [h * hd + f for f in range(c.lo, c.hi)]
            assert len({x // 128 for x in flat}) == 1
            assert c.hi - c.lo in ((16, 32) if hd % 32 else (32,))
            feats.extend(range(c.lo, c.hi))
        assert feats == list(range(hd))
        assert chunks[0].offset == (h * hd) % 32
    with pytest.raises(ValueError):
        tref.head_chunks(0, 40)


@pytest.mark.parametrize("hd,threads", [(48, 64), (144, 160), (240, 256),
                                        (288, 288)])
def test_split_plan_threads_a_warp_a_chunk(hd, threads):
    p = tpfd.split_plan(4, KH, hd, 2176)
    assert (p.threads, p.split_l, p.splits) == (threads, 64, 34)


# -- the plane expansion ----------------------------------------------------


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("container", ["sfp-m2e4", "sfp-m5e4", "sfp-m7e7"])
def test_head_words_swar_bit_equal(hd, container):
    """Each head's words, chunk by chunk from its groups' plane rows, equal
    the head's slice of the bit loop over the whole row; a draft's are
    their leading P' bits."""
    jf, tf = _fields(container)
    P = jf.payload_bits
    rng = np.random.default_rng(hd + P)
    p, _ = _pack(_values(rng, (3, 5, KH * hd)), jf)
    planes = _t(p)
    G = KH * hd // 128
    full = tref.plane_unpack_words(planes.reshape(3, 5, G, P * 16),
                                   P).reshape(3, 5, KH * hd)
    for pp in (None, _draft(jf)):
        shift = 0 if pp is None else P - pp
        for h in range(KH):
            got = tref.head_words_swar(planes, P, h, hd, pp)
            want = full[..., h * hd:(h + 1) * hd] >> shift
            assert torch.equal(got, want), (h, pp)


# -- the split recurrence ---------------------------------------------------


def _contiguous_case(container, hd, L, window, pos, draft, seed):
    jf, tf = _fields(container)
    rng = np.random.default_rng(seed)
    B, H = len(pos), 2 * KH
    q = (rng.standard_normal((B, 1, H, hd)) * 3).astype(np.float32)
    k = _pack(_values(rng, (B, L, KH * hd)), jf)
    v = _pack(_values(rng, (B, L, KH * hd)), jf)
    pp = _draft(jf) if draft else None
    kw = dict(window=window, softcap=None, prefix_planes=pp)
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


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("container", ["sfp8", "sfp-m2e4"])
@pytest.mark.parametrize("draft", [False, True])
def test_split_decode_global(hd, container, draft):
    """L = 192 (a 96-slot tile, 4 splits of 48): rows whose later splits
    are masked, and a full row."""
    _contiguous_case(container, hd, 192, None, [191, 100, 3], draft,
                     seed=hd)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("container", ["sfp16", "sfp-m5e4"])
def test_split_decode_ring_wraps(hd, container):
    """A 128-slot ring under a 96-position window, 2-byte words (sfp16)
    and P 10 planes (two SWAR transposes): windows that wrap past slot
    0."""
    _contiguous_case(container, hd, 128, 96, [300, 127, 200], False,
                     seed=2 * hd)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("container", ["sfp8", "sfp-m2e4"])
@pytest.mark.parametrize("draft", [False, True])
def test_split_decode_paged(hd, container, draft):
    """A pool of 64-slot blocks with trailing trash blocks and an idle row,
    against the plain paged read and JAX's."""
    jf, tf = _fields(container)
    rng = np.random.default_rng(3 * hd)
    bl, n_phys, H = 64, 6, 2 * KH
    k = _pack(_values(rng, (n_phys * bl, KH * hd)), jf)
    v = _pack(_values(rng, (n_phys * bl, KH * hd)), jf)
    pool = [a.reshape(n_phys, bl, -1) for a in (*k, *v)]
    tables = np.array([[1, 4, 2], [5, 0, 0], [0, 0, 0], [3, 2, 0]],
                      np.int32)
    pos = np.array([150, 9, 0, 64], np.int32)
    q = (rng.standard_normal((4, 1, H, hd)) * 3).astype(np.float32)
    pp = _draft(jf) if draft else None
    tin = (torch.from_numpy(q), *map(_t, pool))
    got = tpfd.split_decode_plain(*tin, _t(pos), tf, prefix_planes=pp,
                                  tables=_t(tables))
    want = tref.paged_flash_decode(*tin, _t(tables), _t(pos), tf,
                                   prefix_planes=pp)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    jwant = jref.paged_flash_decode(
        jnp.asarray(q), *map(jnp.asarray, pool), jnp.asarray(tables),
        jnp.asarray(pos), jf, prefix_planes=pp)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **F32_TOL)


def test_chunk_scores_sum_the_head():
    """The scores as partial products over each head's chunks equal the
    whole dot product up to f32 rounding, at every head offset."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, KH, 2, 240)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 64, KH, 240)).astype(
        np.float32))
    want = torch.einsum("bhgd,blhd->bhgl", q, k)
    torch.testing.assert_close(tpfd.chunk_scores(q, k), want, atol=1e-4,
                               rtol=1e-5)


# -- the attention recurrences without a softcap -----------------------------


def _bf16_values(rng, shape, scale=1.0):
    x = torch.from_numpy((rng.standard_normal(shape) * scale)
                         .astype(np.float32))
    return x.to(torch.bfloat16).float()


def _fold(x, kh, rep):
    """(B, S, H, D) -> the kernels' folded (B, S*rep, KH, D) rows."""
    B, S, _, D = x.shape
    return x.reshape(B, S, kh, rep, D).transpose(2, 3).reshape(
        B, S * rep, kh, D)


def _unfold(x, kh, rep):
    B, Sr, _, D = x.shape
    return x.reshape(B, Sr // rep, rep, kh, D).transpose(2, 3).reshape(
        B, Sr // rep, kh * rep, D)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("window", [None, 24])
def test_plain_tiled_no_softcap(hd, window):
    """Folded GQA (q_rep 2), ragged S: the forward recurrence against the
    plain version and JAX's ``ref.attention`` within one bf16 ulp, the
    backward within 2^-6 of each gradient's largest element."""
    rng = np.random.default_rng(hd)
    B, kh, rep, S = 1, 2, 2, 70
    q = _bf16_values(rng, (B, S * rep, kh, hd), 3.0)
    k, v, do = (_bf16_values(rng, shape) for shape in
                ((B, S, kh, hd), (B, S, kh, hd), (B, S * rep, kh, hd)))
    kw = dict(causal=True, window=window, softcap=None, q_rep=rep)
    o, lse = tfa.plain_tiled(q, k, v, **kw)
    jkw = dict(causal=True, window=window, softcap=None)
    jargs = [jnp.asarray(x.numpy()) for x in (_unfold(q, kh, rep), k, v)]
    jo = torch.from_numpy(np.array(jref.attention(*jargs, **jkw)))
    for want in (tfa.plain(q, k, v, **kw), _fold(jo, kh, rep)):
        err = (o - want).abs()
        assert bool((err <= OUT_ATOL + OUT_RTOL * want.abs()).all()), \
            err.max().item()
    got = tfa.plain_bwd_tiled(q, k, v, o, do, lse, **kw)
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, **jkw), *jargs)
    jg = [torch.from_numpy(np.array(g)) for g in
          vjp(jnp.asarray(_unfold(do, kh, rep).numpy()))]
    jg[0] = _fold(jg[0], kh, rep)
    for want_set in (tfa.plain_bwd(q, k, v, do, **kw), jg):
        for name, g, w in zip("qkv", got, want_set):
            e = (g - w).abs().max().item()
            assert e <= GRAD_TOL * w.abs().max().item(), (name, e)
