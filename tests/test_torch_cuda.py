"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the fixture) where there is no
GPU. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance as in ``chip_smoke.py``: both sides accumulate in f32 and round
to bf16 once, so they differ by at most one bf16 ulp: |d| <= 2^-7 |plain|
+ 1e-3; the attention backward is held per tensor to 2^-6 of its largest
element (``chip_smoke.GRAD_TOL`` says why). The packs (fixed-lane and
bit-plane), the unpacks, the mantissa truncation and the Gecko exponent
pack and unpack are integer arithmetic and must be bit-equal.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs, policies
from repro_torch.codecs import fields_for
from repro_torch.configs.base import reduced
from repro_torch.core import containers
from repro_torch.kernels import bitplane_pack as bp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gecko_pack as gp
from repro_torch.kernels import mantissa_quant as mq
from repro_torch.kernels import ops
from repro_torch.kernels import packed_flash_decode as pfd
from repro_torch.kernels import ref
from repro_torch.kernels import sfp_pack as sp
from repro_torch.models.model import DecoderModel
from repro_torch.train import step as tstep

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    err = (got.float() - want.float()).abs()
    assert bool((err <= 1e-3 + 2 ** -7 * want.float().abs()).all()), \
        err.max().item()


# Fixed-lane geometries: padding bits below the mantissa 0 (sfp8, sfp16
# on f32, sfp16-m7e8), 1 (sfp8-m2e4) and 3 (sfp16 on bf16).
WORD_CONTAINERS = ["sfp8", "sfp16", "sfp8-m2e4", "sfp16-m7e8"]
# One row, one token of the serving shape (36), 333, and rows past the word
# kernels' switch to two-pass tiles (16,896): with a ragged last tile, and
# whole.
WORD_ROWS = (1, 36, 333, 16_901, 48_000)


def _twice(call):
    """The call's outputs, checked bit-equal over two launches."""
    a, b = call(), call()
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    assert all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(a, b))
    return a


@pytest.mark.parametrize("container", WORD_CONTAINERS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sfp_pack_kernel_bytes(dev, container, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    f = fields_for(container, dtype)
    for rows in (333,) + tuple(r for r in WORD_ROWS if r != 333):
        x = torch.randn((rows, 128), generator=g, device=dev)
        x = x * torch.exp2(torch.randint(-30, 30, x.shape, generator=g,
                                         device=dev).float())
        x[::7] = 0.0
        x[1::11] = 1e-39
        x = x.to(dtype)
        kp, kb = _twice(lambda: sp.sfp_pack(x, f))
        pp, pb = sp.plain(x, f)
        assert torch.equal(kp, pp) and torch.equal(kb, pb), rows


@pytest.mark.parametrize("hd,S,rep,window", [(64, 70, 1, None),
                                             (192, 100, 2, 24),
                                             (288, 129, 2, None)])
def test_flash_attention_kernel(dev, hd, S, rep, window):
    g = torch.Generator(device=dev).manual_seed(1)
    B, KH = 2, 2
    q = (torch.randn((B, S * rep, KH, hd), generator=g, device=dev) * 3
         ).to(torch.bfloat16)
    k = torch.randn((B, S, KH, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, KH, hd), generator=g, device=dev).to(torch.bfloat16)
    kw = dict(causal=True, window=window, softcap=50.0, q_rep=rep)
    _close(fa.flash_attention(q, k, v, **kw), fa.plain(q, k, v, **kw))


@pytest.mark.parametrize("container", ["sfp8", "sfp16"])
@pytest.mark.parametrize("L,window,pos", [(48, None, [47, 10]),
                                          (256, None, [255, 130]),
                                          (128, 64, [300, 77])])
def test_packed_flash_decode_kernel(dev, container, L, window, pos):
    g = torch.Generator(device=dev).manual_seed(2)
    B, H, KH, hd = 2, 4, 2, 192
    f = fields_for(container, torch.bfloat16)
    kc = torch.randn((B, L, KH * hd), generator=g, device=dev)
    vc = torch.randn((B, L, KH * hd), generator=g, device=dev)
    kp = ops.sfp_compress_nd(kc.to(torch.bfloat16), f)
    vp = ops.sfp_compress_nd(vc.to(torch.bfloat16), f)
    q = (torch.randn((B, 1, H, hd), generator=g, device=dev) * 3
         ).to(torch.bfloat16)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    args = (q, kp.payload, kp.bases, vp.payload, vp.bases, p, f)
    kw = dict(window=window, softcap=50.0)
    _close(pfd.packed_flash_decode(*args, **kw), pfd.plain(*args, **kw))


def _wide(dev, g, shape, dtype):
    x = torch.randn(shape, generator=g, device=dev)
    x = x * torch.exp2(torch.randint(-30, 30, x.shape, generator=g,
                                     device=dev).float())
    x.view(-1)[::7] = 0.0
    x.view(-1)[1::11] = 1e-39
    return x.to(dtype)


@pytest.mark.parametrize("container", WORD_CONTAINERS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sfp_quantize_pack_and_unpack_kernel_bits(dev, container, dtype):
    g = torch.Generator(device=dev).manual_seed(3)
    f = fields_for(container, dtype)
    top = 7 if dtype == torch.bfloat16 else 23
    for rows in (333,) + tuple(r for r in WORD_ROWS if r != 333):
        x = _wide(dev, g, (rows, 128), dtype)
        for n in (0, 1, 3, f.man_keep, top):
            nd = torch.tensor(n, dtype=torch.int32, device=dev)
            kp, kb = _twice(lambda: sp.sfp_quantize_pack(x, nd, f))
            pp, pb = sp.plain(x, f, n)
            assert torch.equal(kp, pp) and torch.equal(kb, pb), (rows, n)
            ku, = _twice(lambda: sp.sfp_unpack(kp, kb, dtype, f))
            pu = sp.plain_unpack(kp, kb, dtype, f)
            assert torch.equal(ku.view(torch.uint8),
                               pu.view(torch.uint8)), (rows, n)


# bf16 words with a delta field wider than 8 bits: the kernels encode and
# decode them one value a register (``ref.pair_route``).
WIDE_DELTA_WORDS = ["sfp16-m3e10", "sfp16-m1e14"]


@pytest.mark.parametrize("container", WIDE_DELTA_WORDS)
@pytest.mark.parametrize("rows", [333, 1, 36, 16_901])
def test_wide_delta_words_kernel_bits(dev, container, rows):
    """The pack, the fused pack at n none, 0, 1, K and 7, and the unpack
    of every one, bit-equal to the plain versions and over two launches,
    on one- and two-pass tiles."""
    g = torch.Generator(device=dev).manual_seed(rows)
    f = fields_for(container, torch.bfloat16)
    assert not ref.pair_route(torch.bfloat16, f)
    x = _wide(dev, g, (rows, 128), torch.bfloat16)
    for n in (None, 0, 1, f.man_keep, 7):
        if n is None:
            kp, kb = _twice(lambda: sp.sfp_pack(x, f))
        else:
            nd = torch.tensor(n, dtype=torch.int32, device=dev)
            kp, kb = _twice(lambda: sp.sfp_quantize_pack(x, nd, f))
        pp, pb = sp.plain(x, f, n)
        assert torch.equal(kp, pp) and torch.equal(kb, pb), n
        ku, = _twice(lambda: sp.sfp_unpack(kp, kb, torch.bfloat16, f))
        pu = sp.plain_unpack(kp, kb, torch.bfloat16, f)
        assert torch.equal(ku.view(torch.uint8), pu.view(torch.uint8)), n


def test_sfp_unpack_needs_aligned_payload(dev):
    """The word unpack reads a thread's words as one 16- or 8-byte chunk:
    a payload off a 16-byte boundary raises instead of launching."""
    for container in ("sfp8", "sfp16"):
        f = fields_for(container, torch.bfloat16)
        x = torch.randn((4, 128), device=dev).to(torch.bfloat16)
        kp, kb = sp.sfp_pack(x, f)
        raw = kp.view(torch.uint8)
        buf = torch.empty(raw.numel() + 16, dtype=torch.uint8, device=dev)
        off = buf[8:8 + raw.numel()]
        off.copy_(raw.reshape(-1))
        with pytest.raises(ValueError, match="16-byte aligned"):
            sp.sfp_unpack(off.view(f.payload_dtype).view(kp.shape), kb,
                          torch.bfloat16, f)


@pytest.mark.parametrize("shape", [(4, 1024), (1001,), (3,)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mantissa_quantize_kernel_bits(dev, dtype, shape):
    g = torch.Generator(device=dev).manual_seed(4)
    x = _wide(dev, g, shape, dtype)
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for n in range(-1, (7 if dtype == torch.bfloat16 else 23) + 2):
        assert torch.equal(mq.mantissa_quantize(x, n).view(ints),
                           mq.plain(x, n).view(ints)), n


@pytest.mark.parametrize("hd,S,rep,window", [(64, 70, 1, None),
                                             (192, 100, 2, 24),
                                             (288, 129, 2, None)])
def test_flash_attention_backward_kernel(dev, hd, S, rep, window):
    """dq/dk/dv through the autograd Function (forward kernel with LSE,
    backward kernel) against autograd through the plain version."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, KH = 2, 2
    q = (torch.randn((B, S * rep, KH, hd), generator=g, device=dev) * 3
         ).to(torch.bfloat16)
    k, v = (torch.randn((B, S, KH, hd), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    do = torch.randn((B, S * rep, KH, hd), generator=g, device=dev).to(
        torch.bfloat16)
    kw = dict(causal=True, window=window, softcap=50.0, q_rep=rep)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fa.flash_attention_bwd.launches
    out = fa.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    assert fa.flash_attention_bwd.launches == before + 1
    want = fa.plain_bwd(q, k, v, do, **kw)
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2 ** -6 * b.float().abs().max().item(), err


@pytest.mark.parametrize("container,dtype", [
    ("sfp-m1e2", torch.bfloat16), ("sfp-m2e4", torch.bfloat16),
    ("sfp-m3e5", torch.bfloat16), ("sfp-m7e7", torch.bfloat16),
    ("sfp-m9e5", torch.float32), ("sfp-m2e4", torch.float32)])
def test_bitplane_pack_and_unpack_kernel_bits(dev, container, dtype):
    """333 rows, one token of the serving shape (36 rows), one row, and
    rows past the kernels' switch to two-pass tiles (16,896), whole and
    with a ragged last tile."""
    g = torch.Generator(device=dev).manual_seed(6)
    f = fields_for(container, dtype)
    assert f.dense
    for rows in (333, 36, 1, 16 * 3000, 16 * 1056 + 5):
        x = _wide(dev, g, (rows, 128), dtype)
        kp, kb = bp.bitplane_pack(x, f)
        pp, pb = bp.plain(x, f)
        assert torch.equal(kp, pp) and torch.equal(kb, pb), rows
        for n in (0, 1, f.man_keep, 7 if dtype == torch.bfloat16 else 23):
            nd = torch.tensor(n, dtype=torch.int32, device=dev)
            kp, kb = bp.bitplane_quantize_pack(x, nd, f)
            pp, pb = bp.plain(x, f, n)
            assert torch.equal(kp, pp) and torch.equal(kb, pb), (rows, n)
            ku = bp.bitplane_unpack(kp, kb, dtype, f)
            pu = bp.plain_unpack(kp, kb, dtype, f)
            assert torch.equal(ku.view(torch.uint8),
                               pu.view(torch.uint8)), (rows, n)


def test_bitplane_unpack_needs_aligned_planes(dev):
    """The unpack copies 16-byte plane chunks: planes off a 16-byte
    boundary raise instead of launching."""
    f = fields_for("sfp-m2e4", torch.bfloat16)
    x = torch.randn((4, 128), device=dev).to(torch.bfloat16)
    kp, kb = bp.bitplane_pack(x, f)
    buf = torch.empty(kp.numel() + 16, dtype=torch.uint8, device=dev)
    off = buf[4:4 + kp.numel()].view(kp.shape)
    off.copy_(kp)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bp.bitplane_unpack(off, kb, torch.bfloat16, f)


@pytest.mark.parametrize("container", ["sfp-m2e4", "sfp-m7e7", "sfp-m1e2"])
@pytest.mark.parametrize("L,window,pos", [(48, None, [47, 10]),
                                          (128, 64, [300, 77])])
def test_packed_flash_decode_dense_kernel(dev, container, L, window, pos):
    g = torch.Generator(device=dev).manual_seed(7)
    B, H, KH, hd = 2, 4, 2, 192
    f = fields_for(container, torch.bfloat16)
    kc = torch.randn((B, L, KH * hd), generator=g, device=dev)
    vc = torch.randn((B, L, KH * hd), generator=g, device=dev)
    kp = ops.sfp_compress_nd(kc.to(torch.bfloat16), f)
    vp = ops.sfp_compress_nd(vc.to(torch.bfloat16), f)
    q = (torch.randn((B, 1, H, hd), generator=g, device=dev) * 3
         ).to(torch.bfloat16)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    args = (q, kp.payload, kp.bases, vp.payload, vp.bases, p, f)
    kw = dict(window=window, softcap=50.0)
    _close(pfd.packed_flash_decode_dense(*args, **kw), pfd.plain(*args, **kw))


def _decode_inputs(dev, g, container, B, L, H, KH, hd):
    """Packed K/V (B, L, KH*hd) with flush words (zeros, subnormals and
    values far below their group's base) and a bf16 query."""
    f = fields_for(container, torch.bfloat16)
    kp = ops.sfp_compress_nd(_wide(dev, g, (B, L, KH * hd), torch.bfloat16), f)
    vp = ops.sfp_compress_nd(_wide(dev, g, (B, L, KH * hd), torch.bfloat16), f)
    q = (torch.randn((B, 1, H, hd), generator=g, device=dev) * 3
         ).to(torch.bfloat16)
    return f, q, kp, vp


def _moderate(dev, g, shape):
    """Normal values over 2^+-3 with zeros and subnormals (flush words)."""
    x = torch.randn(shape, generator=g, device=dev)
    x = x * torch.exp2(torch.randint(-3, 3, x.shape, generator=g,
                                     device=dev).float())
    x.view(-1)[::7] = 0.0
    x.view(-1)[1::11] = 1e-39
    return x.to(torch.bfloat16)


def _decoders(f):
    return ((pfd.packed_flash_decode_dense, pfd.paged_flash_decode_dense)
            if f.dense else (pfd.packed_flash_decode, pfd.paged_flash_decode))


# (container, draft depth P'): the engine's default max(P - 1, dexp + 2),
# the shallowest prefix, and for sfp-m5e4 (P = 10) P' = 8, whose word
# tile is one byte though the stored word is not.
DRAFTS = [("sfp8", 7), ("sfp8", 6), ("sfp16", 15), ("sfp-m2e4", 6),
          ("sfp-m5e4", 8), ("sfp-m5e4", 6)]


@pytest.mark.parametrize("container,draft", DRAFTS)
@pytest.mark.parametrize("window,pos", [(None, [255, 130]), (64, [300, 77])])
def test_draft_decode_kernel(dev, container, draft, window, pos):
    """The prefix_planes read against the plain draft read; P' = P
    bit-equal to the full-width read."""
    g = torch.Generator(device=dev).manual_seed(11)
    f, q, kp, vp = _decode_inputs(dev, g, container, 2, 256, 4, 2, 192)
    decode, _ = _decoders(f)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    args = (q, kp.payload, kp.bases, vp.payload, vp.bases, p, f)
    kw = dict(window=window, softcap=50.0)
    _close(decode(*args, prefix_planes=draft, **kw),
           pfd.plain(*args, prefix_planes=draft, **kw))
    assert torch.equal(decode(*args, prefix_planes=f.payload_bits, **kw),
                       decode(*args, **kw))


@pytest.mark.parametrize("container,draft", [("sfp8", None), ("sfp8", 7),
                                             ("sfp-m2e4", None),
                                             ("sfp-m2e4", 6),
                                             ("sfp-m5e4", 8)])
def test_paged_kernel_vs_contiguous_and_plain(dev, container, draft):
    """The paged kernel over a pool is bit-equal to the contiguous kernel
    over the gathered cache (block_l = the pool block), and within one
    bf16 ulp of the plain version. Rows hold trash-block entries past
    their position, one row is idle at position 0 on the trash block."""
    g = torch.Generator(device=dev).manual_seed(12)
    n_phys, bl, nb = 9, 128, 4
    f, q, kp, vp = _decode_inputs(dev, g, container, n_phys, bl, 8, 4, 288)
    q = q[:4].contiguous()
    tables = torch.tensor([[3, 7, 1, 5], [8, 2, 0, 0], [4, 0, 0, 0],
                           [0, 0, 0, 0]], dtype=torch.int32, device=dev)
    pos = torch.tensor([nb * bl - 1, 140, 5, 0], dtype=torch.int32,
                       device=dev)
    contiguous, paged = _decoders(f)
    pool = (kp.payload, kp.bases, vp.payload, vp.bases)
    got = paged(q, *pool, tables, pos, f, softcap=50.0, prefix_planes=draft)
    gathered = [ref.paged_gather(t, tables).contiguous() for t in pool]
    want = contiguous(q, *gathered, pos, f, softcap=50.0, block_l=bl,
                      prefix_planes=draft)
    assert torch.equal(got, want)
    _close(got, pfd.plain_paged(q, *pool, tables, pos, f, softcap=50.0,
                                prefix_planes=draft))


def _gecko_groups(dev, g, G, family):
    """(G, 64) uint8 exponents: uniform bytes (deltas over -255..255, with
    0 and 255 in one column), or the bf16 exponents of normal values,
    plain or after an exponent truncation to 3 or 4 bits."""
    if family == "uniform":
        e = torch.randint(0, 256, (G, 64), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
        e[0, 0], e[0, 8], e[0, 16] = 0, 255, 0
        return e
    x = torch.randn((G, 64), generator=g, device=dev).to(torch.bfloat16)
    if family != "normal":
        x = containers.truncate_exponent(x, int(family[1:]))
    return containers.exponent_field(x)


@pytest.mark.parametrize("family", ["uniform", "normal", "e3", "e4"])
@pytest.mark.parametrize("G", [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 72,
                               127, 128, 129, 4099, 82944])
def test_gecko_pack_and_unpack_kernel_bytes(dev, G, family):
    """Around the kernels' 32-group warp tile (and its 16-group
    alignment), the one-token decode shape (B 4 x 18 groups of gemma2-2b's
    1152 K or V features) and a whole decode cache (x 1152 slots)."""
    g = torch.Generator(device=dev).manual_seed(8)
    e = _gecko_groups(dev, g, G, family)
    got = gp.gecko_pack(e)
    want = gp.plain(e)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    out = gp.gecko_unpack(got[0], got[2])
    assert torch.equal(out, gp.plain_unpack(got[0], got[2]))
    assert torch.equal(out, e)


# -- split-KV: batch invariance, determinism, split boundaries ------------
# (container, prefix_planes): words and planes, full width and draft.
SPLIT_READS = [("sfp8", None), ("sfp8", 7), ("sfp-m2e4", None),
               ("sfp-m2e4", 6)]


@pytest.mark.parametrize("container,draft", SPLIT_READS)
@pytest.mark.parametrize("window", [None, 512])
def test_decode_batch_invariant_and_deterministic(dev, container, draft,
                                                  window):
    """Each row launched alone is bit-equal to the same row inside the
    batch, and two launches on the same inputs are bit-equal (split-KV
    merges in split order, with no floating-point atomics). Rows at 0, 5
    and on split boundaries (127, 128, 255, 256)."""
    g = torch.Generator(device=dev).manual_seed(13)
    B, L = 7, 1152
    f, q, kp, vp = _decode_inputs(dev, g, container, B, L, 8, 4, 288)
    decode, _ = _decoders(f)
    pos = torch.tensor([1151, 0, 5, 127, 128, 255, 256], dtype=torch.int32,
                       device=dev)
    kw = dict(window=window, softcap=50.0, prefix_planes=draft)
    parts = (kp.payload, kp.bases, vp.payload, vp.bases)
    got = decode(q, *parts, pos, f, **kw)
    assert torch.equal(got, decode(q, *parts, pos, f, **kw))
    for r in range(B):
        one = decode(q[r:r + 1].contiguous(),
                     *(t[r:r + 1].contiguous() for t in parts),
                     pos[r:r + 1].contiguous(), f, **kw)
        assert torch.equal(one, got[r:r + 1]), r
    _close(got, pfd.plain(q, *parts, pos, f, **kw))


@pytest.mark.parametrize("container,draft", SPLIT_READS)
def test_paged_batch_invariant_and_deterministic(dev, container, draft):
    """The paged read: each row alone (its own table row) bit-equal to
    the batch, two launches bit-equal."""
    g = torch.Generator(device=dev).manual_seed(14)
    n_phys, bl, nb = 12, 128, 4
    f, q, kp, vp = _decode_inputs(dev, g, container, n_phys, bl, 8, 4, 288)
    q = q[:5].contiguous()
    tables = torch.tensor([[3, 7, 1, 5], [8, 2, 0, 0], [4, 0, 0, 0],
                           [9, 10, 0, 0], [0, 0, 0, 0]], dtype=torch.int32,
                          device=dev)
    pos = torch.tensor([nb * bl - 1, 140, 127, 128, 0], dtype=torch.int32,
                       device=dev)
    _, paged = _decoders(f)
    pool = (kp.payload, kp.bases, vp.payload, vp.bases)
    kw = dict(softcap=50.0, prefix_planes=draft)
    got = paged(q, *pool, tables, pos, f, **kw)
    assert torch.equal(got, paged(q, *pool, tables, pos, f, **kw))
    for r in range(q.shape[0]):
        one = paged(q[r:r + 1].contiguous(), *pool,
                    tables[r:r + 1].contiguous(), pos[r:r + 1].contiguous(),
                    f, **kw)
        assert torch.equal(one, got[r:r + 1]), r
    _close(got, pfd.plain_paged(q, *pool, tables, pos, f, **kw))


@pytest.mark.parametrize("container,draft", [("sfp16", None), ("sfp16", 15),
                                             ("sfp-m5e4", None),
                                             ("sfp-m5e4", 9),
                                             ("sfp-m5e4", 8)])
@pytest.mark.parametrize("window,pos", [(None, [1151, 128, 127, 0]),
                                        (512, [3000, 1500, 777, 256])])
def test_decode_wide_words_hd288(dev, container, draft, window, pos):
    """2-byte words through the 16-byte staging at hd 288: sfp16, and
    sfp-m5e4 (P 10: two SWAR transposes, or one for a P' = 8 draft).
    Values over 2^+-3 with flush words: over 2^+-30 (``_wide``) a 1152-slot
    sum can cancel to 2^-20 of its terms, and then the kernel's split
    order and the plain tile order differ by more than one bf16 ulp in f32
    (both equal the f32 split recurrence of ``split_decode_plain``)."""
    g = torch.Generator(device=dev).manual_seed(15)
    f = fields_for(container, torch.bfloat16)
    kp, vp = (ops.sfp_compress_nd(_moderate(dev, g, (4, 1152, 4 * 288)), f)
              for _ in range(2))
    q = (torch.randn((4, 1, 8, 288), generator=g, device=dev) * 3
         ).to(torch.bfloat16)
    decode, _ = _decoders(f)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    args = (q, kp.payload, kp.bases, vp.payload, vp.bases, p, f)
    kw = dict(window=window, softcap=50.0, prefix_planes=draft)
    _close(decode(*args, **kw), pfd.plain(*args, **kw))


def test_decode_rejects_unaligned_rows(dev):
    """16-byte copies: a payload that does not start 16-byte aligned
    raises; the kernel has no slow path for it."""
    g = torch.Generator(device=dev).manual_seed(16)
    f, q, kp, vp = _decode_inputs(dev, g, "sfp8", 2, 64, 4, 2, 192)
    shifted = torch.empty(kp.payload.numel() + 1, dtype=torch.uint8,
                          device=dev)[1:].view(kp.payload.shape)
    shifted.copy_(kp.payload)
    pos = torch.tensor([63, 10], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pfd.packed_flash_decode(q, shifted, kp.bases, vp.payload, vp.bases,
                                pos, f)


def _attention_inputs(dev, seed, B, S, KH, hd, rep):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((B, S * rep, KH, hd), generator=g, device=dev) * 3
         ).to(torch.bfloat16)
    k, v = (torch.randn((B, S, KH, hd), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    do = torch.randn((B, S * rep, KH, hd), generator=g, device=dev).to(
        torch.bfloat16)
    return q, k, v, do


def _plain_lse(q, k, hd, rep, window, softcap):
    """(B*KH, S*rep) log-sum-exp of the plain version's masked logits."""
    B, Sq, KH, _ = q.shape
    qh, kh = (x.float().permute(0, 2, 1, 3) for x in (q, k))
    logits = qh @ kh.transpose(-1, -2) / hd ** 0.5
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    vis = fa.visible_mask(Sq, k.shape[1], rep, True, window, q.device)
    logits = torch.where(vis, logits, ref.NEG_INF)
    return torch.logsumexp(logits, -1).reshape(B * KH, Sq)


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("S,rep,window", [(70, 1, None), (129, 2, None),
                                          (70, 2, 24), (129, 1, 24)])
def test_flash_attention_tc_every_head_dim(dev, hd, S, rep, window):
    """Every head dim the kernels are built for, S not a multiple of any
    tile: the forward within one bf16 ulp of plain, its log-sum-exp
    against torch.logsumexp of the plain logits, dq/dk/dv within 2^-6 of
    each gradient's largest element."""
    B, KH = 2, 2
    q, k, v, do = _attention_inputs(dev, 13, B, S, KH, hd, rep)
    kw = dict(causal=True, window=window, softcap=50.0, q_rep=rep)
    o, lse = fa._forward(q, k, v, True, window, 50.0, rep, with_lse=True)
    _close(o, fa.plain(q, k, v, **kw))
    torch.testing.assert_close(lse, _plain_lse(q, k, hd, rep, window, 50.0),
                               atol=1e-4, rtol=1e-5)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    for a, b in zip(got, fa.plain_bwd(q, k, v, do, **kw)):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2 ** -6 * b.float().abs().max().item(), err


@pytest.mark.parametrize("hd,window,softcap", [(64, None, None),
                                               (288, None, 50.0),
                                               (288, 24, 50.0)])
def test_flash_attention_deterministic_and_batch_invariant(dev, hd, window,
                                                           softcap):
    """Two launches on the same inputs are bit-equal, and each batch row
    launched alone is bit-equal to the same row inside the batch, forward
    (output and log-sum-exp) and backward (no floating-point atomics; a
    CTA's work depends on its own rows only)."""
    B, KH, S, rep = 3, 2, 129, 2
    q, k, v, do = _attention_inputs(dev, 14, B, S, KH, hd, rep)
    kw = dict(causal=True, window=window, softcap=softcap, q_rep=rep)

    def run(sl):
        a, b_, c, g = (t[sl].contiguous() for t in (q, k, v, do))
        o, lse = fa._forward(a, b_, c, True, window, softcap, rep,
                             with_lse=True)
        return (o, lse, *fa.flash_attention_bwd(a, b_, c, o, g, lse, **kw))

    full, again = run(slice(None)), run(slice(None))
    for x, y in zip(full, again):
        assert torch.equal(x, y)
    for r in range(B):
        alone = run(slice(r, r + 1))
        for i, (x, y) in enumerate(zip(alone, full)):
            want = y[r * KH:(r + 1) * KH] if i == 1 else y[r:r + 1]
            assert torch.equal(x, want), (r, i)


# One training step of a small model on the card (4 layers, d 256, head
# dim 64, which the attention kernels take), by the launch counts of the
# stash and attention wrappers.
STEP_COUNTERS = (sp.sfp_quantize_pack, sp.sfp_unpack,
                 bp.bitplane_quantize_pack, bp.bitplane_unpack,
                 fa.flash_attention, fa.flash_attention_bwd)


def _step_launches(dev, policy, stash_containers=None):
    cfg = dataclasses.replace(reduced(configs.get("gemma2-2b"), n_layers=4,
                                      d_model=256), n_kv_heads=2)
    model = DecoderModel(cfg, policy, device=dev,
                         stash_containers=stash_containers)
    tc = tstep.TrainConfig()
    state = tstep.init_state(model, 0, tc)
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=g, device=dev)
    for c in STEP_COUNTERS:
        c.launches = 0
    _, met = tstep.make_train_step(model, tc)(
        state, {"tokens": tokens, "labels": tokens})
    torch.cuda.synchronize()
    assert torch.isfinite(met["loss"])
    return cfg, {c.__name__: c.launches for c in STEP_COUNTERS}


def test_bitchop_step_launches(dev):
    """bitchop over sfp8: one fused word pack and two unpacks a period, the
    attention kernels twice and once a layer; nothing else."""
    cfg, got = _step_launches(dev, policies.get("bitchop", container="sfp8"))
    assert got == {"sfp_quantize_pack": cfg.n_periods,
                   "sfp_unpack": 2 * cfg.n_periods,
                   "bitplane_quantize_pack": 0, "bitplane_unpack": 0,
                   "flash_attention": 2 * cfg.n_layers,
                   "flash_attention_bwd": cfg.n_layers}


def test_per_layer_step_launches_follow_plan(dev):
    """A per-layer plan of a payload-8 word period (m3e4) and a dense one
    (m2e4): one pack and two unpacks of each family."""
    pol = policies.get("qm+qe", container="sfp-m2e4")
    cfg, got = _step_launches(dev, pol, ("sfp-m3e4", "sfp-m2e4"))
    assert got == {"sfp_quantize_pack": 1, "sfp_unpack": 2,
                   "bitplane_quantize_pack": 1, "bitplane_unpack": 2,
                   "flash_attention": 2 * cfg.n_layers,
                   "flash_attention_bwd": cfg.n_layers}


@pytest.mark.parametrize("codec", ["bit_exact", "sfp8", "sfp16", "sfp-m2e4",
                                   "gecko8"])
def test_compress_grads_kernel_vs_plain(dev, codec):
    """Error feedback through each wire codec's kernels against the same
    round trip on the plain versions, over f32 leaves on and off the
    128-lane group: q and the new residual bit-equal."""
    from repro_torch.train import grad_compress
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = {"w": (384, 256), "odd": (7, 200), "vec": (37,)}
    grads = {k: torch.randn(s, generator=gen, device=dev)
             * torch.exp2(torch.randint(-20, 20, s, generator=gen,
                                        device=dev).float())
             for k, s in shapes.items()}
    residual = {k: 1e-3 * torch.randn(s, generator=gen, device=dev)
                for k, s in shapes.items()}
    out = {}
    for backend in (None, "plain"):
        ops.force_backend(backend)
        try:
            out[backend] = grad_compress.compress_grads(
                {k: v.clone() for k, v in grads.items()},
                {k: v.clone() for k, v in residual.items()}, 5, codec)
        finally:
            ops.force_backend(None)
    torch.cuda.synchronize()
    for part in (0, 1):
        for k in shapes:
            assert torch.equal(out[None][part][k].view(torch.int32),
                               out["plain"][part][k].view(torch.int32)), \
                (codec, part, k)


# Head dims of 16 (mod 32): gemma3-12b's 240 (16 q / 8 KV heads) and
# gemma2-27b's 144 (32 / 16). The attention kernels run them in tiles of
# 256 and 160 columns with the last 16 zero-filled; the decode counts
# 32-lane chunks on the cache's absolute grid, so odd heads start 16 lanes
# into a chunk. No softcap, as these configs have none.
HD16 = [(240, 16, 8), (144, 32, 16)]


def _check_attention(dev, seed, hd, H, KH, window, softcap, S=129):
    """Forward within one bf16 ulp of plain with its log-sum-exp, backward
    within 2^-6; bit-equal twice and row by row against the batch."""
    B, rep = 2, H // KH
    q, k, v, do = _attention_inputs(dev, seed, B, S, KH, hd, rep)
    kw = dict(causal=True, window=window, softcap=softcap, q_rep=rep)

    def run(sl):
        a, b_, c, g = (t[sl].contiguous() for t in (q, k, v, do))
        o, lse = fa._forward(a, b_, c, True, window, softcap, rep,
                             with_lse=True)
        return (o, lse, *fa.flash_attention_bwd(a, b_, c, o, g, lse, **kw))

    full = run(slice(None))
    _close(full[0], fa.plain(q, k, v, **kw))
    torch.testing.assert_close(full[1], _plain_lse(q, k, hd, rep, window,
                                                   softcap),
                               atol=1e-4, rtol=1e-5)
    for a, b in zip(full[2:], fa.plain_bwd(q, k, v, do, **kw)):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2 ** -6 * b.float().abs().max().item(), err
    for x, y in zip(full, run(slice(None))):
        assert torch.equal(x, y)
    for r in range(B):
        for i, (x, y) in enumerate(zip(run(slice(r, r + 1)), full)):
            want = y[r * KH:(r + 1) * KH] if i == 1 else y[r:r + 1]
            assert torch.equal(x, want), (r, i)


@pytest.mark.parametrize("hd,H,KH", HD16)
@pytest.mark.parametrize("window", [None, 24])
def test_flash_attention_hd16_no_softcap(dev, hd, H, KH, window):
    _check_attention(dev, 17, hd, H, KH, window, None)


def _check_decode(dev, seed, hd, H, KH, container, draft, window, pos,
                  softcap=None):
    """Contiguous and ring reads: within one bf16 ulp of plain, each row
    alone bit-equal to the batch, two launches bit-equal."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, L = len(pos), 1152 if window is None else window
    f = fields_for(container, torch.bfloat16)
    kp, vp = (ops.sfp_compress_nd(_moderate(dev, g, (B, L, KH * hd)), f)
              for _ in range(2))
    q = (torch.randn((B, 1, H, hd), generator=g, device=dev) * 3
         ).to(torch.bfloat16)
    decode, _ = _decoders(f)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    parts = (kp.payload, kp.bases, vp.payload, vp.bases)
    kw = dict(window=window, softcap=softcap, prefix_planes=draft)
    got = decode(q, *parts, p, f, **kw)
    assert torch.equal(got, decode(q, *parts, p, f, **kw))
    for r in range(B):
        one = decode(q[r:r + 1].contiguous(),
                     *(t[r:r + 1].contiguous() for t in parts),
                     p[r:r + 1].contiguous(), f, **kw)
        assert torch.equal(one, got[r:r + 1]), r
    _close(got, pfd.plain(q, *parts, p, f, **kw))


@pytest.mark.parametrize("hd,H,KH", HD16)
@pytest.mark.parametrize("container,draft", [("sfp8", None), ("sfp8", 7),
                                             ("sfp-m2e4", None),
                                             ("sfp-m2e4", 6),
                                             ("sfp16", None)])
@pytest.mark.parametrize("window,pos", [(None, [1151, 0, 128, 700]),
                                        (512, [3000, 511, 1500, 77])])
def test_decode_hd16(dev, hd, H, KH, container, draft, window, pos):
    _check_decode(dev, 18, hd, H, KH, container, draft, window, pos)


def _check_paged(dev, seed, hd, H, KH, container, draft):
    """The paged read over trash-block rows: bit-equal to the contiguous
    kernel over the gathered cache, within one bf16 ulp of plain."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_phys, bl = 12, 128
    f = fields_for(container, torch.bfloat16)
    kp, vp = (ops.sfp_compress_nd(_moderate(dev, g, (n_phys, bl, KH * hd)),
                                  f) for _ in range(2))
    q = (torch.randn((4, 1, H, hd), generator=g, device=dev) * 3
         ).to(torch.bfloat16)
    tables = torch.tensor([[3, 7, 1, 5], [8, 2, 0, 0], [4, 0, 0, 0],
                           [0, 0, 0, 0]], dtype=torch.int32, device=dev)
    pos = torch.tensor([511, 140, 127, 0], dtype=torch.int32, device=dev)
    decode, paged = _decoders(f)
    pool = (kp.payload, kp.bases, vp.payload, vp.bases)
    kw = dict(softcap=None, prefix_planes=draft)
    got = paged(q, *pool, tables, pos, f, **kw)
    gathered = [ref.paged_gather(t, tables).contiguous() for t in pool]
    assert torch.equal(got, decode(q, *gathered, pos, f, block_l=bl, **kw))
    _close(got, pfd.plain_paged(q, *pool, tables, pos, f, **kw))


@pytest.mark.parametrize("hd,H,KH", HD16)
@pytest.mark.parametrize("container,draft", [("sfp8", None), ("sfp8", 7),
                                             ("sfp-m2e4", None),
                                             ("sfp-m2e4", 6)])
def test_paged_hd16_vs_contiguous(dev, hd, H, KH, container, draft):
    _check_paged(dev, 19, hd, H, KH, container, draft)


# GQA reps past 8: mistral-large-123b's 12 (96 q / 8 KV heads of 128), 9,
# and 16 (recurrentgemma's; one KV head of 256). The decode kernel sizes
# its per-thread arrays by rep rounded up to a power of two: REP 16 takes
# rep 9-16, and rep 17 raises.
REPS = [(128, 96, 8), (64, 18, 2), (256, 16, 1)]


@pytest.mark.parametrize("hd,H,KH", REPS)
@pytest.mark.parametrize("container,draft", [("sfp8", None), ("sfp8", 7),
                                             ("sfp-m2e4", None),
                                             ("sfp-m2e4", 6)])
@pytest.mark.parametrize("window,pos", [(None, [1151, 0, 128, 700]),
                                        (512, [3000, 511, 1500, 77])])
def test_decode_rep_past_8(dev, hd, H, KH, container, draft, window, pos):
    _check_decode(dev, 20, hd, H, KH, container, draft, window, pos)


@pytest.mark.parametrize("hd,H,KH", REPS)
@pytest.mark.parametrize("container,draft", [("sfp8", None), ("sfp8", 7),
                                             ("sfp-m2e4", None),
                                             ("sfp-m2e4", 6)])
def test_paged_rep_past_8_vs_contiguous(dev, hd, H, KH, container, draft):
    _check_paged(dev, 21, hd, H, KH, container, draft)


@pytest.mark.parametrize("decode", [pfd.packed_flash_decode,
                                    pfd.packed_flash_decode_dense])
def test_decode_rejects_rep_past_16(dev, decode):
    f = fields_for("sfp-m2e4" if "dense" in decode.__name__ else "sfp8",
                   torch.bfloat16)
    kp, vp = (ops.sfp_compress_nd(torch.zeros((1, 128, 128), device=dev,
                                              dtype=torch.bfloat16), f)
              for _ in range(2))
    q = torch.zeros((1, 1, 17, 128), device=dev, dtype=torch.bfloat16)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="rep=17"):
        decode(q, kp.payload, kp.bases, vp.payload, vp.bases, pos, f)


@pytest.mark.parametrize("window", [None, 24])
def test_flash_attention_rep12(dev, window):
    _check_attention(dev, 22, 128, 24, 2, window, None)


# gemma2-27b's attention: head dim 144 (16 mod 32) with its softcap of 50.
@pytest.mark.parametrize("window", [None, 24])
def test_flash_attention_hd144_softcap(dev, window):
    _check_attention(dev, 23, 144, 32, 16, window, 50.0)


@pytest.mark.parametrize("container,draft", [("sfp8", None), ("sfp8", 7),
                                             ("sfp-m2e4", None)])
@pytest.mark.parametrize("window,pos", [(None, [1151, 0, 128, 700]),
                                        (512, [3000, 511, 1500, 77])])
def test_decode_hd144_softcap(dev, container, draft, window, pos):
    _check_decode(dev, 24, 144, 32, 16, container, draft, window, pos,
                  softcap=50.0)


MOE_HEADS = {"olmoe-1b-7b": dict(n_heads=2, n_kv_heads=1, head_dim=128),
             "phi3.5-moe-42b-a6.6b": dict(n_heads=8, n_kv_heads=2,
                                          head_dim=64)}


def _fan_in_experts(params, cfg):
    """Scale every layer's expert matrices in place from E ** -0.5 to
    their own fan-in (d; d_ff_expert for ``w_out``); returns ``params``."""
    E = cfg.n_experts
    for layer in params["layers"]:
        for name, fan_in in (("w_in", cfg.d_model), ("w_gate", cfg.d_model),
                             ("w_out", cfg.d_ff_expert)):
            if name in layer["moe"]:
                with torch.no_grad():
                    layer["moe"][name].mul_((E / fan_in) ** 0.5)
    return params


@pytest.mark.parametrize("arch", list(MOE_HEADS))
def test_moe_generate_and_step_vs_plain(dev, arch):
    """A reduced MoE model (4 experts, top-2; heads cut to one 128-lane KV
    group, phi3.5's at its rep of 4) serves from an sfp8 cache through the
    attention, pack and decode kernels, against the plain path (prefill
    logits close, the same tokens up to a near tie), and takes one qm +
    sfp8 training step on each path: losses within 5e-3, MoE metrics
    finite and the load-balance loss equal up to the kernels' rounding.
    The experts' random weights are scaled from JAX's E ** -0.5 to their
    own fan-in, as the chip smoke's are, so that a routing flip does not
    swamp the residual stream."""
    from repro_torch.serve import engine
    cfg = dataclasses.replace(reduced(configs.get(arch)), **MOE_HEADS[arch])
    model = DecoderModel(cfg, kv_container="sfp8", device=dev)
    params = _fan_in_experts(model.init(0), cfg)
    g = torch.Generator(device="cpu").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (2, 40), generator=g).to(dev)
    before = (fa.flash_attention.launches, pfd.packed_flash_decode.launches)
    res = engine.generate(model, params, prompt, 6)
    assert fa.flash_attention.launches > before[0]
    assert pfd.packed_flash_decode.launches > before[1]
    ops.force_backend("plain")
    try:
        plain = engine.generate(model, params, prompt, 6)
    finally:
        ops.force_backend(None)
    d = (res.prefill_logits - plain.prefill_logits).abs().max().item()
    assert d <= 1.0, d
    first = (res.tokens != plain.tokens).int().argmax(1)
    for b in range(2):
        if bool((res.tokens[b] != plain.tokens[b]).any()):
            assert plain.margins[b, first[b]] < 2.0
    tm = DecoderModel(cfg, "qm", device=dev)
    tc = tstep.TrainConfig()
    batch = {"tokens": prompt, "labels": prompt}
    mets = []
    for backend in (None, "plain"):
        state = tstep.init_state(tm, 0, tc)
        _fan_in_experts(state.params, cfg)
        ops.force_backend(backend)
        try:
            _, met = tstep.make_train_step(tm, tc)(state, batch)
        finally:
            ops.force_backend(None)
        mets.append({k: float(v) for k, v in met.items()})
    k, p = mets
    assert abs(k["loss"] - p["loss"]) <= 5e-3 * abs(p["loss"])
    assert k["loss"] > k["xent"] and p["moe_lb_loss"] > 0
    assert abs(k["moe_lb_loss"] - p["moe_lb_loss"]) <= 1e-2 * p[
        "moe_lb_loss"]


# recurrentgemma-9b's LOCAL layers: 16 q heads over one KV head of 256 (GQA
# rep 16) with a sliding window of 2048. At S 2200 the window cuts the
# attention of the last 152 positions, as a prefill past it does.
@pytest.mark.parametrize("window", [None, 2048])
def test_flash_attention_rep16_hd256_window2048(dev, window):
    _check_attention(dev, 25, 256, 16, 1, window, None, S=2200)


@pytest.mark.parametrize("container,draft", [("sfp8", None), ("sfp8", 7),
                                             ("sfp-m2e4", None),
                                             ("sfp-m2e4", 6)])
def test_decode_rep16_hd256_ring2048(dev, container, draft):
    """The 2048-slot ring of recurrentgemma's LOCAL layers, read at
    positions that wrapped it (4159, 2048), filled it (2047) and did not
    (1000)."""
    _check_decode(dev, 26, 256, 16, 1, container, draft, 2048,
                  [4159, 2048, 2047, 1000])


def test_recurrentgemma_paged_trace_vs_plain(dev):
    """A reduced recurrentgemma (its one KV head widened to 128 lanes; the
    32-slot window makes its rings wrap) serves a seeded 8-request trace
    through ``PagedEngine`` and ``Scheduler`` from an sfp8 pool of 3
    blocks at ``--speculate 4``: the ring reads launch the decode kernel
    at full width and as drafts, every request finishes, and the streams
    equal the plain route's up to a near tie (a first difference only
    where contiguous ``generate``'s plain margin is below 2)."""
    from repro_torch.launch import serve as tserve
    from repro_torch.serve import engine
    from repro_torch.serve.scheduler import Scheduler
    cfg = dataclasses.replace(
        reduced(configs.get("recurrentgemma-9b"), n_layers=5), head_dim=128)
    model = DecoderModel(cfg, kv_container="sfp8", device=dev)
    params = model.init(0)
    args = tserve.build_parser().parse_args(
        ["--arch", "recurrentgemma-9b", "--trace", "--requests", "8",
         "--kv-container", "sfp8", "--max-slots", "3", "--num-blocks", "3",
         "--prompt-len-min", "90", "--prompt-len-max", "126",
         "--max-new-min", "16", "--max-new-max", "40", "--speculate", "4"])
    outs = {}
    for backend in (None, "plain"):
        before = (pfd.packed_flash_decode.launches,
                  pfd.packed_flash_decode.draft_launches)
        ops.force_backend(backend)
        try:
            eng = engine.PagedEngine(model, params, max_slots=3,
                                     max_len=256, num_blocks=3)
            sched = Scheduler(eng)
            reqs = tserve.make_trace(args, cfg.vocab)
            outs[backend] = sched.run(reqs, speculate=4)
        finally:
            ops.force_backend(None)
        assert sched.stats.finished == 8 and eng.pool.used_blocks == 0
        grew = (pfd.packed_flash_decode.launches > before[0],
                pfd.packed_flash_decode.draft_launches > before[1])
        assert grew == ((True, True) if backend is None else (False, False))
    for r in reqs:
        got, want = (list(outs[b][r.uid]) for b in (None, "plain"))
        if got != want:
            t = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            ops.force_backend("plain")
            try:
                ref = engine.generate(
                    model, params, torch.as_tensor(
                        r.prompt, dtype=torch.long, device=dev)[None],
                    r.max_new, 256)
            finally:
                ops.force_backend(None)
            assert ref.margins[0, t] < 2.0, (r.uid, t)


@pytest.mark.parametrize("container", ["sfp8", "sfp-m2e4"])
@pytest.mark.parametrize("draft", [False, True])
@pytest.mark.parametrize("L,window,pos", [(1088, None, [1087, 300]),
                                          (1152, None, [1151, 5]),
                                          (4096, 4096, [5000, 4100])])
def test_shard_view_kernel(dev, container, draft, L, window, pos):
    """The decode kernel's shard view over four sequence shards at the
    port's own split (``shard_split_l``: 272 slots as 8 splits of 34, 288
    as 4 of 64 and a partial one of 32; a wrapped ring), words and
    planes, full width and a draft read: each
    shard's (o, lse) against the plain shard view, the lse exactly
    -inf where a shard sees no slot; the four combined by their
    log-sum-exps against the whole-cache kernel, one bf16 ulp apart."""
    g = torch.Generator(device=dev).manual_seed(3)
    B, H, KH, hd = 2, 8, 4, 288
    f = fields_for(container, torch.bfloat16)
    pp = max(f.payload_bits - 1, f.dexp_bits + 2) if draft else None
    kp, vp = (ops.sfp_compress_nd(torch.randn(
        (B, L, KH * hd), generator=g, device=dev).to(torch.bfloat16), f)
        for _ in range(2))
    q = (torch.randn((B, 1, H, hd), generator=g, device=dev) * 3
         ).to(torch.bfloat16)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    kw = dict(window=window, softcap=50.0, prefix_planes=pp)
    n, parts = L // 4, []
    for r in range(4):
        sl = slice(r * n, (r + 1) * n)
        args = (q, kp.payload[:, sl].contiguous(), kp.bases[:, sl].contiguous(),
                vp.payload[:, sl].contiguous(), vp.bases[:, sl].contiguous(),
                p, f)
        got = pfd.packed_flash_decode_shard(*args, slot0=r * n, L_global=L,
                                            **kw)
        want = ref.packed_flash_decode_shard(*args, slot0=r * n, L_global=L,
                                             block_l=128, **kw)
        assert torch.equal(torch.isinf(got[1]), torch.isinf(want[1]))
        fin = torch.isfinite(want[1])
        assert float((got[1] - want[1])[fin].abs().max()) <= 1e-4
        _close(got[0], want[0])
        parts.append(got)
    lse = torch.stack([x[1] for x in parts])
    w = torch.exp(lse - lse.max(0).values)[..., None]
    o = sum(wi * x[0] for wi, x in zip(w, parts)) / w.sum(0)
    whole = (pfd.packed_flash_decode_dense if f.dense
             else pfd.packed_flash_decode)(q, kp.payload, kp.bases,
                                           vp.payload, vp.bases, p, f, **kw)
    _close(o.to(torch.bfloat16).reshape(whole.shape), whole)


def test_world_of_one_nccl_step_matches_unsharded(dev):
    """The sharded train step over NCCL at a world of one (a (1, 1) mesh)
    in both layouts, two qm + sfp8 steps of the reduced gemma2-2b (bf16,
    d_model 256: heads of 64, a head dim the attention kernels take),
    against the unsharded step from the same seed: every kernel launched
    as often, losses and grad norms at rtol 1e-5, the parameters at 1e-5
    of each leaf's largest element."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.stash import float_leaves
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding as shd
    cfg = reduced(configs.get("gemma2-2b"), n_layers=4, d_model=256)
    corpus = synthetic.MarkovCorpus(synthetic.SyntheticConfig(
        vocab=cfg.vocab, seq_len=64, global_batch=4, seed=0))
    batches = [{k: torch.from_numpy(v).long().to(dev)
                for k, v in corpus.batch(i).items()} for i in range(2)]
    counters = (sp.sfp_quantize_pack, sp.sfp_unpack, fa.flash_attention,
                fa.flash_attention_bwd)
    tc = tstep.TrainConfig(num_microbatches=2)

    def run(model):
        state = tstep.init_state(model, 0, tc)
        step = tstep.make_train_step(model, tc)
        out = []
        for b in batches:
            for c in counters:
                c.launches = 0
            state, met = step(state, b)
            out.append(({k: float(met[k]) for k in ("loss", "grad_norm")},
                        [c.launches for c in counters]))
        return out, [shd.full(t).float() for _, t in
                     float_leaves(state.params)]
    want, want_p = run(DecoderModel(cfg, "qm", device=dev))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        for layout in ("tp", "fsdp"):
            got, got_p = run(DecoderModel(
                cfg, "qm", device=dev, mesh=mesh,
                rules=shd.rules_for(mesh, layout=layout)))
            for (gm, gl), (wm, wl) in zip(got, want):
                assert gl == wl
                for k in gm:
                    assert abs(gm[k] - wm[k]) <= 1e-5 * abs(wm[k]), k
            for a, b in zip(got_p, want_p):
                assert float((a - b).abs().max()) <= \
                    1e-5 * float(b.abs().max())
    finally:
        dist.destroy_process_group()
