"""The port's dense bit-plane containers against the JAX package, on the
CPU: the plane machine, the ``sfp-m{K}e{E}`` names, the dense branch of
the packed decode and tiny ``sfp-m2e4`` serving.

Inputs are made with numpy from a seed and handed to both frameworks bit
for bit; the JAX side runs its ``ref`` backend (its own tests hold the
ref oracles to its interpret kernels).

Tolerances. Packing and unpacking are integer bit machines and must be
equal. The dense decode is compared in f32 (inputs, accumulators,
outputs), where the two sides differ only in summation order and exp/tanh
rounding: atol = rtol = 2e-5, as for the fixed-lane decode (the ref
oracle, not the interpret kernel, is the reference: ROADMAP §C). Serving
in f32: prefill and teacher-forced step logits (softcapped to +-30) to
2e-3, greedy tokens equal.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import codecs as jcodecs
from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.core import containers as jcontainers
from repro.kernels import ref as jref
from repro.models.model import DecoderModel as JModel
from repro_torch import codecs as tcodecs
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import reduced as treduced
from repro_torch.kernels import bitplane_pack as tbp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import packed_flash_decode as tpfd
from repro_torch.kernels import ref as tref
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.serve import engine, kvcache

torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=2e-5)
DENSE_P = [p for p in range(3, 16) if p != 8]


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy with the same bits (bf16 -> ml_dtypes bf16)."""
    if t.dtype == torch.bfloat16:
        return np.asarray(jax.lax.bitcast_convert_type(
            jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16))
    return t.numpy()


def _wide_range(rng, shape, dtype):
    """Values over a wide dynamic range with planted zeros, negative zeros
    and subnormals, so every flush and saturation rule fires."""
    x = rng.standard_normal(shape) * np.exp2(rng.integers(-40, 40, shape))
    flat = x.reshape(-1)
    idx = rng.permutation(flat.size)
    n = flat.size // 16
    flat[idx[:n]] = 0.0
    flat[idx[n:2 * n]] = -0.0
    flat[idx[2 * n:3 * n]] = 1e-39 * rng.standard_normal(n)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _fields(P, dtype):
    """A dense geometry of exactly P payload bits for ``dtype`` (the JAX
    package's and the port's)."""
    man_bits = 7 if dtype == torch.bfloat16 else 23
    dexp = min(4, P - 2)
    man = P - 1 - dexp
    if man > man_bits:
        man, dexp = man_bits, P - 1 - man_bits
    spec = jcontainers.spec_for(jnp.bfloat16 if dtype == torch.bfloat16
                                else jnp.float32)
    jf = jcodecs.dense_fields(man, dexp, spec)
    tf = tcodecs.dense_fields(man, dexp, tref.containers.spec_for(dtype))
    assert jf.payload_bits == P and jf.dense and tuple(tf) == tuple(jf)
    return jf, tf


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("P", DENSE_P)
def test_plane_pack_unpack_bit_exact(P, dtype):
    """nd and flat (ragged) layouts, plain and fused n, every dense P."""
    rng = np.random.default_rng(P)
    jf, tf = _fields(P, dtype)
    x = _wide_range(rng, (3, 5, 256), dtype)
    jx = jnp.asarray(_np(x))
    for n in (None, 0, 1, tf.man_keep):
        tp, tb = tref.bitplane_pack_nd(x, tf, n=n)
        jp, jb = jref.bitplane_pack_nd(jx, jf, n=n)
        assert tp.shape == (3, 5, 2 * P * 16) and tp.dtype == torch.uint8
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        _bits(_np(tref.bitplane_unpack_nd(tp, tb, dtype, tf))),
        _bits(jref.bitplane_unpack_nd(jp, jb, jx.dtype, jf)))
    flat = x.reshape(-1)[:1000]                       # 7 full rows + 104
    tp, tb = tref.bitplane_pack(flat, tf, n=1)
    jp, jb = jref.bitplane_pack(jx.reshape(-1)[:1000], jf, n=1)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        _bits(_np(tref.bitplane_unpack(tp, tb, (1000,), dtype, tf))),
        _bits(jref.bitplane_unpack(jp, jb, (1000,), jx.dtype, jf)))


def test_plane_layout_is_the_documented_one():
    """Byte i of plane p holds bit p of lanes 8i..8i+7, bit j for lane
    8i+j; planes LSB first."""
    words = torch.zeros(128, dtype=torch.int32)
    words[8 * 3 + 5] = 0b101           # lane 29: bits 0 and 2
    planes = tref.plane_pack_words(words, 4).reshape(4, 16)
    want = torch.zeros(4, 16, dtype=torch.uint8)
    want[0, 3] = want[2, 3] = 1 << 5
    assert torch.equal(planes, want)
    assert torch.equal(tref.plane_unpack_words(planes.reshape(-1), 4), words)


def test_codecs_and_ops_dispatch_dense_on_cpu():
    """Through the codec registry and ``ops``: sfp-m2e4 packs to planes in
    both layouts, byte-equal to the JAX codec, and unpacks to the plain
    round trip; the kernel wrappers on CPU tensors are the plain
    versions."""
    rng = np.random.default_rng(7)
    x = _wide_range(rng, (2, 3, 384), torch.bfloat16)
    jx = jnp.asarray(_np(x))
    codec, jcodec = tcodecs.get("sfp-m2e4"), jcodecs.get("sfp-m2e4")
    for shape in ((2, 3, 384), (2, 3, 383)):
        n = int(np.prod(shape))
        xs = x.reshape(-1)[:n].reshape(shape)
        jxs = jx.reshape(-1)[:n].reshape(shape)
        got, want = codec.pack(xs, bits=1), jcodec.pack(jxs, bits=1)
        for k in ("payload", "bases"):
            np.testing.assert_array_equal(got.data[k].numpy(),
                                          np.asarray(want.data[k]))
        np.testing.assert_array_equal(_bits(_np(codec.unpack(got))),
                                      _bits(jcodec.unpack(want)))
        assert codec.packed_bits(xs) == jcodec.packed_bits(jxs)
    f = codec.pack_fields(torch.bfloat16)
    rows = x.reshape(-1, 128)
    kp, kb = tbp.bitplane_quantize_pack(rows, 1, f)
    pp, pb = tref.bitplane_pack_rows(rows, f, 1)
    assert torch.equal(kp, pp) and torch.equal(kb, pb)
    assert torch.equal(tbp.bitplane_unpack(kp, kb, torch.bfloat16, f),
                       tref.bitplane_unpack_rows(kp, kb, torch.bfloat16, f))
    nd = tops.sfp_compress_nd(x, f, n=1)
    assert nd.payload.shape == (2, 3, 3 * 112)
    assert torch.equal(tops.sfp_decompress_nd(nd, torch.bfloat16, f),
                       codec.unpack(codec.pack(x, bits=1)))


@pytest.mark.parametrize("name", ["sfp-m2e4", "sfp-m1e2", "sfp-m3e5",
                                  "sfp-m7e7", "sfp-m9e5", "sfp-m3e4",
                                  "sfp-m30e9", "sfp8-m2e5", "sfp16-m12e3",
                                  "sfp8-m9e9"])
def test_fields_for_and_packed_bits_match_jax(name):
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        tf = tcodecs.fields_for(name, dtype)
        jf = jcodecs.fields_for(name, jdt)
        assert tuple(tf) == tuple(jf), (name, dtype)
        for shape in ((4, 256), (5, 77)):
            assert tcodecs.get(name).packed_bits(
                torch.empty(shape, dtype=dtype, device="meta")) == \
                jcodecs.get(name).packed_bits(jnp.zeros(shape, jdt))


def test_dense_name_matches_jax():
    for man in (0.2, 1.0, 1.5, 2.0, 6.9, 12.0, 14.5):
        for exp in (0.5, 2.0, 3.1, 4.0, 7.0, 8.0):
            assert tcodecs.dense_name(man, exp) == jcodecs.dense_name(man,
                                                                      exp)


@pytest.mark.parametrize("window,pos", [(None, (40, 17)),
                                        (24, (100, 63))])
def test_dense_decode_matches_jax_ref(window, pos):
    """q (B, 1, 4, 192) over 2 KV heads: 3 groups straddle the heads.
    sfp-m2e4 planes from f32 K/V; global and ring (pos past the window)."""
    rng = np.random.default_rng(11)
    B, L, H, KH, hd = 2, 48, 4, 2, 192
    D = KH * hd
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, D)).astype(np.float32)
    v = rng.standard_normal((B, L, D)).astype(np.float32)
    jf = jcodecs.fields_for("sfp-m2e4", jnp.float32)
    tf = tcodecs.fields_for("sfp-m2e4", torch.float32)
    jk, jv = (jref.bitplane_pack_nd(jnp.asarray(a), jf) for a in (k, v))
    tk, tv = (tref.bitplane_pack_nd(torch.from_numpy(a), tf) for a in (k, v))
    for (jp, jb), (tp, tb) in ((jk, tk), (jv, tv)):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    jpos = jnp.asarray(pos, jnp.int32)
    want = jref.packed_flash_decode(jnp.asarray(q), jk[0], jk[1], jv[0],
                                    jv[1], jpos, jf, window=window,
                                    softcap=50.0, block_l=16)
    got = tpfd.packed_flash_decode_dense(
        torch.from_numpy(q), tk[0], tk[1], tv[0], tv[1],
        torch.tensor(pos, dtype=torch.int32), tf, window=window,
        softcap=50.0, block_l=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_dense_cache_init_and_splice():
    """gemma2-2b at full width: a dense sfp-m2e4 slot holds 9 groups x 7
    planes x 16 B = 1008 payload bytes; a decode step's packed row splices
    into it in place."""
    cfg = tconfigs.get("gemma2-2b")
    kv = kvcache.packed_cache_init(cfg, "global", 2, 130, "sfp-m2e4",
                                   device="cpu")
    assert kv.k.data["payload"].shape == (2, 256, 1008)
    assert kv.k.data["payload"].dtype == torch.uint8
    assert kv.k.data["bases"].shape == (2, 256, 9)
    codec = tcodecs.get("sfp-m2e4")
    row = codec.pack(torch.randn(2, 1, 1152).to(torch.bfloat16))
    kvcache._splice(kv.k, row, torch.tensor([3, 200]))
    assert torch.equal(kv.k.data["payload"][1, 200], row.data["payload"][1, 0])
    assert torch.equal(kv.k.data["bases"][0, 3], row.data["bases"][0, 0])
    assert int(kv.k.data["payload"][0, 200].sum()) == 0


# ---------------------------------------------------------------------------
# Tiny sfp-m2e4 serving against the JAX package
# ---------------------------------------------------------------------------

B, S, NEW, CONTAINER = 2, 40, 6, "sfp-m2e4"
MAX_LEN = S + NEW


def _cfgs():
    def cut(c, reduced):
        c = reduced(c, n_layers=4, d_model=256)
        return dataclasses.replace(c, n_heads=4, n_kv_heads=2, head_dim=192,
                                   dtype="float32")
    return (cut(jconfigs.get("gemma2-2b"), jreduced),
            cut(tconfigs.get("gemma2-2b"), treduced))


@pytest.fixture(scope="module")
def jax_serve():
    """JAX prefill + greedy stepwise decode over an sfp-m2e4 cache (f32,
    4 layers, GQA, 192-wide heads, window 32 < the 40-token prompt)."""
    jcfg, tcfg = _cfgs()
    jm = JModel(jcfg, kv_container=CONTAINER)
    jp = jm.init(jax.random.PRNGKey(0))
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    logits, cache = jax.jit(lambda p, t: jm.prefill(p, t, MAX_LEN))(
        jp, jnp.asarray(prompt))
    step = jax.jit(jm.decode_step)
    lg, toks, steps = logits, [], []
    for i in range(NEW):
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        if i == NEW - 1:
            break
        lg, cache = step(jp, cache, tok, jnp.asarray(S + i, jnp.int32))
        steps.append(np.asarray(lg)[:, -1])
    return {"params": jax.tree.map(np.asarray, jp), "prompt": prompt,
            "prefill": np.asarray(logits)[:, -1], "steps": steps,
            "tokens": np.concatenate(toks, 1), "tcfg": tcfg}


def _port(run):
    tm = TModel(run["tcfg"], kv_container=CONTAINER, device="cpu")
    return tm, convert.from_jax(run["params"], tm.cfg)


def test_dense_serving_matches_jax(jax_serve):
    run = jax_serve
    tm, tp = _port(run)
    prompt = torch.from_numpy(run["prompt"]).long()
    logits, cache = tm.prefill(tp, prompt, MAX_LEN)
    assert cache["layers"][0].k.data["payload"].shape[-1] == 3 * 7 * 16
    np.testing.assert_allclose(logits[:, -1].numpy(), run["prefill"],
                               atol=2e-3, rtol=0)
    for i, want in enumerate(run["steps"]):
        tok = torch.from_numpy(run["tokens"][:, i:i + 1]).long()
        logits, cache = tm.decode_step(tp, cache, tok, S + i)
        np.testing.assert_allclose(logits[:, -1].numpy(), want, atol=2e-3,
                                   rtol=0, err_msg=f"step {i}")
    res = engine.generate(tm, tp, prompt, NEW)
    np.testing.assert_array_equal(res.tokens.numpy(), run["tokens"])
