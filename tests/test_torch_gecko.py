"""The port's Gecko slice against the JAX package, on the CPU: the plane
machine of the gecko_pack / gecko_unpack kernels, ``core/gecko``,
``core/footprint``, the ``gecko8`` codec and its host stream, training
over a ``gecko8`` stash and serving from ``gecko8`` and ``bit_exact`` KV
caches.

Inputs are made with numpy from a seed and handed to both frameworks bit
for bit. The JAX side runs its ``ref`` backend, and its Pallas Gecko
kernels in interpret mode where the test names them.

Tolerances. The plane machine, the codec's parts and streams, and every
bit count are integer arithmetic and must be equal; the f32 ratios
(``compression_ratio``) agree to 1e-6. Training follows
``tests/test_torch_train.py`` and ``tests/test_torch_qe.py``: f32 loss,
grad norm and penalty to rtol 1e-5 (1e-4 over three steps), the learned
bitlengths after their SGD step to 1e-4 (1e-6 with injected draws), the
gradients (read from AdamW's first moment) to 1e-5 of each tensor's
largest. The JAX composite is built with the container set on itself
(ROADMAP §C). Serving follows ``tests/test_torch_slice.py`` (bf16 logits
to max 0.5 / mean 0.06). JAX's own ``gecko8`` KV cache splices decode
rows into the wrong slots (ROADMAP §C), so the port's decode is held to
JAX's raw-cache model, and its unpacked ``gecko8`` cache to the port's
raw cache, bit for bit on every valid slot.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import codecs as jcodecs
from repro import configs as jconfigs
from repro import policies as jpolicies
from repro.codecs import gecko as jgecko8
from repro.configs.base import reduced as jreduced
from repro.core import containers as jcontainers
from repro.core import footprint as jfootprint
from repro.core import gecko as jgecko
from repro.data import synthetic as jsyn
from repro.kernels import gecko_pack as jgp
from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro.models.model import DecoderModel as JModel
from repro.optim import adamw as jadamw
from repro.optim.schedule import Schedule as JSchedule
from repro.train import step as jstep
from repro_torch import codecs as tcodecs
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import policies as tpolicies
from repro_torch.codecs import gecko as tgecko8
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import containers as tcontainers
from repro_torch.core import footprint as tfootprint
from repro_torch.core import gecko as tgecko
from repro_torch.core.stash import float_leaves
from repro_torch.kernels import gecko_pack as tgp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import Schedule as TSchedule
from repro_torch.serve import engine, kvcache
from repro_torch.train import step as tstep

torch.set_num_threads(2)

GROUP_COUNTS = [1, 127, 128, 129]
FAMILIES = ["uniform", "normal", "e3", "e4"]


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy with the same bits (bf16 -> ml_dtypes bf16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return np.asarray(jax.lax.bitcast_convert_type(
            jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16))
    return t.numpy()


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _tbits(t: torch.Tensor) -> np.ndarray:
    return _bits(_np(t))


def _values(rng, shape, dtype, scale_binades=0):
    """Normal values (spread over 2^+-scale_binades) with planted zeros,
    negative zeros and subnormals, as a tensor of ``dtype``."""
    x = rng.standard_normal(shape)
    if scale_binades:
        x = x * np.exp2(rng.integers(-scale_binades, scale_binades, shape))
    flat = x.reshape(-1)
    idx = rng.permutation(flat.size)
    n = flat.size // 32
    flat[idx[:n]] = 0.0
    flat[idx[n:2 * n]] = -0.0
    flat[idx[2 * n:3 * n]] = 1e-39 * rng.standard_normal(n)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _exponent_groups(family: str, G: int, seed: int = 0) -> np.ndarray:
    """(G, 64) uint8 exponents: uniform bytes (deltas over -255..255, with
    0 and 255 in one column), or the bf16 exponents of normal values, as
    they are or after the exponent truncation to 3 or 4 bits."""
    rng = np.random.default_rng(seed)
    if family == "uniform":
        e = rng.integers(0, 256, (G, 64)).astype(np.uint8)
        e[0, 0], e[0, 8], e[0, 16] = 0, 255, 0
        return e
    x = _values(rng, (G, 64), torch.bfloat16)
    if family != "normal":
        x = tcontainers.truncate_exponent(x, int(family[1:]))
    return tcontainers.exponent_field(x).numpy()


# ---------------------------------------------------------------------------
# The plane machine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("G", GROUP_COUNTS)
def test_plane_encode_decode_matches_jax(G, family):
    """The plain versions against ``repro.kernels.ref`` and against the
    Pallas kernels in interpret mode (which edge-pad G to a block of 128
    groups; the port's kernels take any G)."""
    e = _exponent_groups(family, G, seed=G)
    got = tref.gecko_plane_encode(torch.from_numpy(e))
    for want in (jref.gecko_plane_encode(jnp.asarray(e)),
                 jgp.gecko_pack(jnp.asarray(e), interpret=True)):
        for a, b in zip(got, want):
            assert a.dtype == torch.uint8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bases, widths, planes = got
    assert int(widths.max()) <= 8
    if family == "uniform":
        assert int(widths.max()) == 8   # a delta of 255 needs 8 bits
    out = tref.gecko_plane_decode(bases, planes)
    np.testing.assert_array_equal(out.numpy(), e)
    for want in (jref.gecko_plane_decode(jnp.asarray(bases.numpy()),
                                         jnp.asarray(planes.numpy())),
                 jgp.gecko_unpack(jnp.asarray(bases.numpy()),
                                  jnp.asarray(planes.numpy()),
                                  interpret=True)):
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_plane_layout_is_the_documented_one():
    """Byte [row, p] holds bit p of the row's 8 deltas (bit c for column
    c), p = 0 the sign; a zero delta sets no sign bit; planes above a
    row's width are zero."""
    e = np.full((1, 64), 100, np.uint8)
    e[0, 8 + 3] = 100 - 5          # row 1, column 3: delta -5 (0b101)
    e[0, 16 + 6] = 100 + 2         # row 2, column 6: delta +2 (0b10)
    bases, widths, planes = tref.gecko_plane_encode(torch.from_numpy(e))
    assert widths.tolist() == [[3, 2, 0, 0, 0, 0, 0]]
    p = planes.reshape(7, 9)
    want = torch.zeros(7, 9, dtype=torch.uint8)
    want[0, 0] = want[0, 1] = want[0, 3] = 1 << 3
    want[1, 2] = 1 << 6
    assert torch.equal(p, want)


def test_ops_dispatch_and_wrappers_on_cpu():
    """``ops.gecko_encode`` / ``gecko_decode`` and the kernel wrappers on
    CPU tensors are the plain versions, also under ``force_backend``."""
    e = torch.from_numpy(_exponent_groups("normal", 5))
    want = tref.gecko_plane_encode(e)
    for backend in (None, "plain"):
        tops.force_backend(backend)
        try:
            got = tops.gecko_encode(e)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert torch.equal(tops.gecko_decode(got[0], got[2]), e)
        finally:
            tops.force_backend(None)
    before = (tgp.gecko_pack.launches, tgp.gecko_unpack.launches)
    got = tgp.gecko_pack(e)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(tgp.gecko_unpack(got[0], got[2]), e)
    assert (tgp.gecko_pack.launches, tgp.gecko_unpack.launches) == before


# ---------------------------------------------------------------------------
# core/gecko and core/footprint
# ---------------------------------------------------------------------------


def _exponent_stream(kind: str, n: int):
    rng = np.random.default_rng(n)
    if kind == "uniform":
        return rng.integers(0, 256, n).astype(np.uint8)
    x = _values(rng, (n,), torch.bfloat16, scale_binades=6)
    return tcontainers.exponent_field(x).numpy()


@pytest.mark.parametrize("kind", ["uniform", "activations"])
@pytest.mark.parametrize("n", [7, 64, 1000, 4096])
def test_core_gecko_matches_jax(kind, n):
    e = _exponent_stream(kind, n)
    te, je = torch.from_numpy(e), jnp.asarray(e)
    td, jd = tgecko.encode_delta(te), jgecko.encode_delta(je)
    for a, b in ((td.bases, jd.bases), (td.deltas, jd.deltas),
                 (td.row_widths, jd.row_widths)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert td.n_values == jd.n_values == n
    np.testing.assert_array_equal(tgecko.decode_delta(td).numpy(), e)
    assert float(tgecko.delta_bits(td)) == float(jgecko.delta_bits(jd))
    for bias in (127, 120):
        tb, jb = tgecko.encode_bias(te, bias), jgecko.encode_bias(je, bias)
        np.testing.assert_array_equal(tb.deltas.numpy(), np.asarray(jb.deltas))
        np.testing.assert_array_equal(tb.group_widths.numpy(),
                                      np.asarray(jb.group_widths))
        np.testing.assert_array_equal(tgecko.decode_bias(tb).numpy(), e)
        assert float(tgecko.bias_bits(tb)) == float(jgecko.bias_bits(jb))
    for mode in ("delta", "bias"):
        got = tgecko.compressed_bits(te, mode)
        assert got.dtype == torch.float32
        assert float(got) == float(jgecko.compressed_bits(je, mode))
        np.testing.assert_allclose(
            float(tgecko.compression_ratio(te, mode)),
            float(jgecko.compression_ratio(je, mode)), rtol=1e-6)
        np.testing.assert_array_equal(
            tgecko.per_value_bits(te, mode).numpy(),
            np.asarray(jgecko.per_value_bits(je, mode)))
    with pytest.raises(ValueError, match="unknown gecko mode"):
        tgecko.compressed_bits(te, "rle")


def _report(r):
    return (r.n_values, r.sign_bits, r.mantissa_bits, r.exponent_bits,
            r.metadata_bits, r.total_bits)


def _pair(dtype, shape=(6, 200), relu=False, seed=3):
    x = _values(np.random.default_rng(seed), shape, dtype, scale_binades=20)
    if relu:
        x = torch.clamp(x, min=0)
    return x, jnp.asarray(_np(x))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_footprint_matches_jax(dtype):
    x, jx = _pair(dtype)
    for man in (0, 3, 2.5, 7, 30, torch.tensor(4.25)):
        jman = float(man) if isinstance(man, torch.Tensor) else man
        for kw in (dict(), dict(exp_bits=3.1), dict(exp_bits=4),
                   dict(exp_bits=8), dict(exp_bits=1.0),
                   dict(signless=True), dict(gecko_mode="bias")):
            got = tfootprint.sfp_footprint(x, man, **kw)
            want = jfootprint.sfp_footprint(jx, jman, **kw)
            assert _report(got) == _report(want), (man, kw)
            assert got.vs_fp32() == want.vs_fp32()
            assert got.vs_bf16() == want.vs_bf16()
            assert got.breakdown() == want.breakdown()
    r, jr = _pair(dtype, relu=True)
    for man in (2, 3.5):
        for kw in (dict(), dict(signless=True), dict(gecko_mode="bias")):
            assert _report(tfootprint.sfp_js_footprint(r, man, **kw)) == \
                _report(jfootprint.sfp_js_footprint(jr, man, **kw))
    for a, ja in ((x, jx), (r, jr)):
        for fmt in ("fp32", "bf16", "fp16"):
            assert tfootprint.baseline_bits(a, fmt) == \
                jfootprint.baseline_bits(ja, fmt)
        for bb in (16, 32):
            assert tfootprint.js_bits(a, bb) == jfootprint.js_bits(ja, bb)
            for relu_pool in (False, True):
                assert tfootprint.gist_bits(a, bb, relu_pool=relu_pool) == \
                    jfootprint.gist_bits(ja, bb, relu_pool=relu_pool)


@pytest.mark.parametrize("shape", [(4, 256), (5, 77)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_container_realized_matches_jax(dtype, shape):
    x, jx = _pair(dtype, shape)
    for c in ("bf16", "fp16", "fp32", "sfp8", "sfp16", "bit_exact", "gecko8",
              "sfp-m2e4", "sfp8-m2e5"):
        assert tfootprint.container_realized_bits(x, c) == \
            jfootprint.container_realized_bits(jx, c), c
        if c not in ("bf16", "fp16", "fp32"):
            got = tfootprint.container_realized_report(x, c)
            assert _report(got) == _report(
                jfootprint.container_realized_report(jx, c)), c
            assert got.total_bits == int(tcodecs.get(c).packed_bits(x))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bit_exact_packed_bits_matches_jax(dtype):
    x, jx = _pair(dtype, (8, 128))
    codec, jcodec = tcodecs.get("bit_exact"), jcodecs.get("bit_exact")
    for bits in (None, 0, 3, 7):
        got = codec.packed_bits(x, bits)
        assert isinstance(got, float)
        assert got == jcodec.packed_bits(jx, bits), bits


# ---------------------------------------------------------------------------
# The gecko8 codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [None, 3, 7])
@pytest.mark.parametrize("shape", [(2, 128), (3, 5, 77)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gecko8_codec_matches_jax(dtype, shape, bits):
    """Parts byte-equal, unpack bit-equal, packed_bits and the host stream
    equal to the JAX codec's (the (3, 5, 77) tensor pads its last group)."""
    x, jx = _pair(dtype, shape, seed=len(shape) + (bits or 0))
    codec, jcodec = tcodecs.get("gecko8"), jcodecs.get("gecko8")
    got, want = codec.pack(x, bits), jcodec.pack(jx, bits)
    assert set(got.data) == set(want.data) == {"signman", "bases", "widths",
                                               "planes"}
    for k, v in want.data.items():
        assert got.data[k].dtype == torch.uint8
        np.testing.assert_array_equal(got.data[k].numpy(), np.asarray(v),
                                      err_msg=k)
    np.testing.assert_array_equal(_tbits(codec.unpack(got)),
                                  _bits(jcodec.unpack(want)))
    assert codec.packed_bits(x, bits) == jcodec.packed_bits(jx, bits)
    stream, meta = codec.encode_host(_np(x), bits)
    jstream, jmeta = jcodec.encode_host(np.asarray(jx), bits)
    assert meta == jmeta
    np.testing.assert_array_equal(stream, jstream)
    back = codec.decode_host(stream, meta, shape, dtype)
    np.testing.assert_array_equal(
        _tbits(back), _bits(jcodec.decode_host(jstream, jmeta, shape,
                                               jx.dtype)))
    assert codec.packed_bits(x) == 8 * stream.size


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gecko8_host_round_trip_and_lossless(dtype):
    """bf16 round-trips bit for bit through the host stream (f32 keeps 7
    of its 23 mantissa bits, as ``lossless_for`` says); on normal values
    the stream is smaller than bf16."""
    x, _ = _pair(dtype, (16, 256), seed=9)
    codec = tcodecs.get("gecko8")
    assert codec.lossless_for(dtype) == (dtype == torch.bfloat16)
    assert codec.lossless_for(dtype) == jcodecs.get("gecko8").lossless_for(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    stream, meta = codec.encode_host(x)
    back = codec.decode_host(stream, meta, x.shape, dtype)
    assert back.dtype == dtype and back.shape == x.shape
    if dtype == torch.bfloat16:
        assert torch.equal(back.view(torch.int16), x.view(torch.int16))
        y = torch.from_numpy(np.random.default_rng(1).standard_normal(
            4096).astype(np.float32)).to(dtype)
        assert codec.encode_host(y)[0].size < 2 * y.numel()
    else:
        keep = torch.tensor(-(1 << 16), dtype=torch.int32)   # 7 of 23 bits
        assert torch.equal(back.view(torch.int32),
                           x.view(torch.int32) & keep)
    assert torch.equal(codec.unpack(codec.pack(x)).view(torch.uint8),
                       back.view(torch.uint8))


@pytest.mark.parametrize("n", [1, 64, 1000])
def test_exponent_stream_matches_jax(n):
    e = _exponent_stream("activations", n)
    stream, n_values = tgecko8.pack_exponent_stream(torch.from_numpy(e))
    jstream, jn = jgecko8.pack_exponent_stream(jnp.asarray(e))
    assert n_values == jn == n
    np.testing.assert_array_equal(stream, jstream)
    np.testing.assert_array_equal(
        tgecko8.unpack_exponent_stream(stream, n), e)
    np.testing.assert_array_equal(
        tgecko8.pack_exponent_stream(e)[0], stream)    # numpy input
    bases, widths, planes = tref.gecko_plane_encode(
        tgecko8._exponent_groups(torch.from_numpy(e)))
    assert tgecko8.stream_bytes(widths) == jgecko8.stream_bytes(
        np.asarray(widths)) == stream.size
    parts = tgecko8.parts_from_stream(stream, bases.shape[0])
    for a, b in zip(parts, (bases, widths, planes)):
        np.testing.assert_array_equal(a, b.numpy())
    # Exactly core/gecko's delta_bits plus 11 bits per group.
    G = bases.shape[0]
    assert 8 * stream.size == int(tgecko.compressed_bits(
        torch.from_numpy(e))) + 11 * G


# ---------------------------------------------------------------------------
# Training over a gecko8 stash
# ---------------------------------------------------------------------------

B, S, LR, CONTAINER = 4, 64, 3e-3, "gecko8"
SCHED = dict(kind="cosine", base_lr=LR, warmup_steps=1, total_steps=10)
# Integer learned bits (every Bernoulli draw is 0 on both sides): qm act 3
# / w 5, qe act 4 / w 5. The low-bits step takes qm act 1.5 and qe act 3.5
# with the draw injected as ceil (n 2, e 4), so both stash estimators see
# a one-bit-tighter budget that changes the stash.
INT_BITS = {"qm": {"act": 3.0, "w": 5.0}, "qe": {"act": 4.0, "w": 5.0}}
LOW_BITS = {"qm": {"act": 1.5, "w": 4.5}, "qe": {"act": 3.5, "w": 4.5}}


def _set_learn(learn, values, composite):
    def fill(sub, vals):
        return {k: jnp.full_like(v, vals["act" if k.startswith("act")
                                         else "w"]) for k, v in sub.items()}
    if composite:
        return {s: fill(sub, values[s]) for s, sub in learn.items()}
    return fill(learn, values["qm"])


def _setup(policy, bits, lr=0.05):
    def cut(c, reduced):
        return dataclasses.replace(reduced(c, n_layers=4), n_kv_heads=2,
                                   dtype="float32")
    jc = cut(jconfigs.get("gemma2-2b"), jreduced)
    tc = cut(tconfigs.get("gemma2-2b"), treduced)
    kw = dict(gamma=0.05, lr=lr, container=CONTAINER)
    jsubs = tuple(jpolicies.get(s, **kw) for s in policy.split("+"))
    tsubs = tuple(tpolicies.get(s, **kw) for s in policy.split("+"))
    composite = len(jsubs) > 1
    if composite:
        jp = jpolicies.CompositePolicy(policies=jsubs, container=CONTAINER)
        tp = tpolicies.CompositePolicy(policies=tsubs, container=CONTAINER)
    else:
        (jp,), (tp,) = jsubs, tsubs
    jtc = jstep.TrainConfig(opt=jadamw.AdamWConfig(lr=LR),
                            schedule=JSchedule(**SCHED))
    ttc = tstep.TrainConfig(opt=tadamw.AdamWConfig(lr=LR),
                            schedule=TSchedule(**SCHED))
    jm, tm = JModel(jc, jp), TModel(tc, tp, device="cpu")
    js = jstep.init_state(jm, jax.random.PRNGKey(0), jtc)
    js = js._replace(pstate=js.pstate._replace(
        learn=_set_learn(js.pstate.learn, bits, composite)),
        step=jnp.asarray(1, jnp.int32))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), tc)
    corpus = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0))
    return (jm, jtc, js), (tm, ttc, ts), corpus


def _learn_leaves(learn):
    """(path, tensor or array) of every learned bitlength, composite or
    not."""
    if all(isinstance(v, dict) for v in learn.values()):
        return [((s, k), v) for s, sub in learn.items()
                for k, v in sub.items()]
    return list(learn.items())


def _j_draw(n_float, key, max_bits, min_bits=0):
    nf = jnp.clip(jnp.asarray(n_float, jnp.float32), float(min_bits),
                  float(max_bits))
    return jnp.ceil(nf).astype(jnp.int32)


def _t_draw(n_float, generator, max_bits, min_bits=0, shape=None):
    nf = torch.clamp(n_float.detach().float(), float(min_bits),
                     float(max_bits))
    n = torch.ceil(nf).to(torch.int32)
    return n if shape is None else n.expand(tuple(shape)).clone()


def _one_step(policy, bits, monkeypatch, bits_atol):
    """One step of both packages from one state; the port's stash packs
    recorded. Compares metrics, learned bits, gradients and the period-0
    stash bytes."""
    (jm, jtc, js), (tm, ttc, ts), corpus = _setup(policy, bits)
    b = corpus.batch(0)
    jnew, jmet = jax.jit(jstep.make_train_step(jm, jtc))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    codec = tcodecs.get(CONTAINER)
    packed = []
    pack = codec.pack

    def recording_pack(x, bits=None):
        p = pack(x, bits=bits)
        packed.append((x, bits, p))
        return p
    monkeypatch.setattr(codec, "pack", recording_pack)
    tnew, tmet = tstep.make_train_step(tm, ttc)(
        ts, {k: torch.from_numpy(v).long() for k, v in b.items()})
    monkeypatch.undo()
    for k in ("loss", "xent", "grad_norm", "policy_penalty", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(np.asarray(jmet[k])),
                                   rtol=1e-5, err_msg=k)
    tlearn = dict(_learn_leaves(tnew.pstate.learn))
    for path, v in _learn_leaves(jnew.pstate.learn):
        np.testing.assert_allclose(tlearn[path].detach().numpy(),
                                   np.asarray(v),
                                   atol=bits_atol, err_msg=str(path))
    jm_ = convert.from_jax(jax.tree.map(np.asarray, jnew.opt.m), tm.cfg)
    for (path, m), (_, t) in zip(float_leaves(jm_), float_leaves(tnew.opt.m)):
        a, c = m.numpy(), t.numpy()
        assert np.abs(a - c).max() <= 1e-5 * max(np.abs(a).max(), 1e-30), \
            path
    # The period-0 stash: the embedding (exponents truncated when the
    # policy adapts them), packed by the JAX codec from the same input.
    assert len(packed) == tm.cfg.n_periods
    x0, bits0, p0 = packed[0]
    h0 = jcommon.embed(js.params["embed"], jnp.asarray(b["tokens"]),
                       jm.cfg.d_model ** 0.5)
    if "qe" in policy:
        e = int(np.ceil(bits["qe"]["act"]))
        h0 = jcontainers.truncate_exponent(h0, e)
    np.testing.assert_array_equal(_bits(_np(x0)), _bits(h0))
    want = jcodecs.get(CONTAINER).pack(h0, bits=int(bits0))
    assert int(bits0) == int(np.ceil(bits["qm"]["act"]))
    for k, v in want.data.items():
        np.testing.assert_array_equal(p0.data[k].numpy(), np.asarray(v),
                                      err_msg=k)
    return x0


@pytest.mark.parametrize("policy", ["qm", "qm+qe"])
def test_one_step_gecko8_matches_jax(policy, monkeypatch):
    _one_step(policy, INT_BITS, monkeypatch, bits_atol=1e-4)


def test_low_bits_step_gecko8_matches_jax(monkeypatch):
    """qm+qe from qm 1.5 / qe 3.5 with the draws injected as ceil on both
    sides: the stash keeps 2 mantissa bits of exponents clamped to 4 bits,
    which Gecko then compresses."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcontainers, "stochastic_bitlength", _j_draw)
    mp.setattr(tcontainers, "stochastic_bitlength", _t_draw)
    try:
        x0 = _one_step("qm+qe", LOW_BITS, monkeypatch, bits_atol=1e-6)
    finally:
        mp.undo()
    assert (x0 == 0).float().mean().item() > 0, "nothing flushed"


@pytest.mark.parametrize("policy", ["qm", "qm+qe"])
def test_three_steps_gecko8_match_jax(policy):
    """Learning rate 0 for the bitlengths keeps them integer, so three
    steps stay comparable."""
    (jm, jtc, js), (tm, ttc, ts), corpus = _setup(policy, INT_BITS, lr=0.0)
    jf = jax.jit(jstep.make_train_step(jm, jtc))
    tf = tstep.make_train_step(tm, ttc)
    for i in range(3):
        b = corpus.batch(i)
        js, jmet = jf(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tmet = tf(ts, {k: torch.from_numpy(v).long()
                           for k, v in b.items()})
        for k in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]),
                                       float(np.asarray(jmet[k])),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert ts.step == 4 and ts.opt.count == 3


# ---------------------------------------------------------------------------
# Serving from gecko8 and bit_exact KV caches
# ---------------------------------------------------------------------------

SB, SS, NEW = 2, 40, 6
MAX_LEN = SS + NEW
SERVE_TOL = dict(max=0.5, mean=0.06)   # bf16, as tests/test_torch_slice.py
KV_CONTAINERS = ["gecko8", "bit_exact"]


def _serve_cfgs():
    def cut(c, reduced):
        c = reduced(c, n_layers=4, d_model=256)
        return dataclasses.replace(c, n_heads=4, n_kv_heads=2, head_dim=192,
                                   dtype="bfloat16")
    return (cut(jconfigs.get("gemma2-2b"), jreduced),
            cut(tconfigs.get("gemma2-2b"), treduced))


@pytest.fixture(scope="module")
def jax_serve():
    """JAX's raw-cache model: prefill and greedy stepwise decode; and the
    prefill caches of its gecko8 and bit_exact models (bf16, 4 layers,
    GQA, 192-wide heads, window 32 < the 40-token prompt)."""
    jcfg, tcfg = _serve_cfgs()
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab, (SB, SS)).astype(np.int32)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    logits, cache = jax.jit(lambda p, t: jm.prefill(p, t, MAX_LEN))(
        jp, jnp.asarray(prompt))
    out = {"params": jax.tree.map(np.asarray, jp), "prompt": prompt,
           "prefill": np.asarray(logits)[:, -1], "raw_cache": cache,
           "tcfg": tcfg, "caches": {}, "prefills": {}}
    step = jax.jit(jm.decode_step)
    lg, toks, steps = logits, [], []
    for i in range(NEW):
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        if i == NEW - 1:
            break
        lg, cache = step(jp, cache, tok, jnp.asarray(SS + i, jnp.int32))
        steps.append(np.asarray(lg)[:, -1])
    out.update(tokens=np.concatenate(toks, 1), steps=steps)
    for c in KV_CONTAINERS:
        jmc = JModel(jcfg, kv_container=c)
        lgc, cc = jax.jit(lambda p, t: jmc.prefill(p, t, MAX_LEN))(
            jp, jnp.asarray(prompt))
        out["prefills"][c] = np.asarray(lgc)[:, -1]
        out["caches"][c] = cc
    return out


def _port(run, container):
    tm = TModel(run["tcfg"], kv_container=container, device="cpu")
    return tm, convert.from_jax(run["params"], tm.cfg)


def _close(got, want, tol=SERVE_TOL):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= tol["max"] and d.mean() <= tol["mean"], \
        (d.max(), d.mean())


@pytest.mark.parametrize("container", KV_CONTAINERS)
def test_serving_prefill_logits_and_cache_bytes(jax_serve, container):
    """Prefill logits against JAX's; the packed prefill cache equal to
    JAX's flat parts in every 64-value group whose bf16 K/V (from the
    raw-cache prefills) are equal on both sides (the two frameworks'
    matmuls round a few K/V values to the neighbouring bf16); a bit_exact
    cache holds the raw values on both sides."""
    run = jax_serve
    tm, tp = _port(run, container)
    prompt = torch.from_numpy(run["prompt"]).long()
    logits, tcache = tm.prefill(tp, prompt, MAX_LEN)
    _close(logits[:, -1].float().numpy(), run["prefill"])
    _close(run["prefills"][container], run["prefill"], dict(max=0, mean=0))
    traw_m, _ = _port(run, None)
    _, traw = traw_m.prefill(tp, prompt, MAX_LEN)
    shares = []
    for i in range(tm.cfg.n_layers):
        p, slot = divmod(i, len(tm.cfg.period))
        jpk = run["caches"][container]["periods"][f"slot{slot}"]
        jrw = run["raw_cache"]["periods"][f"slot{slot}"]
        for part in ("k", "v"):
            jraw = _bits(np.asarray(getattr(jrw, part))[p])
            L = jraw.shape[1]
            traw_p = _tbits(getattr(traw["layers"][i], part)).reshape(
                SB, L, -1, 64)
            same = (jraw.reshape(SB, L, -1, 64) == traw_p).all(-1)
            shares.append(same.mean())
            tpt = getattr(tcache["layers"][i], part)
            assert tpt.shape == (SB, L, 384)
            jdata = getattr(jpk, part).data
            if container == "bit_exact":   # the raw values themselves
                got = _tbits(tpt.data["payload"]).reshape(SB, L, -1, 64)
                np.testing.assert_array_equal(got, traw_p)
                np.testing.assert_array_equal(
                    _bits(np.asarray(jdata["payload"])[p]).reshape(
                        SB, L, -1, 64), jraw.reshape(SB, L, -1, 64))
                continue
            flat = kvcache._flat(tpt).data
            for k in ("bases", "widths", "planes"):
                assert tpt.data[k].shape[:3] == (SB, L, 6)
                got = flat[k].numpy().reshape(SB, L, 6, -1)
                want = np.asarray(jdata[k])[p].reshape(SB, L, 6, -1)
                np.testing.assert_array_equal(got[same], want[same], k)
            sm = np.repeat(same, 64, axis=-1).reshape(SB, L, -1)
            np.testing.assert_array_equal(
                tpt.data["signman"].numpy()[sm],
                np.asarray(jdata["signman"])[p][sm])
    # The first layer's K/V come from identical embeddings.
    assert min(shares[:2]) >= 0.9, shares


@pytest.mark.parametrize("container", KV_CONTAINERS)
def test_serving_decode_matches_jax_raw_cache(jax_serve, container):
    """Teacher-forced decode logits against JAX's raw-cache model; after
    every step the unpacked cache equals the port's raw cache bit for bit
    on every valid slot (gecko8 is lossless on bf16); greedy tokens agree
    up to a near tie."""
    run = jax_serve
    tm, tp = _port(run, container)
    raw, _ = _port(run, None)
    prompt = torch.from_numpy(run["prompt"]).long()
    _, cache = tm.prefill(tp, prompt, MAX_LEN)
    _, rcache = raw.prefill(tp, prompt, MAX_LEN)
    codec = tcodecs.get(container)
    for i, want in enumerate(run["steps"]):
        tok = torch.from_numpy(run["tokens"][:, i:i + 1]).long()
        logits, cache = tm.decode_step(tp, cache, tok, SS + i)
        rlogits, rcache = raw.decode_step(tp, rcache, tok, SS + i)
        _close(logits[:, -1].float().numpy(), want)
        for li, kind in enumerate(tm.kinds):
            L = rcache["layers"][li].k.shape[1]
            window = tm.cfg.window if kind == "local" else None
            valid = tops.decode_kv_mask(torch.tensor(SS + i), L, window)
            for part in ("k", "v"):
                got = codec.unpack(kvcache._flat(getattr(
                    cache["layers"][li], part)))
                rv = getattr(rcache["layers"][li], part).reshape(SB, L, -1)
                assert torch.equal(got[:, :L][:, valid].view(torch.int16),
                                   rv[:, valid].view(torch.int16)), \
                    (i, li, part)
        assert torch.equal(logits, rlogits), i
    res = engine.generate(tm, tp, prompt, NEW)
    logits = [run["prefill"]] + run["steps"]
    for b in range(SB):
        diff = np.nonzero(res.tokens[b].numpy() != run["tokens"][b])[0]
        if len(diff):
            t = diff[0]
            top2 = np.sort(logits[t][b])[-2:]
            assert top2[1] - top2[0] < 2 * SERVE_TOL["max"], (b, t)


def test_gecko8_splice_writes_its_own_rows():
    """One row spliced at slot 3 of a (2, 8, 256) bf16 gecko8 cache reads
    back at slot 3 of each batch row and leaves every other slot as it
    was (the splice the JAX package gets wrong)."""
    rng = np.random.default_rng(5)
    codec = tcodecs.get("gecko8")
    x = _values(rng, (2, 8, 256), torch.bfloat16, scale_binades=4)
    cache = kvcache._seq_major(codec.pack(x))
    row = _values(rng, (2, 1, 256), torch.bfloat16, scale_binades=4)
    kvcache._splice(cache, codec.pack(row), torch.tensor([3, 3]))
    want = x.clone()
    want[:, 3] = row[:, 0]
    got = codec.unpack(kvcache._flat(cache))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_kv_cache_init_shapes():
    """gemma2-2b at full width (D 1152): gecko8 keeps 18 groups of 64
    values per slot, bit_exact the bf16 values; no kernel is launched."""
    cfg = tconfigs.get("gemma2-2b")
    before = (tgp.gecko_pack.launches, tgp.gecko_unpack.launches)
    g = kvcache.packed_cache_init(cfg, "global", 2, 130, "gecko8",
                                  device="cpu")
    assert {k: tuple(v.shape) for k, v in g.k.data.items()} == {
        "signman": (2, 256, 1152), "bases": (2, 256, 18, 8),
        "widths": (2, 256, 18, 7), "planes": (2, 256, 18, 63)}
    assert all(int(v.sum()) == 0 for v in g.v.data.values())
    be = kvcache.packed_cache_init(cfg, "local", 2, 130, "bit_exact",
                                   device="cpu")
    assert be.k.data["payload"].shape == (2, 256, 1152)
    assert be.k.data["payload"].dtype == torch.bfloat16
    assert (tgp.gecko_pack.launches, tgp.gecko_unpack.launches) == before
