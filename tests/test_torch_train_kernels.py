"""The training slice's kernel functions and quantizer against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks bit
for bit. The JAX side runs its Pallas kernels in interpret mode; the
port's wrappers take their plain versions on CPU tensors.

Tolerances: the quantize+pack, unpack and mantissa truncation are integer
bit machines and must be equal. The attention gradient is compared in
f32, where the port's autograd through its dense attention and
``jax.vjp`` of ``repro.kernels.ref.attention`` differ only in summation
order and exp/tanh rounding: rtol 1e-5 / atol 1e-6 on O(1) inputs. (JAX
cannot differentiate its Pallas flash kernel, so the dense oracle is the
reference.) ``qm_quantize``'s forward is bit-exact and its gradients are
f32 sums of identical terms in another order: rtol 1e-6.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import codecs as jcodecs
from repro.core import containers as jcontainers
from repro.core import quantum_mantissa as jqm
from repro.kernels import mantissa_quant as jmq
from repro.kernels import ref as jref
from repro.kernels import sfp_pack as jsp
from repro_torch import codecs as tcodecs
from repro_torch.core import containers as tcontainers
from repro_torch.core import quantum_mantissa as tqm
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mantissa_quant as tmq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sfp_pack as tsp

torch.set_num_threads(1)

MAN_BITS = {torch.bfloat16: 7, torch.float32: 23}


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy with the same bits (bf16 -> ml_dtypes bf16)."""
    if t.dtype == torch.bfloat16:
        return np.asarray(jax.lax.bitcast_convert_type(
            jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16))
    if t.dtype == torch.uint16:
        return t.to(torch.int32).numpy().astype(np.uint16)
    return t.numpy()


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


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
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _fields(container, dtype):
    tf = tcodecs.fields_for(container, dtype)
    jf = jcodecs.fields_for(container, jnp.float32 if dtype == torch.float32
                            else jnp.bfloat16)
    assert tuple(tf) == tuple(jf)
    return tf, jf


@pytest.mark.parametrize("nsel", ["zero", "one", "full"])
@pytest.mark.parametrize("container", ["sfp8", "sfp16"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sfp_quantize_pack_bit_exact(container, dtype, nsel):
    """The fused pack at the mask edges (n = 0, 1, man_bits) against the
    JAX kernel in interpret mode, in the kernel's row layout and through
    the rank-preserving and flat dispatch entry points."""
    n = {"zero": 0, "one": 1, "full": MAN_BITS[dtype]}[nsel]
    rng = np.random.default_rng(10 + n)
    x = _wide_range(rng, (3, 5, 256), dtype)
    tf, jf = _fields(container, dtype)
    rows = x.reshape(-1, 128)
    kp, kb = tsp.sfp_quantize_pack(rows, n, tf)
    jp, jb = jsp.sfp_quantize_pack(jnp.asarray(_np(rows)), n, fields=jf,
                                   interpret=True)
    np.testing.assert_array_equal(_np(kp), np.asarray(jp))
    np.testing.assert_array_equal(kb.numpy(), np.asarray(jb))
    # A 0-d integer tensor n (a bitlength drawn on the device) is the same.
    kp2, _ = tsp.sfp_quantize_pack(rows, torch.tensor(n, dtype=torch.int32),
                                   tf)
    assert torch.equal(kp, kp2)
    nd = tops.sfp_compress_nd(x, tf, n=n)
    np.testing.assert_array_equal(_np(nd.payload).reshape(-1, 128),
                                  np.asarray(jp))
    np.testing.assert_array_equal(nd.bases.numpy().reshape(-1, 1),
                                  np.asarray(jb))
    y = _wide_range(rng, (3, 50), dtype)  # ragged: tail padded to a row
    flat = tops.sfp_quantize_compress(y, n, tf)
    jflat = jref.sfp_pack(jnp.asarray(_np(y)), jf, n=n)
    np.testing.assert_array_equal(_np(flat.payload), np.asarray(jflat[0]))
    np.testing.assert_array_equal(flat.bases.numpy(), np.asarray(jflat[1]))


@pytest.mark.parametrize("container", ["sfp8", "sfp16"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sfp_unpack_bit_exact(container, dtype):
    """Payloads packed (with flushed zeros, subnormals and saturated
    deltas) unpack to the JAX interpret kernel's bits."""
    rng = np.random.default_rng(20)
    x = _wide_range(rng, (4, 384), dtype)
    tf, jf = _fields(container, dtype)
    p, b = tsp.sfp_quantize_pack(x.reshape(-1, 128), 2, tf)
    got = tsp.sfp_unpack(p, b, dtype, tf)
    want = jsp.sfp_unpack(jnp.asarray(_np(p)), jnp.asarray(b.numpy()),
                          shape=(p.shape[0], 128),
                          dtype=jnp.asarray(_np(x)).dtype, fields=jf,
                          interpret=True)
    np.testing.assert_array_equal(_bits(_np(got)), _bits(want))
    # The dispatch entry points, rank-preserving and flat.
    nd = tops.sfp_decompress_nd(tops.Packed(p.reshape(4, 384),
                                            b.reshape(4, 3)), dtype, tf)
    np.testing.assert_array_equal(_bits(_np(nd)).reshape(-1),
                                  _bits(want).reshape(-1))
    flat = tops.sfp_decompress(tops.Packed(p, b), (7, 200), dtype, tf)
    np.testing.assert_array_equal(_bits(_np(flat)).reshape(-1),
                                  _bits(want).reshape(-1)[:1400])


@pytest.mark.parametrize("shape", [(3, 5, 128), (1001,)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mantissa_quantize_bit_exact(dtype, shape):
    """Every n from -1 to man_bits + 1 (clamped), including a ragged
    size, against the JAX kernel in interpret mode and the JAX package's
    truncate_mantissa."""
    rng = np.random.default_rng(30)
    x = _wide_range(rng, shape, dtype)
    jx = jnp.asarray(_np(x))
    for n in range(-1, MAN_BITS[dtype] + 2):
        want = _bits(jmq.mantissa_quantize(jx, n, interpret=True))
        np.testing.assert_array_equal(_bits(_np(tmq.mantissa_quantize(x, n))),
                                      want, err_msg=f"n={n}")
        np.testing.assert_array_equal(
            _bits(_np(tops.mantissa_quantize(x, torch.tensor(n)))), want)
        np.testing.assert_array_equal(
            _bits(_np(tcontainers.truncate_mantissa(x, n))),
            _bits(jcontainers.truncate_mantissa(jx, n)))


def _fold(q, KH, rep):
    """(B, S, H, D) -> the kernel's folded (B, S*rep, KH, D) rows."""
    B, S, H, D = q.shape
    return q.reshape(B, S, KH, rep, D).transpose(2, 3).reshape(
        B, S * rep, KH, D)


@pytest.mark.parametrize("window,softcap", [(None, None), (None, 50.0),
                                            (32, None), (32, 50.0)])
def test_attention_grad_vs_jax_vjp(window, softcap):
    """dq/dk/dv of the port's attention (autograd through the plain
    route, and the backward kernel's plain version on the folded GQA
    layout) against jax.vjp of the JAX dense oracle; GQA rep 2, f32."""
    rng = np.random.default_rng(40)
    B, S, H, KH, D = 2, 48, 4, 2, 32
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    kw = dict(causal=True, window=window, softcap=softcap)
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.array(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tops.attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6,
                                   err_msg=f"d{name}")
    t = torch.from_numpy
    dqf, dk, dv = tfa.flash_attention_bwd(
        _fold(t(q), KH, 2), t(k), t(v), None, _fold(t(do), KH, 2), None,
        q_rep=2, **kw)
    np.testing.assert_allclose(dqf.numpy(), _fold(t(want[0]), KH, 2).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dk.numpy(), want[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dv.numpy(), want[2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,n", [(torch.bfloat16, 0), (torch.bfloat16, 3),
                                     (torch.bfloat16, 7), (torch.float32, 0),
                                     (torch.float32, 10),
                                     (torch.float32, 23)])
def test_qm_quantize_vs_jax_vjp(dtype, n):
    """At an integer bitlength the draw is n itself on both sides: the
    forward is bit-exact, dx is straight-through and dn is
    sum(g * (Q(x, n+1) - Q(x, n)))."""
    rng = np.random.default_rng(50 + n)
    x = _wide_range(rng, (16, 64), dtype)
    g = rng.standard_normal((16, 64)).astype(np.float32)
    jx = jnp.asarray(_np(x))
    jg = jnp.asarray(g).astype(jx.dtype)
    jout, vjp = jax.vjp(lambda a, m: jqm.qm_quantize(a, m,
                                                     jax.random.PRNGKey(0)),
                        jx, jnp.float32(n))
    jdx, jdn = vjp(jg)
    tn = torch.tensor(float(n), requires_grad=True)
    tx = x.clone().requires_grad_()
    out = tqm.qm_quantize(tx, tn, torch.tensor(n, dtype=torch.int32))
    np.testing.assert_array_equal(_bits(_np(out.detach())), _bits(jout))
    dx, dn = torch.autograd.grad(out, (tx, tn),
                                 torch.from_numpy(g).to(dtype))
    np.testing.assert_array_equal(_bits(_np(dx)), _bits(jdx))
    np.testing.assert_allclose(dn.item(), float(jdn), rtol=1e-6, atol=1e-30)


def test_stochastic_bitlength_draws():
    """floor(n) + Bernoulli(frac(n)) over 4000 draws: only floor and
    floor + 1 occur, with mean n within 5 standard errors; clipping to
    [0, max_bits]; integer n never moves."""
    gen = torch.Generator().manual_seed(0)
    draws = tcontainers.stochastic_bitlength(torch.tensor(3.3), gen, 7,
                                             shape=(4000,))
    assert set(draws.tolist()) == {3, 4}
    se = (0.3 * 0.7 / 4000) ** 0.5
    assert abs(draws.float().mean().item() - 3.3) < 5 * se
    for n, want in ((7.6, 7), (-1.0, 0), (5.0, 5)):
        d = tcontainers.stochastic_bitlength(torch.tensor(n), gen, 7,
                                             shape=(100,))
        assert set(d.tolist()) == {want}, n
    one = tcontainers.stochastic_bitlength(torch.tensor(2.5), gen, 7)
    assert one.shape == () and one.dtype == torch.int32
