"""The port's Mamba-2 SSD block (``repro_torch.models.mamba2``) against the
JAX package's, on the CPU, in f32, at mamba2-370m cut by ``reduced``
(d_model 128, 8 SSD heads of 32, state 16, chunk 16): ``ssd_forward`` at
S 40 (two chunks and a tail padded with dt = 0) with its cache, the
one-token ``ssd_decode`` after it, and the gradients of every leaf
against ``jax.vjp``. JAX initialises the block; its f32 vectors
(``A_log``, ``D``, ``dt_bias``) are then redrawn from a seed so that each
one's gradient is exercised away from its init.

Also the reference fault the port departs from: at d 128 with
``ssm_chunk`` 128, S 128 and ``dt_bias`` 2.0, JAX's intra-chunk decay
``exp`` overflows where it is masked afterwards, and its gradients turn
NaN; the port masks before the ``exp`` and its gradients are finite and
equal ``jax.vjp`` of a JAX twin that masks there too.

Tolerances: outputs, caches and gradients to 1e-5 of each tensor's
largest element (ROADMAP §C). Elementwise rtol 1e-5 / atol 1e-6 does not
hold for the gradients: an ``A_log`` entry of 0.139 is the cancelling sum
of terms whose head totals reach 19, and the two packages' f32 sums part
by 1.1e-4 there (6e-6 of that tensor's largest).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.models import common as jcommon
from repro.models import mamba2 as jm2
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced
from repro_torch.convert import to_tensor
from repro_torch.models import mamba2 as tm2

torch.set_num_threads(2)

B, S = 2, 40


def _cfgs(**kw):
    def cut(c, reduced):
        return dataclasses.replace(reduced(c), dtype="float32", **kw)
    return (cut(jconfigs.get("mamba2-370m"), jreduced),
            cut(tconfigs.get("mamba2-370m"), treduced))


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def _params(jc, seed=0, dt_bias=None):
    """JAX's block (numpy leaves), its f32 vectors redrawn from ``seed``
    (``dt_bias`` set to a constant when given)."""
    pf = jcommon.ParamFactory("params", jax.random.PRNGKey(seed),
                              jnp.float32)
    p = jax.tree.map(np.asarray, jm2.ssd_init(pf, jc))
    rng = np.random.default_rng(seed)
    H = jc.ssm_heads
    p["A_log"] = rng.uniform(-1.0, 1.0, H).astype(np.float32)
    p["D"] = rng.uniform(0.5, 1.5, H).astype(np.float32)
    p["dt_bias"] = (np.full(H, dt_bias, np.float32) if dt_bias is not None
                    else rng.uniform(-1.0, 0.5, H).astype(np.float32))
    p["norm"]["scale"] = rng.normal(0, 0.1, jc.d_inner).astype(np.float32)
    return p


def _torch(p):
    return jax.tree.map(lambda a: to_tensor(np.asarray(a)), p)


def _h(jc, seq, seed=1):
    return np.random.default_rng(seed).normal(
        0, 1, (B, seq, jc.d_model)).astype(np.float32)


def test_config_and_layer_count_match_jax():
    """Field for field JAX's config (full and reduced); the port's
    ``ssd_init`` draws as many elements as JAX's SSD slot, 1-D leaves
    included (on the meta device at full size), and JAX's shapes and
    dtypes."""
    j, t = jconfigs.get("mamba2-370m"), tconfigs.get("mamba2-370m")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (t.d_inner, t.ssm_heads, t.lru_width_) == (2048, 32, 1024)
    jc, tc = _cfgs()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    for jcfg, tcfg in ((j, t), (jc, tc)):
        shapes = jm2.ssd_init(jcommon.ParamFactory(
            "shape", dtype=jcfg.compute_dtype), jcfg)
        meta = tm2.ssd_init(tcfg, torch.Generator(), "meta",
                           tcfg.compute_dtype)
        assert sum(x.numel() for x in jax.tree.leaves(meta)) == sum(
            int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    tp = tm2.ssd_init(tc, torch.Generator().manual_seed(0), "cpu",
                      tc.compute_dtype)
    assert jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)[6:]), tp) \
        == jax.tree.map(lambda s: (tuple(s.shape), np.dtype(s.dtype).name),
                        shapes)


def test_causal_conv_sums_left_to_right_in_bf16():
    """The conv's bf16 products summed left to right, each rounded, as
    JAX's Python ``sum``: bit-equal, with and without a decode carry."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 9, 64)).astype(np.float32)
    w = rng.normal(0, 0.5, (4, 64)).astype(np.float32)
    st = rng.normal(0, 1, (2, 3, 64)).astype(np.float32)
    jx, jw, jst = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, st))
    tx, tw, tst = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in (x, w, st))
    for state in (None, True):
        jo, js = jm2._causal_conv(jx, jw, jst if state else None)
        to, ts = tm2.causal_conv(tx, tw, tst if state else None)
        assert np.array_equal(np.asarray(jo.astype(jnp.float32)),
                              to.float().numpy())
        if state:
            assert np.array_equal(np.asarray(js.astype(jnp.float32)),
                                  ts.float().numpy())


@pytest.mark.parametrize("seq", [S, 16, 5])
def test_ssd_forward_and_cache_match_jax(seq):
    """``ssd_forward`` with ``return_cache`` at S 40 (padded to 48), one
    whole chunk and a sequence shorter than the chunk: the output, the
    conv tails and the f32 state."""
    jc, tc = _cfgs()
    p = _params(jc)
    h = _h(jc, seq)
    jo, jcache = jm2.ssd_forward(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(h), jc, return_cache=True)
    to, tcache = tm2.ssd_forward(_torch(p), torch.from_numpy(h), tc,
                                 return_cache=True)
    assert _rel_to_max(jo, to.numpy()) <= 1e-5
    for name in tm2.SSDCache._fields:
        assert _rel_to_max(getattr(jcache, name),
                           getattr(tcache, name).numpy()) <= 1e-5, name
    assert tcache.state.dtype == torch.float32


def test_ssd_decode_continues_the_prefill_as_jax():
    """Five ``ssd_decode`` steps after a 40-token prefill, each fed the
    same token embedding on both sides: outputs and caches."""
    jc, tc = _cfgs()
    p = _params(jc)
    jp, tp = jax.tree.map(jnp.asarray, p), _torch(p)
    h = _h(jc, S)
    _, jcache = jm2.ssd_forward(jp, jnp.asarray(h), jc, return_cache=True)
    _, tcache = tm2.ssd_forward(tp, torch.from_numpy(h), tc,
                                return_cache=True)
    steps = _h(jc, 5, seed=4)
    for i in range(5):
        x = steps[:, i:i + 1]
        jo, jcache = jm2.ssd_decode(jp, jnp.asarray(x), jcache, jc)
        to, tcache = tm2.ssd_decode(tp, torch.from_numpy(x), tcache, tc)
        assert _rel_to_max(jo, to.numpy()) <= 1e-5, i
        for name in tm2.SSDCache._fields:
            assert _rel_to_max(getattr(jcache, name),
                               getattr(tcache, name).numpy()) <= 1e-5
    cw = tc.conv_width
    assert tcache.conv_x.shape == (B, cw - 1, tc.d_inner)


def _grads_match(jfwd, p, h, tc, seed=5):
    """The port's gradients of <out, g> and ``jax.vjp``'s of ``jfwd``,
    leaves in JAX's order (``A_log`` first), then the input's."""
    jp = jax.tree.map(jnp.asarray, p)
    jo, vjp = jax.vjp(jfwd, jp, jnp.asarray(h))
    g = np.random.default_rng(seed).normal(0, 1, jo.shape).astype(np.float32)
    jgp, jgh = vjp(jnp.asarray(g))
    tp = _torch(p)
    leaves = [t.requires_grad_(True) for t in jax.tree.leaves(tp)]
    th = torch.from_numpy(h).requires_grad_(True)
    to = tm2.ssd_forward(tp, th, tc)
    grads = torch.autograd.grad(to, leaves + [th], torch.from_numpy(g))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jgp)) + [np.asarray(jgh)]
    return grads, want


def test_ssd_gradients_match_jax_vjp():
    """Every leaf's gradient and the input's, S 40 with its padded tail."""
    jc, tc = _cfgs()
    p = _params(jc)
    grads, want = _grads_match(lambda q, x: jm2.ssd_forward(q, x, jc), p,
                               _h(jc, S), tc)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert np.isfinite(w).all()
        assert _rel_to_max(w, g.numpy()) <= 1e-5, i


def _jax_ssd_masked(params, h, cfg):
    """JAX's ``ssd_forward`` with the intra-chunk mask before the ``exp``:
    the port's departure, written in JAX (no padding: S divides the
    chunk)."""
    Bn, Sn, _ = h.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    cs = min(cfg.ssm_chunk, Sn)
    x, z, Bp, Cp, dt, A, _ = jm2._projections(params, h, cfg)
    nc = Sn // cs
    xc = x.reshape(Bn, nc, cs, H, P).astype(jnp.float32)
    Bc = Bp.reshape(Bn, nc, cs, H, N).astype(jnp.float32)
    Cc = Cp.reshape(Bn, nc, cs, H, N).astype(jnp.float32)
    dtc = dt.reshape(Bn, nc, cs, H)
    cum = jnp.cumsum(dtc * A[None, None, None, :], axis=2)
    total = cum[:, :, -1, :]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = jnp.tril(jnp.ones((cs, cs), bool))[None, None, :, :, None]
    L = jnp.exp(jnp.where(mask, diff, -jnp.inf))
    M = jnp.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * L
    y_intra = jnp.einsum("bcijh,bcjhp->bcihp", M, xc * dtc[..., None])
    decay_to_end = jnp.exp(total[:, :, None, :] - cum)
    state_c = jnp.einsum("bcjhn,bcjh,bcjhp->bchnp", Bc, decay_to_end * dtc,
                         xc)

    def scan_fn(carry, inp):
        st, dec = inp
        return carry * jnp.exp(dec)[:, :, None, None] + st, carry

    _, prev = jax.lax.scan(scan_fn, jnp.zeros((Bn, H, N, P), jnp.float32),
                           (jnp.moveaxis(state_c, 1, 0),
                            jnp.moveaxis(total, 1, 0)))
    y_inter = jnp.einsum("bcihn,bchnp->bcihp", Cc * jnp.exp(cum)[..., None],
                         jnp.moveaxis(prev, 0, 1))
    y = (y_intra + y_inter).reshape(Bn, Sn, H, P)
    y = y + xc.reshape(Bn, Sn, H, P) * params["D"][None, None, :, None]
    y = y.reshape(Bn, Sn, H * P).astype(h.dtype)
    y = jcommon.rmsnorm(params["norm"], y * jax.nn.silu(
        z.astype(jnp.float32)).astype(h.dtype))
    return y @ params["w_out"]


def test_the_reference_overflow_and_the_ports_finite_gradients():
    """At d 128, ``ssm_chunk`` 128, S 128 and ``dt_bias`` 2.0 (dt ~ 2.1 a
    position, ~267 summed over a chunk, past f32's exp limit 88.7):
    JAX's gradient has NaN; the port's forward equals JAX's and its
    gradients are finite and equal ``jax.vjp`` of the JAX twin that masks
    before the exp (which itself equals JAX's forward)."""
    jc, tc = _cfgs(ssm_chunk=128)
    p = _params(jc, dt_bias=2.0)
    p["A_log"][:] = 0.0    # the reference init: |A| = 1
    h = _h(jc, 128)
    jp = jax.tree.map(jnp.asarray, p)
    jo, vjp = jax.vjp(lambda q: jm2.ssd_forward(q, jnp.asarray(h), jc), jp)
    g = np.random.default_rng(6).normal(0, 1, jo.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(g))
    nan = {k: bool(np.isnan(np.asarray(v)).any()) for k, v in jg.items()
           if not isinstance(v, dict)}
    assert nan["A_log"] and nan["dt_bias"] and nan["w_dt"], nan
    twin = _jax_ssd_masked(jp, jnp.asarray(h), jc)
    assert _rel_to_max(jo, twin) <= 1e-6
    to = tm2.ssd_forward(_torch(p), torch.from_numpy(h), tc)
    assert _rel_to_max(jo, to.detach().numpy()) <= 1e-5
    grads, want = _grads_match(lambda q, x: _jax_ssd_masked(q, x, jc), p, h,
                               tc, seed=6)
    # A_log's gradient to 1e-4: the cumulative log decays reach ~270
    # here, where one f32 step is 3e-5, and the two packages' cumsums
    # round differently before exp turns that into the decays' relative
    # error (3.1e-5 of its largest on the CPU); every other leaf to 1e-5.
    for i, (gt, w) in enumerate(zip(grads, want)):
        assert torch.isfinite(gt).all() and np.isfinite(w).all()
        assert _rel_to_max(w, gt.numpy()) <= (1e-4 if i == 0 else 1e-5), i
