"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's, on the CPU, in f32, at recurrentgemma-9b cut by ``reduced``
(d_model 128, lru width 128): the log-depth ``associative_scan`` against
``jax.lax.associative_scan`` at odd and even lengths, ``rglru_forward``
with its cache at S 40 and 300, the one-token ``rglru_decode`` after it,
and the gradients of every leaf against ``jax.vjp``. JAX initialises the
block; its f32 gate vectors and ``lam`` are then redrawn from a seed so
that the gates are not constant and each vector's gradient is exercised.

Tolerances: outputs, states and gradients to 1e-5 of each tensor's
largest element (ROADMAP §C); the scan to 2e-6 of its largest (its
``exp`` may round one ulp from XLA's).
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
from repro.models import rglru as jrg
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced
from repro_torch.convert import to_tensor
from repro_torch.models import rglru as trg

torch.set_num_threads(2)

B = 2


def _cfgs():
    def cut(c, reduced):
        return dataclasses.replace(reduced(c), dtype="float32")
    return (cut(jconfigs.get("recurrentgemma-9b"), jreduced),
            cut(tconfigs.get("recurrentgemma-9b"), treduced))


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def _params(jc, seed=0):
    pf = jcommon.ParamFactory("params", jax.random.PRNGKey(seed),
                              jnp.float32)
    p = jax.tree.map(np.asarray, jrg.rglru_init(pf, jc))
    rng = np.random.default_rng(seed)
    lw = jc.lru_width_
    for k in ("w_r", "b_r", "w_i", "b_i"):
        p[k] = rng.normal(0, 1, lw).astype(np.float32)
    p["lam"] = rng.uniform(-3.0, 1.0, lw).astype(np.float32)
    return p


def _torch(p):
    return jax.tree.map(lambda a: to_tensor(np.asarray(a)), p)


def _h(jc, seq, seed=1):
    return np.random.default_rng(seed).normal(
        0, 1, (B, seq, jc.d_model)).astype(np.float32)


def test_config_and_layer_count_match_jax():
    """Field for field JAX's config (full and reduced); the port's
    ``rglru_init`` draws as many elements as JAX's (on the meta device at
    full size), and JAX's shapes and dtypes."""
    j, t = jconfigs.get("recurrentgemma-9b"), \
        tconfigs.get("recurrentgemma-9b")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.lru_width_ == 4096 and t.remainder == ("rglru", "rglru")
    jc, tc = _cfgs()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    for jcfg, tcfg in ((j, t), (jc, tc)):
        shapes = jrg.rglru_init(jcommon.ParamFactory(
            "shape", dtype=jcfg.compute_dtype), jcfg)
        meta = trg.rglru_init(tcfg, torch.Generator(), "meta",
                              tcfg.compute_dtype)
        assert sum(x.numel() for x in jax.tree.leaves(meta)) == sum(
            int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    tp = trg.rglru_init(tc, torch.Generator().manual_seed(0), "cpu",
                        tc.compute_dtype)
    assert jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)[6:]), tp) \
        == jax.tree.map(lambda s: (tuple(s.shape), np.dtype(s.dtype).name),
                        shapes)


def _jcombine(e1, e2):
    la1, b1 = e1
    la2, b2 = e2
    return la1 + la2, jnp.exp(la2) * b1 + b2


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 40, 300])
def test_associative_scan_groups_as_jax(n):
    """The log-depth scan of (log a, b) pairs: the decays' sums equal
    JAX's and the states within 2e-6 of their largest."""
    rng = np.random.default_rng(n)
    la = -rng.uniform(0, 3, (B, n, 5)).astype(np.float32)
    b = rng.normal(0, 1, (B, n, 5)).astype(np.float32)
    jl, jb = jax.lax.associative_scan(_jcombine, (jnp.asarray(la),
                                                  jnp.asarray(b)), axis=1)
    tl, tb = trg.associative_scan(trg._combine, (torch.from_numpy(la),
                                                 torch.from_numpy(b)), dim=1)
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert _rel_to_max(jb, tb.numpy()) <= 2e-6


@pytest.mark.parametrize("seq", [40, 300])
def test_rglru_forward_and_cache_match_jax(seq):
    jc, tc = _cfgs()
    p = _params(jc)
    h = _h(jc, seq)
    jo, jcache = jrg.rglru_forward(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(h), jc, return_cache=True)
    to, tcache = trg.rglru_forward(_torch(p), torch.from_numpy(h), tc,
                                   return_cache=True)
    assert _rel_to_max(jo, to.numpy()) <= 1e-5
    for name in trg.LRUCache._fields:
        assert _rel_to_max(getattr(jcache, name),
                           getattr(tcache, name).numpy()) <= 1e-5, name
    assert tcache.state.dtype == torch.float32


def test_rglru_decode_continues_the_prefill_as_jax():
    jc, tc = _cfgs()
    p = _params(jc)
    jp, tp = jax.tree.map(jnp.asarray, p), _torch(p)
    h = _h(jc, 40)
    _, jcache = jrg.rglru_forward(jp, jnp.asarray(h), jc, return_cache=True)
    _, tcache = trg.rglru_forward(tp, torch.from_numpy(h), tc,
                                  return_cache=True)
    steps = _h(jc, 5, seed=4)
    for i in range(5):
        x = steps[:, i:i + 1]
        jo, jcache = jrg.rglru_decode(jp, jnp.asarray(x), jcache, jc)
        to, tcache = trg.rglru_decode(tp, torch.from_numpy(x), tcache, tc)
        assert _rel_to_max(jo, to.numpy()) <= 1e-5, i
        for name in trg.LRUCache._fields:
            assert _rel_to_max(getattr(jcache, name),
                               getattr(tcache, name).numpy()) <= 1e-5


@pytest.mark.parametrize("seq", [40, 300])
def test_rglru_gradients_match_jax_vjp(seq):
    """Every leaf's gradient (the f32 gate vectors and ``lam`` included)
    and the input's."""
    jc, tc = _cfgs()
    p = _params(jc)
    h = _h(jc, seq)
    jp = jax.tree.map(jnp.asarray, p)
    jo, vjp = jax.vjp(lambda q, x: jrg.rglru_forward(q, x, jc), jp,
                      jnp.asarray(h))
    g = np.random.default_rng(5).normal(0, 1, jo.shape).astype(np.float32)
    jgp, jgh = vjp(jnp.asarray(g))
    tp = _torch(p)
    leaves = [t.requires_grad_(True) for t in jax.tree.leaves(tp)]
    th = torch.from_numpy(h).requires_grad_(True)
    grads = torch.autograd.grad(trg.rglru_forward(tp, th, tc),
                                leaves + [th], torch.from_numpy(g))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jgp)) + [np.asarray(jgh)]
    for i, (gt, w) in enumerate(zip(grads, want)):
        assert np.isfinite(w).all() and np.abs(w).max() > 0
        assert _rel_to_max(w, gt.numpy()) <= 1e-5, i
