"""The port's CNN training step (``repro_torch.train.cnn``) against a JAX
step built as the JAX package's ResNet-8 benchmark builds its own (from
``repro.models.cnn``, ``repro.optim.adamw`` and ``repro.core.bitchop``,
here in the test: the benchmark's runner caches its results on disk).

ResNet-8, batch 16, JAX's initial weights handed over by
``convert.cnn_params_from_jax``, JAX's synthetic batches. Modes: ``none``,
``qm`` and ``bitchop`` (warm-up 1, so it decides from the second step),
1 and 3 steps. QM starts on its upper bound, 23 bits, with the
Bernoulli draw injected as ceil(n) on both sides, so its forwards keep
every bit: a truncation to few bits lets a one-ulp convolution
difference flip a value across a boundary, and the flips cascade through
the per-sample norms (``tests/test_torch_cnn.py`` holds the truncating
forwards and their gradients; at batch 16 from 2 bits the first forward
flipped 513 of s2b0.out's values, from 7 bits 8,755, and after one step
the rounding of the weights alone makes later steps flip). Here the
step's own machinery is held: the per-site shares, the penalty, whose
``jclip`` gives half the gradient on the bound as ``jnp.clip`` does
(after step 1 every site sits at 23 - 0.6 lam: the estimator's
Q(x, 23) - Q(x, 23) is 0 there), the estimator's Q(x, 23) - Q(x, 22)
from step 2 on, the bitlengths' SGD and AdamW. One truncating QM step is
held too: from 2 bits, at batch 2, where the forwards flip nothing.

Tolerances (ROADMAP's training rules). After one step: the loss (with
QM's penalty), xent and pre-clip grad norm to rtol 1e-5; the learned
bitlengths to 1e-4; BitChop's n equal; the gradients, read back from
AdamW's first moment (m = 0.1 * clipped g), within 1e-5 of each tensor's
largest; parameters to rtol 1e-4 / atol 1e-6 where |g| > 1e-6 and within
2 lr + 1e-6 everywhere (Adam's first step is g / (|g| + 1e-8)). Over 3
steps: loss, xent and grad norm to rtol 1e-4, bitlengths to 1e-4, n
equal at every step. ``stash_footprint`` equals the benchmark's
``footprint_for`` integer for integer on the same stash.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import policies as jpolicies
from repro.core import bitchop as jbitchop
from repro.core import containers as jcontainers
from repro.models import cnn as jcnn
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch import policies as tpolicies
from repro_torch.core import containers as tcontainers
from repro_torch.core.stash import float_leaves
from repro_torch.models import cnn as tcnn
from repro_torch.train import cnn as tcnn_train

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from benchmarks.table1_footprint import footprint_for  # noqa: E402

torch.set_num_threads(2)

CFG_J, CFG_T = jcnn.RESNET8, tcnn.RESNET8
BATCH, QM_BITS, BC_WARMUP = 16, 23.0, 1


def _inject(monkeypatch):
    def j_draw(n_float, key, max_bits, min_bits=0):
        nf = jnp.clip(jnp.asarray(n_float, jnp.float32), float(min_bits),
                      float(max_bits))
        return jnp.ceil(nf).astype(jnp.int32)

    def t_draw(n_float, generator, max_bits, min_bits=0, shape=None):
        nf = torch.clamp(n_float.detach().float(), float(min_bits),
                         float(max_bits))
        n = torch.ceil(nf).to(torch.int32)
        return n if shape is None else n.expand(tuple(shape)).clone()

    monkeypatch.setattr(jcontainers, "stochastic_bitlength", j_draw)
    monkeypatch.setattr(tcontainers, "stochastic_bitlength", t_draw)


def _jax_run(mode, qm_bits):
    """JAX model, params, per-site state and jitted step, as the
    benchmark's ResNet-8 runner builds them."""
    m = jcnn.CNN(CFG_J, jpolicies.get(mode, container="bit_exact"))
    params = m.init(jax.random.PRNGKey(0))
    ocfg = jadamw.AdamWConfig(lr=1e-2, weight_decay=0.0)
    probe = m.forward(params, jcnn.synthetic_images(
        jax.random.PRNGKey(0), 1, CFG_J)["images"], collect_stash=True)[1]
    sites = [s["name"] for s in probe]
    numels = {s["name"]: int(np.asarray(s["tensor"]).size) for s in probe}
    total = sum(numels.values())
    lam = {k: v / total for k, v in numels.items()}
    bc_cfg = jbitchop.BitChopConfig(warmup_steps=BC_WARMUP, max_bits=23)

    @jax.jit
    def step(params, opt, qm_bits, bc_n, key, batch):
        def loss_fn(p, nb):
            act_bits = {"qm": nb, "bitchop": bc_n}.get(mode)
            loss, aux = m.loss(p, batch, act_bits=act_bits, key=key)
            if mode == "qm":
                loss = loss + 2.0 * sum(lam[k] * jnp.clip(nb[k], 0, 23)
                                        for k in sites)
            return loss, aux

        (loss, aux), (gp, gn) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(params, qm_bits)
        params, opt, gnorm = jadamw.update(gp, opt, params, ocfg,
                                           jnp.asarray(1e-2))
        qm_new = {k: jnp.clip(qm_bits[k] - 0.6 * gn[k], 0.0, 23.0)
                  for k in sites}
        return params, opt, qm_new, loss, aux, gnorm

    state = dict(params=params, opt=jadamw.init(params),
                 qm={k: jnp.asarray(qm_bits, jnp.float32) for k in sites},
                 bc=jbitchop.init(bc_cfg))
    return state, step, bc_cfg, lam


def _batch(i, batch):
    b = jcnn.synthetic_images(jax.random.fold_in(jax.random.PRNGKey(1), i),
                              batch, CFG_J)
    return b, {"images": torch.from_numpy(np.array(b["images"]))
               .permute(0, 3, 1, 2),
               "labels": torch.from_numpy(np.asarray(b["labels"])
                                          .astype(np.int64))}


def _run_both(mode, steps, monkeypatch, batch=BATCH, qm_bits=QM_BITS):
    _inject(monkeypatch)
    js, jstep, bc_cfg, lam = _jax_run(mode, qm_bits)
    model = tcnn.CNN(CFG_T, tpolicies.get(mode, container="bit_exact"),
                     device="cpu")
    params = convert.cnn_params_from_jax(jax.tree.map(np.asarray,
                                                      js["params"]))
    ts = tcnn_train.init_state(model, 0, params=params)
    ts = ts._replace(qm_bits={k: torch.tensor(qm_bits, requires_grad=True)
                              for k in ts.qm_bits})
    assert list(ts.lam) == list(lam)
    for k in lam:
        assert ts.lam[k] == lam[k], k
    tstep = tcnn_train.make_step(model, mode, bc_warmup=BC_WARMUP)
    out = []
    for i in range(steps):
        jb, tb = _batch(i, batch)
        (js["params"], js["opt"], js["qm"], jl, jaux, jgn) = jstep(
            js["params"], js["opt"], js["qm"], js["bc"].n,
            jax.random.PRNGKey(i), jb)
        js["bc"] = jbitchop.update(js["bc"], float(jl), bc_cfg)
        ts, met = tstep(ts, tb)
        out.append(dict(jl=float(jl), jxent=float(jaux["xent"]),
                        jgn=float(jgn), jbits=dict(js["qm"]),
                        jn=int(js["bc"].n), met=met,
                        tbits={k: float(v.detach())
                               for k, v in ts.qm_bits.items()}))
    return js, ts, out


def _check_step(r, rtol):
    met = r["met"]
    np.testing.assert_allclose(float(met["loss"]), r["jl"], rtol=rtol)
    np.testing.assert_allclose(float(met["xent"]), r["jxent"], rtol=rtol)
    np.testing.assert_allclose(float(met["grad_norm"]), r["jgn"], rtol=rtol)
    for k, v in r["jbits"].items():
        assert abs(r["tbits"][k] - float(v)) <= 1e-4, k
    assert int(met["bc_bits"]) == r["jn"]


def _check_first_step(js, ts, out):
    _check_step(out[0], 1e-5)
    want_m = [t for _, t in float_leaves(convert.cnn_params_from_jax(
        jax.tree.map(np.asarray, js["opt"].m)))]
    want_p = [t for _, t in float_leaves(convert.cnn_params_from_jax(
        jax.tree.map(np.asarray, js["params"])))]
    lr = tcnn_train.OPT.lr
    for (path, p), m, wm, wp in zip(float_leaves(ts.params),
                                    [t for _, t in float_leaves(ts.opt.m)],
                                    want_m, want_p):
        m, wm, wp = m.numpy(), wm.numpy(), wp.numpy()
        assert np.max(np.abs(m - wm)) <= 1e-5 * np.max(np.abs(wm)), path
        d = np.abs(p.detach().numpy() - wp)
        sure = np.abs(wm) > 1e-7  # |g| > 1e-6
        assert (d[sure] <= 1e-6 + 1e-4 * np.abs(wp[sure])).all(), path
        assert d.max() <= 2 * lr + 1e-6, path
    assert ts.step == 1 and ts.opt.count == 1


@pytest.mark.parametrize("mode", tcnn_train.MODES)
def test_one_step_matches_jax(mode, monkeypatch):
    _check_first_step(*_run_both(mode, 1, monkeypatch))


def test_truncating_qm_step_matches_jax(monkeypatch):
    """One QM step from 2 bits a site, whose forward truncates: batch 2,
    where the two forwards were measured to flip no value (at batch 16
    from 2 bits 513 of s2b0.out's values flipped)."""
    js, ts, out = _run_both("qm", 1, monkeypatch, batch=2, qm_bits=2.0)
    _check_first_step(js, ts, out)
    # At every quantized site the estimator moved the bits beyond the
    # penalty's 2 - 1.2 lam by more than the bits' tolerance (measured
    # 2.9e-4 to 1.1e-2), so the comparison above holds the estimator.
    moved = [abs(v - (2.0 - 1.2 * ts.lam[k]))
             for k, v in out[0]["tbits"].items() if k != "pool"]
    assert min(moved) > 1e-4, moved


@pytest.mark.parametrize("mode", tcnn_train.MODES)
def test_three_steps_match_jax(mode, monkeypatch):
    js, ts, out = _run_both(mode, 3, monkeypatch)
    for r in out:
        _check_step(r, 1e-4)
    if mode == "qm":
        # Step 1 on the bound: half the penalty's gradient, 2 lam / 2.
        for k, v in out[0]["tbits"].items():
            assert abs(v - (23.0 - 0.6 * ts.lam[k])) <= 1e-5, k
        assert all(v < out[0]["tbits"][k] for k, v in
                   out[-1]["tbits"].items())
    if mode == "bitchop":
        assert [r["jn"] for r in out] != [23, 23, 23]  # it decided


def _jax_stash(bits):
    m = jcnn.CNN(CFG_J, jpolicies.get("qm" if isinstance(bits, dict)
                                      else "none"))
    params = m.init(jax.random.PRNGKey(0))
    b = jcnn.synthetic_images(jax.random.PRNGKey(7), 8, CFG_J)
    jbits = ({k: jnp.float32(v) for k, v in bits.items()}
             if isinstance(bits, dict) else None)
    _, stash = m.forward(params, b["images"], act_bits=jbits,
                         key=jax.random.PRNGKey(8), collect_stash=True)
    return stash


SITE_BITS = {"stem": 0.0, "s0b0.a1": 0.0, "s0b0.out": 1.5, "s1b0.a1": 0.0,
             "s1b0.out": 2.25, "s2b0.a1": 1.67, "s2b0.out": 1.7,
             "pool": 6.9}


@pytest.mark.parametrize("case", ["bitchop-9", "qm-per-site",
                                  "qm-per-site-exp5"])
def test_stash_footprint_equals_footprint_for(case):
    """The same numpy stash priced by both: every integer equal, hence
    every ratio."""
    bits = 9.0 if case == "bitchop-9" else SITE_BITS
    exp_bits = 5 if case.endswith("exp5") else None
    stash = _jax_stash(bits)
    want = footprint_for([dict(s, tensor=np.asarray(s["tensor"]))
                          for s in stash], bits, exp_bits=exp_bits)
    got = tcnn_train.stash_footprint(
        [dict(s, tensor=torch.from_numpy(np.array(s["tensor"])))
         for s in stash], bits, exp_bits=exp_bits)
    assert set(got) == set(want)
    for k in ("sfp_bits", "fp32_bits", "bf16_bits"):
        assert got[k] == int(want[k]), k
    for k, v in want.items():
        assert got[k] == float(v), k
    assert got["sfp_bits"] < got["fp32_bits"]


def test_stash_is_nhwc_and_prices_as_the_jax_stash():
    """The port's own stash of the same weights and images (collected in
    channels_last memory, kept as an NHWC view) prices like JAX's: the
    footprint's integers agree within a few Gecko groups' bits."""
    stash = _jax_stash(9.0)
    model = tcnn.CNN(CFG_T, device="cpu")
    jparams = jcnn.CNN(CFG_J).init(jax.random.PRNGKey(0))
    b = jcnn.synthetic_images(jax.random.PRNGKey(7), 8, CFG_J)
    _, ts = model.forward(
        convert.cnn_params_from_jax(jax.tree.map(np.asarray, jparams)),
        torch.from_numpy(np.array(b["images"])).permute(0, 3, 1, 2),
        collect_stash=True)
    for j, t in zip(stash, ts):
        assert t["tensor"].shape == np.asarray(j["tensor"]).shape
        if t["tensor"].dim() == 4:
            assert t["tensor"].is_contiguous()  # NHWC view, no copy
    got = tcnn_train.stash_footprint(ts, 9.0)
    want = footprint_for(stash, 9.0)
    assert got["fp32_bits"] == want["fp32_bits"] == 32 * 8 * 73_792
    assert abs(got["sfp_bits"] - want["sfp_bits"]) <= 1e-4 * want["sfp_bits"]
