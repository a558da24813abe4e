"""Prefix-LM attention on the CPU: the first ``prefix_len`` keys visible to
every query (a prefix-LM's conditioning), against the JAX package.

- ``ref.attention(prefix_len=, q_offset=)`` against JAX's
  ``ref.attention``: GQA rep 8 with one KV head (paligemma-3b), rep 1
  (musicgen-large), a window with a prefix, a softcap, a query offset.
- The folded-row plain versions of the kernels, ``flash_attention.plain``
  and ``plain_bwd`` (row r at position r // q_rep), against JAX's
  ``ref.attention`` and ``jax.vjp`` of it.
- ``flash_attention.tile_plan`` with a prefix against brute-force
  enumeration of the visible pairs, at both models' training shapes
  (S_tot 1280, rep 8; S_tot 1088, rep 1) with the kernels' tiles: every
  visible pair lies in exactly one visited tile, every tile that skips the
  mask is visible pair by pair; ``prefix_len`` 0 gives the schedule the
  kernels had before they took a prefix.
- ``plain_tiled`` / ``plain_bwd_tiled`` (the kernels' recurrences on the
  CPU) with a prefix, at the card's tolerances.
- The JAX reference fault: JAX's ``attention_train`` drops the prefix mask
  on its chunked route (S_tot > 1024, prefix_len <= 512); the port's is
  held to JAX's ``ref.attention(prefix_len=)`` there (ROADMAP §C).

Tolerances: f32 outputs and gradients to 1e-5 of each tensor's largest
element (the training parity rule of ROADMAP §C: an output near zero is a
sum that cancels, and dK sums the rep query heads of its group, so their
f32 rounding scales with the largest terms); the tiled mirrors as in
``tests/test_torch_attention_tc.py``.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models.model import DecoderModel as JModel
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import reduced as treduced
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

torch.set_num_threads(2)

OUT_RTOL, OUT_ATOL, GRAD_TOL = 2 ** -7, 1e-3, 2 ** -6
TILES = {"forward": tfa.FWD_TILE, "dkdv": tfa.DKDV_TILE, "dq": tfa.DQ_TILE}


def _within(got, want):
    """Within 1e-5 of the largest element of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def _qkv(seed, B, Sq, Sk, H, KH, hd, scale=2.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Sq, H, hd)) * scale).astype(np.float32)
    k = rng.standard_normal((B, Sk, KH, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KH, hd)).astype(np.float32)
    return q, k, v


# (H, KH, hd, Sq, Sk, window, softcap, prefix_len, q_offset)
REF_CASES = [
    (8, 1, 32, 70, 70, None, None, 13, 0),      # paligemma: rep 8, 1 KV head
    (4, 4, 32, 70, 70, None, None, 64, 0),      # musicgen: rep 1
    (4, 2, 32, 70, 70, 24, None, 13, 0),        # window with a prefix
    (4, 2, 32, 70, 70, None, 30.0, 40, 0),      # softcap with a prefix
    (8, 1, 32, 6, 70, None, None, 13, 64),      # the last 6 rows, offset
    (4, 4, 32, 70, 70, None, None, 100, 0),     # prefix past the sequence
]


@pytest.mark.parametrize("H,KH,hd,Sq,Sk,window,softcap,P,off", REF_CASES)
def test_ref_attention_prefix_matches_jax(H, KH, hd, Sq, Sk, window, softcap,
                                          P, off):
    q, k, v = _qkv(H + Sq + P, 2, Sq, Sk, H, KH, hd)
    kw = dict(causal=True, window=window, softcap=softcap, prefix_len=P,
              q_offset=off)
    want = np.asarray(jref.attention(*map(jnp.asarray, (q, k, v)), **kw))
    got = tref.attention(*map(torch.from_numpy, (q, k, v)), **kw)
    _within(got, want)
    # On the CPU, ops.attention is the plain version, q_offset included.
    _within(ops.attention(*map(torch.from_numpy, (q, k, v)), **kw), want)
    # The prefix changes the function (the rows that could not see the
    # prefix's last keys causally).
    if P and off == 0:
        causal = np.asarray(jref.attention(
            *map(jnp.asarray, (q, k, v)), causal=True, window=window,
            softcap=softcap))
        assert np.abs(causal - want).max() > 1e-3


def _fold(x, KH, rep):
    """(B, S, H, D) -> the kernels' folded (B, S*rep, KH, D) rows."""
    B, S, H, D = x.shape
    return x.reshape(B, S, KH, rep, D).transpose(2, 3).reshape(
        B, S * rep, KH, D)


def _unfold(x, KH, rep):
    B, Sr, _, D = x.shape
    return x.reshape(B, Sr // rep, rep, KH, D).transpose(2, 3).reshape(
        B, Sr // rep, KH * rep, D)


@pytest.mark.parametrize("H,KH,hd,S,window,P", [
    (8, 1, 32, 70, None, 13), (4, 4, 32, 70, None, 40),
    (4, 2, 32, 70, 24, 13)])
def test_folded_plain_and_bwd_match_jax_vjp(H, KH, hd, S, window, P):
    rep = H // KH
    q, k, v = _qkv(7 + P, 2, S, S, H, KH, hd)
    do = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=True, window=window, softcap=None, prefix_len=P)

    def jfn(q_, k_, v_):
        return jref.attention(q_, k_, v_, **kw)
    jo, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    qf, dof = _fold(tq, KH, rep), _fold(tdo, KH, rep)
    o = _unfold(tfa.plain(qf, tk, tv, q_rep=rep, **kw), KH, rep)
    _within(o, jo)
    dq, dk, dv = tfa.plain_bwd(qf, tk, tv, dof, q_rep=rep, **kw)
    for got, want in ((_unfold(dq, KH, rep), jdq), (dk, jdk), (dv, jdv)):
        _within(got, want)


def _tile_sums(vis, bq, bk):
    Sq, Sk = vis.shape
    qt, kt = -(-Sq // bq), -(-Sk // bk)
    pad = np.zeros((qt * bq, kt * bk), dtype=np.int64)
    real = pad.copy()
    pad[:Sq, :Sk] = vis
    real[:Sq, :Sk] = 1
    shape = (qt, bq, kt, bk)
    return pad.reshape(shape).sum((1, 3)), real.reshape(shape).sum((1, 3))


def _old_plan(Sq, Sk, q_rep, window, bq, bk):
    """The causal schedule of the kernels before they took a prefix (the
    tile ranges and open tiles of ``csrc/flash_attention*.cu`` then), to
    hold ``prefix_len`` 0 to it."""
    w = window or 0

    def open_(r0, k0):
        r_hi, k_hi = min(r0 + bq, Sq) - 1, k0 + bk - 1
        if k_hi >= Sk or k_hi > r0 // q_rep:
            return False
        return not (w and k0 <= r_hi // q_rep - w)
    q_keys, q_masked = [], []
    for i in range(-(-Sq // bq)):
        r0 = i * bq
        q_lo, q_hi = r0 // q_rep, (min(r0 + bq, Sq) - 1) // q_rep
        k_begin = max(0, q_lo - w + 1) if w else 0
        keys = tuple(range(k_begin // bk, -(-min(Sk, q_hi + 1) // bk)))
        q_keys.append(keys)
        q_masked.append(frozenset(j for j in keys if not open_(r0, j * bk)))
    k_rows, k_masked = [], []
    for j in range(-(-Sk // bk)):
        k0 = j * bk
        r_end = min(Sq, (k0 + bk - 1 + w) * q_rep) if w else Sq
        rows = tuple(range(k0 * q_rep // bq, -(-r_end // bq)))
        k_rows.append(rows)
        k_masked.append(frozenset(i for i in rows if not open_(i * bq, k0)))
    return tuple(q_keys), tuple(q_masked), tuple(k_rows), tuple(k_masked)


@pytest.mark.parametrize("tile", sorted(TILES))
@pytest.mark.parametrize("S,rep,window,P", [
    (1280, 8, None, 256), (1280, 8, None, 0), (1088, 1, None, 64),
    (1088, 1, None, 0), (1088, 1, None, 1088), (200, 2, 24, 40),
    (129, 1, 24, 70)])
def test_tile_plan_with_prefix_covers_each_visible_pair_once(S, rep, window,
                                                             P, tile):
    Sq, Sk = S * rep, S
    bq, bk = TILES[tile]
    plan = tfa.tile_plan(Sq, Sk, rep, True, window, bq, bk, P)
    vis = tfa.visible_mask(Sq, Sk, rep, True, window, prefix_len=P).numpy()
    seen, real = _tile_sums(vis, bq, bk)
    assert (plan.q_tiles, plan.k_tiles) == seen.shape
    by_q = np.zeros_like(seen)
    for i, keys in enumerate(plan.q_keys):
        assert list(keys) == sorted(set(keys))
        by_q[i, list(keys)] += 1
        assert plan.q_masked[i] <= set(keys)
    by_k = np.zeros_like(seen)
    for j, rows in enumerate(plan.k_rows):
        assert list(rows) == sorted(set(rows))
        by_k[list(rows), j] += 1
        assert plan.k_masked[j] <= set(rows)
    for visited, masked in ((by_q, [(i, j) for i, m in
                                    enumerate(plan.q_masked) for j in m]),
                            (by_k, [(i, j) for j, m in
                                    enumerate(plan.k_masked) for i in m])):
        assert (seen[visited == 0] == 0).all()
        assert int((seen * visited).sum()) == int(vis.sum())
        open_ = visited.astype(bool)
        for i, j in masked:
            open_[i, j] = False
        ii, jj = np.nonzero(open_)
        assert (seen[ii, jj] == real[ii, jj]).all()
        assert ((jj + 1) * bk <= Sk).all()
    if P == 0:
        assert (plan.q_keys, plan.q_masked, plan.k_rows,
                plan.k_masked) == _old_plan(Sq, Sk, rep, window, bq, bk)
        assert plan == tfa.tile_plan(Sq, Sk, rep, True, window, bq, bk)
    elif window is None:
        # Without a window every query tile visits the prefix's tiles, and
        # the tiles wholly inside the prefix skip the mask.
        inside = set(range(min(P, Sk) // bk))
        for i, keys in enumerate(plan.q_keys):
            assert set(range(-(-min(P, Sk) // bk))) <= set(keys)
            assert not plan.q_masked[i] & inside


def _bf16_values(rng, shape, scale=1.0):
    x = torch.from_numpy((rng.standard_normal(shape) * scale)
                         .astype(np.float32))
    return x.to(torch.bfloat16).float()


@pytest.mark.parametrize("hd,S,rep,window,P", [
    (256, 70, 8, None, 33), (64, 129, 1, None, 64), (64, 129, 2, 24, 40)])
def test_plain_tiled_with_prefix(hd, S, rep, window, P):
    """The kernels' tile recurrences with a prefix against the plain
    versions and JAX, at the card's tolerances."""
    rng = np.random.default_rng(hd + S)
    KH = 1
    q = _bf16_values(rng, (1, S * rep, KH, hd), 4.0)
    k, v = (_bf16_values(rng, (1, S, KH, hd)) for _ in range(2))
    do = _bf16_values(rng, (1, S * rep, KH, hd))
    kw = dict(causal=True, window=window, softcap=None, prefix_len=P,
              q_rep=rep)
    o, lse = tfa.plain_tiled(q, k, v, **kw)
    want = tfa.plain(q, k, v, **kw)
    assert bool(((o - want).abs() <= OUT_ATOL + OUT_RTOL * want.abs()).all())
    jwant = jref.attention(jnp.asarray(_unfold(q, KH, rep).numpy()),
                           jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                           causal=True, window=window, prefix_len=P)
    jo = torch.from_numpy(np.array(jwant))
    assert bool(((_unfold(o, KH, rep) - jo).abs()
                 <= OUT_ATOL + OUT_RTOL * jo.abs()).all())
    got = tfa.plain_bwd_tiled(q, k, v, o, do, lse, **kw)
    for a, b in zip(got, tfa.plain_bwd(q, k, v, do, **kw)):
        assert (a - b).abs().max().item() <= GRAD_TOL * b.abs().max().item()


# -- the JAX reference fault on the chunked route ---------------------------

FAULT_P, FAULT_S = 256, 1280


def test_jax_chunked_attention_drops_the_prefix():
    """Reduced paligemma (d 128, 4 q / 1 KV heads of 32), one layer, P 256
    of S_tot 1280. JAX's ``attention_train`` takes its chunked route there
    (S_tot > 2 x 512 and P <= 512): its global branch attends causally
    (``src/repro/models/attention.py``, ``_chunk_attend`` without
    ``prefix_len``), so the prefix rows depart from JAX's own
    ``ref.attention(prefix_len=256)`` and sit on the causal function. At
    S_tot 1024 (the oracle route) JAX equals the prefix function. The port
    computes the prefix function at every length."""
    jc = dataclasses.replace(jreduced(jconfigs.get("paligemma-3b")),
                             dtype="float32")
    tc = dataclasses.replace(treduced(tconfigs.get("paligemma-3b")),
                             dtype="float32")
    assert (jc.n_heads, jc.n_kv_heads, jc.head_dim_) == (4, 1, 32)
    jp = JModel(jc).init(jax.random.PRNGKey(0))
    layer = jax.tree.map(lambda a: a[0], jp["periods"]["slot0"])["attn"]
    tlayer = convert.from_jax(jp, tc)["layers"][0]["attn"]
    rng = np.random.default_rng(3)
    for S_tot, route in ((FAULT_S, "chunked"), (1024, "oracle")):
        h = rng.standard_normal((1, S_tot, jc.d_model)).astype(np.float32)
        pos = jnp.arange(S_tot)
        jout = np.asarray(jax.jit(lambda x: jattn.attention_train(
            layer, x, jc, kind="global", positions=pos,
            prefix_len=FAULT_P))(jnp.asarray(h)))
        q, k, v = jattn._project_qkv(layer, jnp.asarray(h), jc, pos)

        def through_wo(o):
            return np.asarray(o.reshape(1, S_tot, -1) @ layer["wo"])
        want = through_wo(jref.attention(q, k, v, prefix_len=FAULT_P))
        causal = through_wo(jref.attention(q, k, v))
        rows = slice(0, FAULT_P)
        if route == "chunked":
            assert np.abs(jout[:, rows] - want[:, rows]).max() > 0.1
            np.testing.assert_allclose(jout[:, rows], causal[:, rows],
                                       atol=1e-4, rtol=0)
        else:
            np.testing.assert_allclose(jout, want, atol=1e-4, rtol=0)
        tout = tattn.attention_train(
            tlayer, torch.from_numpy(h), tc, kind="global",
            positions=torch.arange(S_tot), prefix_len=FAULT_P)
        np.testing.assert_allclose(tout.numpy(), want, atol=1e-4, rtol=0)
