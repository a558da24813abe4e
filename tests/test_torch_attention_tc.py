"""The tensor-core attention kernels' schedule and numerics on the CPU.

``flash_attention.tile_plan`` is the kernels' tile schedule: which key
tiles each query tile visits (forward and dQ pass), which query tiles each
key tile visits (dK/dV pass), which of them need the mask, and the grids.
It must cover every visible (row, key) pair exactly once, skip only tiles
that are masked pair by pair, and skip the mask only on tiles that are
visible pair by pair.

``plain_tiled`` / ``plain_bwd_tiled`` run the kernels' tile recurrences
with the kernels' roundings: P as three bf16 terms into P V with the row
sum from them, P^T and dS as bf16 in the backward products, delta from
the bf16 O. They are held, from the same bf16-valued inputs made with
numpy from a seed, to the port's f32 ``plain`` / ``plain_bwd`` and to the
JAX package (the Pallas ``flash_attention`` in interpret mode, and
``jax.vjp`` of ``repro.kernels.ref.attention``) at the card's own
tolerances: the output within one bf16 ulp, 2^-7 |ref| + 1e-3, and each
gradient within 2^-6 of its largest element (``chip_smoke.KERNEL_RTOL``
and ``GRAD_TOL`` say why).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)

OUT_RTOL, OUT_ATOL, GRAD_TOL = 2 ** -7, 1e-3, 2 ** -6
TILES = {"forward": tfa.FWD_TILE, "dkdv": tfa.DKDV_TILE, "dq": tfa.DQ_TILE}


def _tile_sums(vis, bq, bk):
    """(visible pairs, real pairs) per (query tile, key tile) of a (Sq, Sk)
    mask, the ragged edges padded with pairs that are neither."""
    Sq, Sk = vis.shape
    qt, kt = -(-Sq // bq), -(-Sk // bk)
    pad = np.zeros((qt * bq, kt * bk), dtype=np.int64)
    real = pad.copy()
    pad[:Sq, :Sk] = vis
    real[:Sq, :Sk] = 1
    shape = (qt, bq, kt, bk)
    return pad.reshape(shape).sum((1, 3)), real.reshape(shape).sum((1, 3))


@pytest.mark.parametrize("tile", sorted(TILES))
@pytest.mark.parametrize("window", [None, 24, 256])
@pytest.mark.parametrize("q_rep", [1, 2])
@pytest.mark.parametrize("S", [70, 129, 1024])
def test_tile_plan_covers_each_visible_pair_once(S, q_rep, window, tile):
    Sq, Sk = S * q_rep, S
    bq, bk = TILES[tile]
    plan = tfa.tile_plan(Sq, Sk, q_rep, True, window, bq, bk)
    vis = tfa.visible_mask(Sq, Sk, q_rep, True, window).numpy()
    seen, real = _tile_sums(vis, bq, bk)
    assert (plan.q_tiles, plan.k_tiles) == seen.shape
    # Visited tiles, from the query side and from the key side.
    by_q = np.zeros_like(seen)
    for i, keys in enumerate(plan.q_keys):
        assert list(keys) == sorted(set(keys))        # each tile once
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
        # Every visible pair lies in exactly one visited tile; a skipped
        # tile holds no visible pair.
        assert (seen[visited == 0] == 0).all()
        assert int((seen * visited).sum()) == int(vis.sum())
        # A tile that skips the mask is visible pair by pair, keys in range.
        open_ = visited.astype(bool)
        for i, j in masked:
            open_[i, j] = False
        ii, jj = np.nonzero(open_)
        assert (seen[ii, jj] == real[ii, jj]).all()
        assert ((jj + 1) * bk <= Sk).all()
    # Grid rows take the query tiles last to first: under a causal mask
    # alone, longest first (a window evens the lengths out).
    assert sorted(plan.q_order) == list(range(plan.q_tiles))
    if window is None:
        counts = [len(plan.q_keys[i]) for i in plan.q_order]
        assert counts == sorted(counts, reverse=True)


def test_tile_plan_training_grid_fills_the_card():
    """gemma2-2b's training attention (B 4, 4 KV heads, S 1024 folded to
    2048 rows): every kernel's grid has at least one CTA per SM (132)."""
    B, KH, S, rep = 4, 4, 1024, 2
    for bq, bk in TILES.values():
        plan = tfa.tile_plan(S * rep, S, rep, True, None, bq, bk)
        assert B * KH * plan.q_tiles >= 132
        assert B * KH * plan.k_tiles >= 132


def _bf16_values(rng, shape, scale=1.0):
    x = torch.from_numpy((rng.standard_normal(shape) * scale)
                         .astype(np.float32))
    return x.to(torch.bfloat16).float()


def _fold(x, KH, rep):
    """(B, S, H, D) -> the kernels' folded (B, S*rep, KH, D) rows."""
    B, S, H, D = x.shape
    return x.reshape(B, S, KH, rep, D).transpose(2, 3).reshape(
        B, S * rep, KH, D)


def _unfold(x, KH, rep):
    B, Sr, _, D = x.shape
    return x.reshape(B, Sr // rep, rep, KH, D).transpose(2, 3).reshape(
        B, Sr // rep, KH * rep, D)


def _assert_out(got, want, what):
    err = (got - want).abs()
    lim = OUT_ATOL + OUT_RTOL * want.abs()
    assert bool((err <= lim).all()), (what, err.max().item())


def _assert_grad(got, want, what):
    err = (got - want).abs().max().item()
    assert err <= GRAD_TOL * want.abs().max().item(), (what, err)


CASES = [(288, 70, None, 50.0), (288, 70, 24, None),
         (64, 129, None, None), (64, 129, 24, 50.0)]


@pytest.mark.parametrize("hd,S,window,softcap", CASES)
def test_plain_tiled_vs_plain_and_jax(hd, S, window, softcap):
    """Folded GQA (q_rep 2), ragged S (no multiple of any tile)."""
    rng = np.random.default_rng(hd + S)
    B, KH, rep = 1, 2, 2
    q = _bf16_values(rng, (B, S * rep, KH, hd), 3.0)
    k = _bf16_values(rng, (B, S, KH, hd))
    v = _bf16_values(rng, (B, S, KH, hd))
    kw = dict(causal=True, window=window, softcap=softcap, q_rep=rep)
    got, lse = tfa.plain_tiled(q, k, v, **kw)
    _assert_out(got, tfa.plain(q, k, v, **kw), "port plain")
    want = jfa.flash_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                               jnp.asarray(v.numpy()), block_q=64,
                               block_k=32, interpret=True, **kw)
    _assert_out(got, torch.from_numpy(np.array(want)), "JAX kernel")
    # The log-sum-exp against the plain logits'.
    scale = 1.0 / hd ** 0.5
    qh, kh = (x.permute(0, 2, 1, 3) for x in (q, k))
    logits = qh @ kh.transpose(-1, -2) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    vis = tfa.visible_mask(S * rep, S, rep, True, window)
    logits = torch.where(vis, logits, -1e30)
    want_lse = torch.logsumexp(logits, -1).reshape(B * KH, S * rep)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("hd,S,window,softcap", CASES)
def test_plain_bwd_tiled_vs_plain_bwd_and_jax_vjp(hd, S, window, softcap):
    rng = np.random.default_rng(2 * hd + S)
    B, KH, rep = 1, 2, 2
    q = _bf16_values(rng, (B, S * rep, KH, hd), 3.0)
    k = _bf16_values(rng, (B, S, KH, hd))
    v = _bf16_values(rng, (B, S, KH, hd))
    do = _bf16_values(rng, (B, S * rep, KH, hd))
    kw = dict(causal=True, window=window, softcap=softcap, q_rep=rep)
    o, lse = tfa.plain_tiled(q, k, v, **kw)
    got = tfa.plain_bwd_tiled(q, k, v, o, do, lse, **kw)
    for name, g, w in zip("qkv", got, tfa.plain_bwd(q, k, v, do, **kw)):
        _assert_grad(g, w, f"d{name} vs port plain_bwd")
    jkw = dict(causal=True, window=window, softcap=softcap)
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, **jkw),
                     *(jnp.asarray(x.numpy())
                       for x in (_unfold(q, KH, rep), k, v)))
    want = [torch.from_numpy(np.array(g)) for g in
            vjp(jnp.asarray(_unfold(do, KH, rep).numpy()))]
    want[0] = _fold(want[0], KH, rep)
    for name, g, w in zip("qkv", got, want):
        _assert_grad(g, w, f"d{name} vs JAX vjp")
