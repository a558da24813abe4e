"""The port's serving slice end to end against the JAX package.

Model: gemma2-2b reduced to 4 layers (2 local/global periods), d_model 256,
4 query heads over 2 KV heads of width 192 — GQA, a head_dim that is not
a power of two, and 128-lane groups that straddle heads. The window is
32, so the 40-token prompt wraps the local ring. JAX initialises the
weights; ``repro_torch.convert`` hands them to the port. The JAX side runs
its Pallas kernels in interpret mode (the fused decode path the port
takes); each configuration gets a fresh JAX model.

Tolerances. In f32 the two sides differ by summation order only, so
logits (softcapped to +-30) agree to 2e-3. In bf16 the two frameworks'
matmuls round a few outputs per 10^4 to the neighbouring bf16 value; such
one-ulp differences ride the residual stream through 4 layers and the
256-wide unembedding, measured at ~0.14 at most on the CPU. The logits
themselves leave a bf16 matmul, quantized at 2^-8 relative (0.03 to 0.12
for |logit| in 8..30), so a one-ulp change of the final hidden state moves
many logits by one quantum (measured mean 0.028). bf16 logits are held to
max 0.5 and mean 0.06. Greedy streams must agree up to a first
difference, which may only fall where JAX's top-2 margin is below twice
the logit tolerance.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models.model import DecoderModel as JModel
from repro_torch import configs as tconfigs, convert
from repro_torch.configs.base import reduced as treduced
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.serve import engine

torch.set_num_threads(1)

B, S, NEW = 2, 40, 6
MAX_LEN = S + NEW
TOL = {"float32": dict(max=2e-3, mean=2e-4),
       "bfloat16": dict(max=0.5, mean=0.06)}


def _cfgs(dtype):
    def cut(c, reduced):
        c = reduced(c, n_layers=4, d_model=256)
        return dataclasses.replace(c, n_heads=4, n_kv_heads=2, head_dim=192,
                                   dtype=dtype)
    return (cut(jconfigs.get("gemma2-2b"), jreduced),
            cut(tconfigs.get("gemma2-2b"), treduced))


def _jax_run(jcfg, container):
    """Prefill + greedy stepwise decode of a fresh JAX model."""
    jm = JModel(jcfg, kv_container=container)
    jp = jm.init(jax.random.PRNGKey(0))
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    logits, cache = jax.jit(lambda p, t: jm.prefill(p, t, MAX_LEN))(
        jp, jnp.asarray(prompt))
    out = {"params": jax.tree.map(np.asarray, jp), "prompt": prompt,
           "prefill": np.asarray(logits)[:, -1], "cache": cache}
    if container is None:
        return out
    step = jax.jit(jm.decode_step)
    lg = logits
    toks, step_logits = [], []
    for i in range(NEW):
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        if i == NEW - 1:
            break
        lg, cache = step(jp, cache, tok, jnp.asarray(S + i, jnp.int32))
        step_logits.append(np.asarray(lg)[:, -1])
    out.update(tokens=np.concatenate(toks, 1), steps=step_logits)
    return out


@pytest.fixture(scope="module")
def runs():
    """JAX runs, each configuration once: packed sfp8 in bf16 and f32,
    and a raw-cache bf16 prefill for the cache-byte check."""
    jops.force_backend("interpret")
    try:
        res = {}
        for dtype in ("bfloat16", "float32"):
            jcfg, tcfg = _cfgs(dtype)
            res[dtype] = dict(_jax_run(jcfg, "sfp8"), tcfg=tcfg)
        jcfg, _ = _cfgs("bfloat16")
        res["raw"] = _jax_run(jcfg, None)
        return res
    finally:
        jops.force_backend(None)


def _port(run, container="sfp8"):
    tm = TModel(run["tcfg"], kv_container=container, device="cpu")
    return tm, convert.from_jax(run["params"], tm.cfg)


def _close(got, want, tol):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= tol["max"] and d.mean() <= tol["mean"], \
        (d.max(), d.mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits(runs, dtype):
    run = runs[dtype]
    tm, tp = _port(run)
    logits, _ = tm.prefill(tp, torch.from_numpy(run["prompt"]).long(),
                           MAX_LEN)
    _close(logits[:, -1].numpy(), run["prefill"], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_logits_teacher_forced(runs, dtype):
    """Both models fed JAX's tokens: every step's logits agree."""
    run = runs[dtype]
    tm, tp = _port(run)
    _, cache = tm.prefill(tp, torch.from_numpy(run["prompt"]).long(),
                          MAX_LEN)
    for i, want in enumerate(run["steps"]):
        tok = torch.from_numpy(run["tokens"][:, i:i + 1]).long()
        logits, cache = tm.decode_step(tp, cache, tok, S + i)
        _close(logits[:, -1].numpy(), want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_tokens_by_margin(runs, dtype):
    run = runs[dtype]
    tm, tp = _port(run)
    res = engine.generate(tm, tp, torch.from_numpy(run["prompt"]).long(),
                          NEW)
    got = res.tokens.numpy()
    want = run["tokens"]
    logits = [run["prefill"]] + run["steps"]
    for b in range(B):
        diff = np.nonzero(got[b] != want[b])[0]
        if len(diff):  # the first difference must be at a near tie
            t = diff[0]
            top2 = np.sort(logits[t][b])[-2:]
            assert top2[1] - top2[0] < 2 * TOL[dtype]["max"], \
                (b, t, got[b], want[b])
    assert res.prefill_logits.shape == (B, tm.cfg.padded_vocab)


def test_packed_cache_bytes_after_prefill(runs):
    """Packed bf16 cache bytes equal JAX's in every 128-lane group whose
    bf16 K/V values (from raw-cache prefills) are equal on both sides."""
    run, raw = runs["bfloat16"], runs["raw"]
    tm, tp = _port(run)
    prompt = torch.from_numpy(run["prompt"]).long()
    _, tcache = tm.prefill(tp, prompt, MAX_LEN)
    traw_m, _ = _port(run, container=None)
    _, traw = traw_m.prefill(tp, prompt, MAX_LEN)
    equal_share = []
    for i, kind in enumerate(tm.kinds):
        p, slot = divmod(i, len(tm.cfg.period))
        jpk = run["cache"]["periods"][f"slot{slot}"]
        jrw = raw["cache"]["periods"][f"slot{slot}"]
        for part in ("k", "v"):
            jraw = np.asarray(getattr(jrw, part))[p].astype(np.float32)
            traw_p = getattr(traw["layers"][i], part).float().numpy()
            L = jraw.shape[1]
            same = (jraw.reshape(B, L, -1, 128)
                    == traw_p.reshape(B, L, -1, 128)).all(-1)  # (B, L, G)
            jpt = getattr(jpk, part).data
            tpt = getattr(tcache["layers"][i], part).data
            jpay = np.asarray(jpt["payload"])[p].reshape(B, L, -1, 128)
            tpay = tpt["payload"].numpy().reshape(B, L, -1, 128)
            np.testing.assert_array_equal(tpay[same], jpay[same])
            np.testing.assert_array_equal(tpt["bases"].numpy()[same],
                                          np.asarray(jpt["bases"])[p][same])
            equal_share.append(same.mean())
    # Differences compound with depth; the first layer's K/V come from
    # identical embeddings, so nearly all of its groups must be compared.
    assert min(equal_share[:2]) >= 0.9, equal_share


@pytest.mark.parametrize("kind", ["global", "local"])
def test_attention_route_vs_jax_chunked_route(kind):
    """The port sends every prompt length through ops.attention; at
    S = 1152 > 2 * chunk the JAX package takes its chunked scan instead.
    bf16 in, f32 accumulation on both sides, but the chunked route casts
    the probabilities to bf16 before the p.v product (2^-8 relative), and
    the attention output and its wo product each round to bf16 (2^-8), so
    outputs are held to 2^-5 of their largest magnitude."""
    rng = np.random.default_rng(5)
    jcfg, tcfg = _cfgs("bfloat16")
    jcfg = dataclasses.replace(jcfg, window=200)
    tcfg = dataclasses.replace(tcfg, window=200)
    d, hd, H, KH, S_long = jcfg.d_model, 192, 4, 2, 1152
    w = {n: rng.standard_normal(shape).astype(np.float32) * 0.05
         for n, shape in (("wq", (d, H * hd)), ("wk", (d, KH * hd)),
                          ("wv", (d, KH * hd)), ("wo", (H * hd, d)))}
    h = rng.standard_normal((1, S_long, d)).astype(np.float32)
    jw = {n: jnp.asarray(a, jnp.bfloat16) for n, a in w.items()}
    jh = jnp.asarray(h, jnp.bfloat16)
    want = jattn.attention_train(jw, jh, jcfg, kind=kind,
                                 positions=jnp.arange(S_long))
    tw = {n: convert.to_tensor(np.asarray(a)) for n, a in jw.items()}
    got = tattn.attention_train(tw, convert.to_tensor(np.asarray(jh)), tcfg,
                                kind=kind, positions=torch.arange(S_long))
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=scale * 2 ** -5)
    assert tops._FORCED is None
