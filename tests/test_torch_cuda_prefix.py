"""The attention kernels with a prefix-LM's prefix (``prefix_len``), and a
prefix-LM's serving and training on the card, against the plain versions.

Marked ``cuda``: each test skips (inside the fixture) where there is no
GPU. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_prefix.py

Tolerances as in ``tests/test_torch_cuda.py``: the forward within one
bf16 ulp of plain (|d| <= 2^-7 |plain| + 1e-3), the backward per tensor
within 2^-6 of its largest element. The prefix keys are visible to every
row, so the inputs are random (zero prefixes would hide the mask).
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models.model import DecoderModel
from repro_torch.serve import engine

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


def _inputs(dev, seed, B, S, KH, hd, rep):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = (torch.randn((B, S * rep, KH, hd), generator=g) * 4).to(
        torch.bfloat16)
    k, v = (torch.randn((B, S, KH, hd), generator=g).to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn((B, S * rep, KH, hd), generator=g).to(torch.bfloat16)
    return tuple(t.to(dev) for t in (q, k, v, do))


def _plain_lse(q, k, rep, window, prefix_len):
    B, Sq, KH, hd = q.shape
    qh, kh = (x.float().permute(0, 2, 1, 3) for x in (q, k))
    logits = qh @ kh.transpose(-1, -2) / hd ** 0.5
    vis = fa.visible_mask(Sq, k.shape[1], rep, True, window, q.device,
                          prefix_len=prefix_len)
    logits = torch.where(vis, logits, ref.NEG_INF)
    return torch.logsumexp(logits, -1).reshape(B * KH, Sq)


@pytest.mark.parametrize("hd,S,rep,window,prefix_len", [
    (64, 70, 1, None, 13), (64, 129, 2, None, 40), (128, 129, 1, None, 200),
    (256, 70, 8, None, 33), (64, 129, 2, 24, 40), (288, 70, 2, 24, 5),
    (144, 129, 1, None, 64), (240, 70, 2, None, 70)])
def test_flash_attention_prefix(dev, hd, S, rep, window, prefix_len):
    """Forward (output and log-sum-exp) and backward with the first
    ``prefix_len`` keys visible to every row, against the plain versions,
    S off every tile, the prefix inside a tile, on a tile edge, past S, and
    with a window (the tiles between prefix and window masked whole)."""
    B, KH = 2, 2 if rep < 8 else 1
    q, k, v, do = _inputs(dev, 21 + hd, B, S, KH, hd, rep)
    kw = dict(causal=True, window=window, softcap=None, q_rep=rep,
              prefix_len=prefix_len)
    o, lse = fa._forward(q, k, v, True, window, None, rep, with_lse=True,
                         prefix_len=prefix_len)
    _close(o, fa.plain(q, k, v, **kw))
    torch.testing.assert_close(lse, _plain_lse(q, k, rep, window,
                                               prefix_len),
                               atol=1e-4, rtol=1e-5)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    for a, b in zip(got, fa.plain_bwd(q, k, v, do, **kw)):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2 ** -6 * b.float().abs().max().item(), err
    # The prefix matters: without it the causal output differs.
    causal = fa._forward(q, k, v, True, window, None, rep, with_lse=False)[0]
    assert not torch.equal(causal, o)


@pytest.mark.parametrize("hd,S,rep,KH,prefix_len", [
    (256, 1280, 8, 1, 256), (64, 1088, 1, 32, 64)])
def test_flash_attention_prefix_lm_shapes(dev, hd, S, rep, KH, prefix_len):
    """paligemma-3b's training attention (one KV head of 256, rep 8, P 256
    of S_tot 1280) and musicgen-large's (32 KV heads of 64, P 64 of S_tot
    1088, off the 128-row tile) at batch 1: within the gates of plain,
    two launches bit-equal."""
    q, k, v, do = _inputs(dev, 5, 1, S, KH, hd, rep)
    kw = dict(causal=True, window=None, softcap=None, q_rep=rep,
              prefix_len=prefix_len)

    def run():
        o, lse = fa._forward(q, k, v, True, None, None, rep, with_lse=True,
                             prefix_len=prefix_len)
        return (o, lse, *fa.flash_attention_bwd(q, k, v, o, do, lse, **kw))

    first, again = run(), run()
    for x, y in zip(first, again):
        assert torch.equal(x, y)
    _close(first[0], fa.plain(q, k, v, **kw))
    for a, b in zip(first[2:], fa.plain_bwd(q, k, v, do, **kw)):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2 ** -6 * b.float().abs().max().item(), err


def test_prefix_zero_is_the_causal_kernel(dev):
    """prefix_len 0 launches the causal schedule: bit-equal to a call
    without the argument."""
    q, k, v, do = _inputs(dev, 9, 2, 129, 2, 128, 2)
    a = fa._forward(q, k, v, True, None, None, 2, with_lse=True)
    b = fa._forward(q, k, v, True, None, None, 2, with_lse=True,
                    prefix_len=0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_ops_attention_refuses_q_offset_on_the_card(dev):
    q, k, v, _ = _inputs(dev, 3, 1, 64, 2, 64, 1)
    with pytest.raises(ValueError, match="q_offset"):
        ops.attention(q, k, v, q_offset=8)


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large"])
def test_prefix_lm_generate_and_step(dev, arch):
    """A reduced prefix-LM (KV heads cut to one 128-lane group of a head
    dim the kernels take: 8 q / 1 KV of 128, 2 / 2 of 64) serves from
    an sfp8 cache with random conditioning embeddings, kernels against the
    plain path (prefill logits close, the same tokens up to a near tie),
    and takes one qm + sfp8 training step with them."""
    from repro_torch.train import step as tstep
    heads = {"paligemma-3b": dict(n_heads=8, n_kv_heads=1, head_dim=128),
             "musicgen-large": dict(n_heads=2, n_kv_heads=2, head_dim=64)}
    cfg = dataclasses.replace(reduced(configs.get(arch)), **heads[arch])
    model = DecoderModel(cfg, kv_container="sfp8", device=dev)
    params = model.init(0)
    g = torch.Generator(device="cpu").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (2, 40), generator=g).to(dev)
    cond = torch.randn((2, cfg.prefix_tokens, cfg.d_model), generator=g).to(
        dev, cfg.compute_dtype)
    res = engine.generate(model, params, prompt, 6, cond_embeddings=cond)
    ops.force_backend("plain")
    try:
        plain = engine.generate(model, params, prompt, 6,
                                cond_embeddings=cond)
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
    state = tstep.init_state(tm, 0, tc)
    _, met = tstep.make_train_step(tm, tc)(
        state, {"tokens": prompt, "labels": prompt, "cond_embeddings": cond})
    assert torch.isfinite(met["loss"])
