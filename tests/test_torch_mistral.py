"""The port's mistral-large-123b against the JAX package, on the CPU, at a
cut that keeps its GQA rep of 12 and its untied head: JAX's reduced config
(2 global layers, vocab 512) with 24 q / 2 KV heads of head dim 64 and
d_model 128, so KH * hd = 128 lanes, one SFP group. (JAX's ``reduced()``
alone would cut mistral to 4 q / 4 KV heads, rep 1.)

The head is ``params["head"]`` (d_model, padded vocab), drawn by JAX and
handed over by ``convert.from_jax``; the port draws its own after every
other leaf, so a tied model's weights from a seed do not change.

Tolerances, as the other parity tests of the port: the f32 forward's
logits, ``loss`` and gradients to 1e-5 of each tensor's largest element
(the loss relative to itself); serving in f32, prefill and teacher-forced
step logits to 2e-3 and the greedy tokens equal; the split-KV mirror in
f32 to 2e-5 (``tests/test_torch_decode_hd16.py``); checkpoints and
conversions bit for bit. The training steps are in
``tests/test_torch_mistral_train.py``.
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
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.base import reduced as jreduced
from repro.data import synthetic as jsyn
from repro.kernels import ref as jref
from repro.models.model import DecoderModel as JModel
from repro.train import step as jstep
from repro_torch import codecs as tcodecs
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import policies as tpolicies
from repro_torch.checkpoint import manager as tmanager
from repro_torch.configs.base import reduced as treduced
from repro_torch.core.stash import float_leaves
from repro_torch.kernels import packed_flash_decode as tpfd
from repro_torch.kernels import ref as tref
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.models.model import RunState
from repro_torch.optim import adamw as tadamw
from repro_torch.serve import engine
from repro_torch.train import step as tstep

torch.set_num_threads(2)

B, S, NEW = 2, 64, 6
PROMPT = 40
HEADS = dict(n_heads=24, n_kv_heads=2, head_dim=64, d_model=128)
REP = 12
F32_TOL = dict(atol=2e-5, rtol=2e-5)


def _cfgs(**extra):
    def cut(c, reduced):
        return dataclasses.replace(reduced(c), dtype="float32", **HEADS,
                                   **extra)
    return (cut(jconfigs.get("mistral-large-123b"), jreduced),
            cut(tconfigs.get("mistral-large-123b"), treduced))


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def test_config_matches_jax():
    j, t = jconfigs.get("mistral-large-123b"), tconfigs.get(
        "mistral-large-123b")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.n_heads // t.n_kv_heads == REP and t.head_dim_ == 128
    assert not t.tie_embeddings and t.period == ("global",)
    assert t.attn_softcap is None and t.final_softcap is None
    assert t.n_periods == 88 and not t.remainder
    jc, tc = _cfgs()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.n_heads // tc.n_kv_heads == REP
    assert tc.n_kv_heads * tc.head_dim_ == tref.GROUP
    assert not tc.tie_embeddings and tc.n_layers == 2


@pytest.fixture(scope="module")
def params():
    jc, tc = _cfgs()
    return JModel(jc).init(jax.random.PRNGKey(0)), jc, tc


def test_from_jax_carries_the_head(params):
    jp, jc, tc = params
    assert jp["head"].shape == (jc.d_model, jc.padded_vocab)
    tp = convert.from_jax(jp, tc)
    np.testing.assert_array_equal(tp["head"].numpy(), np.asarray(jp["head"]))
    fresh = TModel(tc, device="cpu").init(0)
    assert fresh.keys() == tp.keys()
    assert fresh["head"].shape == tp["head"].shape
    assert fresh["head"].dtype == tp["head"].dtype


@pytest.mark.parametrize("arch", ["gemma2-2b", "gemma3-12b",
                                  "mistral-large-123b"])
def test_head_is_drawn_after_every_other_leaf(arch):
    """A tied and an untied model from one seed share every leaf but the
    head bit for bit: the head's draw comes last, so the tied models'
    seeded weights are what they were before the port had a head."""
    cfg = treduced(tconfigs.get(arch))
    tied = TModel(dataclasses.replace(cfg, tie_embeddings=True),
                  device="cpu").init(0)
    untied = TModel(dataclasses.replace(cfg, tie_embeddings=False),
                    device="cpu").init(0)
    assert "head" not in tied and untied["head"].shape == (
        cfg.d_model, cfg.padded_vocab)
    a, b = float_leaves(tied), float_leaves(untied)
    assert [p for p, _ in a] == [p for p, _ in b][:-1]
    assert b[-1][0] == ("head",)
    for (path, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), path


def test_forward_loss_and_gradients_match_jax(params):
    """Logits, the mean cross-entropy and every gradient (the head's
    included) of the f32 forward, policy off, against JAX's."""
    jp, jc, tc = params
    b = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0)).batch(0)
    jm = JModel(jc)
    run = jm.run_state(jax.random.PRNGKey(1))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jl, _ = jax.jit(lambda p, t: jm.forward(p, t, run))(jp, jb["tokens"])

    def jloss(p):
        return jm.loss(p, jb, run)[0]
    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(jp)

    tm = TModel(tc, device="cpu")
    tp = convert.from_jax(jp, tc)
    for t in tadamw.leaves(tp):
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    run_t = RunState(gen=None, pol=None)
    tl, _ = tm.forward(tp, tb["tokens"], run_t)
    assert _rel_to_max(np.asarray(jl)[..., :jc.vocab],
                       tl.detach().numpy()[..., :jc.vocab]) <= 1e-5
    tval, _ = tm.loss(tp, tb, run_t)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    want = convert.from_jax(jax.tree.map(np.asarray, jgrad), tc)
    names = []
    for (path, g), (_, t) in zip(float_leaves(want), float_leaves(tp)):
        names.append(path)
        assert _rel_to_max(g.numpy(), t.grad.numpy()) <= 1e-5, path
    assert ("head",) in names
    assert float(tp["head"].grad.abs().max()) > 0


def _jax_greedy(jm, jp, prompt, max_len):
    logits, cache = jax.jit(lambda p, t: jm.prefill(p, t, max_len))(
        jp, jnp.asarray(prompt))
    step = jax.jit(jm.decode_step)
    lg, toks, steps = logits, [], []
    for i in range(NEW):
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        if i == NEW - 1:
            break
        lg, cache = step(jp, cache, tok, jnp.asarray(PROMPT + i, jnp.int32))
        steps.append(np.asarray(lg)[:, -1])
    return np.asarray(logits)[:, -1], steps, np.concatenate(toks, 1)


@pytest.mark.parametrize("container", ["sfp8", "sfp-m2e4"])
def test_serving_matches_jax(params, container):
    """JAX prefill + stepwise greedy decode over a packed cache against the
    port's prefill, teacher-forced contiguous steps, ``engine.generate``
    and the paged engine (prompts in slots 0 and 2, slot 1 idle on the
    trash block): the same greedy tokens."""
    jp, jc, tc = params
    max_len = PROMPT + NEW
    prompt = np.random.default_rng(2).integers(
        0, jc.vocab, (B, PROMPT)).astype(np.int32)
    jlogits, jsteps, tokens = _jax_greedy(
        JModel(jc, kv_container=container), jp, prompt, max_len)

    tm = TModel(tc, kv_container=container, device="cpu")
    tp = convert.from_jax(jp, tc)
    tprompt = torch.from_numpy(prompt).long()
    tl, tcache = tm.prefill(tp, tprompt, max_len)
    np.testing.assert_allclose(tl[:, -1].numpy(), jlogits, atol=2e-3,
                               rtol=0)
    for i, want in enumerate(jsteps):
        tok = torch.from_numpy(tokens[:, i:i + 1]).long()
        tl, tcache = tm.decode_step(tp, tcache, tok, PROMPT + i)
        np.testing.assert_allclose(tl[:, -1].numpy(), want, atol=2e-3,
                                   rtol=0, err_msg=f"step {i}")
    res = engine.generate(tm, tp, tprompt, NEW)
    np.testing.assert_array_equal(res.tokens.numpy(), tokens)

    eng = engine.PagedEngine(tm, tp, max_slots=3, max_len=max_len)
    slots = {0: 0, 2: 1}
    toks = np.zeros(3, np.int32)
    pos = np.zeros(3, np.int32)
    for slot, row in slots.items():
        assert eng.pool.alloc_upto(slot, max_len)
        toks[slot] = eng.prefill_into_slot(slot, prompt[row])
        pos[slot] = PROMPT
    got = [toks.copy()]
    for _ in range(NEW - 1):
        nxt, bad = eng.decode(toks, pos)
        assert not np.asarray(bad).any()
        toks = np.where(pos > 0, nxt, 0).astype(np.int32)
        pos = np.where(pos > 0, pos + 1, 0).astype(np.int32)
        got.append(toks.copy())
    got = np.stack(got, 1)
    for slot, row in slots.items():
        np.testing.assert_array_equal(got[slot], tokens[row])


# -- the split-KV mirror at rep 12 ----------------------------------------


def _values(rng, shape):
    """Normal values over 2^+-3 with zeros and subnormals (flush words)."""
    x = rng.standard_normal(shape) * np.exp2(rng.integers(-3, 3, shape))
    x[rng.random(shape) < 0.05] = 0.0
    x[rng.random(shape) < 0.03] = 1e-39
    return x.astype(np.float32)


def _pack(x, jf):
    pack = jref.bitplane_pack_nd if jf.dense else jref.sfp_pack_nd
    p, b = pack(jnp.asarray(x), jf)
    return np.asarray(p), np.asarray(b)


def _t(a):
    return torch.from_numpy(np.array(a))


def _draft(jf):
    return max(jf.payload_bits - 1, jf.dexp_bits + 2)


MIRROR_KH, MIRROR_HD = 2, 128   # 24 q heads: rep 12 over two groups


@pytest.mark.parametrize("container", ["sfp8", "sfp-m2e4"])
@pytest.mark.parametrize("draft", [False, True])
@pytest.mark.parametrize("window,L,pos", [(None, 192, [191, 100, 3]),
                                          (96, 128, [300, 127, 200])])
def test_split_decode_rep12(container, draft, window, L, pos):
    """``split_decode_plain`` (the kernel's split recurrence, scores summed
    chunk by chunk with ``chunk_scores``) at rep 12 against the port's
    plain decode and JAX's ``ref.packed_flash_decode``, over a global
    cache and a wrapping ring."""
    jf = jcodecs.fields_for(container, jnp.float32)
    tf = tcodecs.fields_for(container, torch.float32)
    rng = np.random.default_rng(L + len(container))
    H, hd, D = REP * MIRROR_KH, MIRROR_HD, MIRROR_KH * MIRROR_HD
    q = (rng.standard_normal((len(pos), 1, H, hd)) * 3).astype(np.float32)
    k = _pack(_values(rng, (len(pos), L, D)), jf)
    v = _pack(_values(rng, (len(pos), L, D)), jf)
    pp = _draft(jf) if draft else None
    kw = dict(window=window, softcap=None, prefix_planes=pp)
    tin = (torch.from_numpy(q), *map(_t, (*k, *v)),
           torch.tensor(pos, dtype=torch.int32), tf)
    got = tpfd.split_decode_plain(*tin, **kw)
    want = tref.packed_flash_decode(*tin, block_l=tpfd.DEFAULT_BLOCK_L, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    jwant = jref.packed_flash_decode(
        jnp.asarray(q), *map(jnp.asarray, (*k, *v)),
        jnp.asarray(pos, jnp.int32), jf, block_l=tpfd.DEFAULT_BLOCK_L, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **F32_TOL)


@pytest.mark.parametrize("container", ["sfp8", "sfp-m2e4"])
@pytest.mark.parametrize("draft", [False, True])
def test_split_decode_paged_rep12(container, draft):
    """The paged read at rep 12 over a pool with trash-block rows and an
    idle row, against the plain paged read and JAX's."""
    jf = jcodecs.fields_for(container, jnp.float32)
    tf = tcodecs.fields_for(container, torch.float32)
    rng = np.random.default_rng(7)
    bl, n_phys = 64, 6
    H, hd, D = REP * MIRROR_KH, MIRROR_HD, MIRROR_KH * MIRROR_HD
    k = _pack(_values(rng, (n_phys * bl, D)), jf)
    v = _pack(_values(rng, (n_phys * bl, D)), jf)
    pool = [a.reshape(n_phys, bl, -1) for a in (*k, *v)]
    tables = np.array([[1, 4, 2], [5, 0, 0], [0, 0, 0], [3, 2, 0]],
                      np.int32)
    pos = np.array([150, 9, 0, 64], np.int32)
    q = (rng.standard_normal((4, 1, H, hd)) * 3).astype(np.float32)
    pp = _draft(jf) if draft else None
    tin = (torch.from_numpy(q), *map(_t, pool))
    got = tpfd.split_decode_plain(*tin, _t(pos), tf, prefix_planes=pp,
                                  tables=_t(tables))
    want = tref.paged_flash_decode(*tin, _t(tables), _t(pos), tf,
                                   prefix_planes=pp)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    jwant = jref.paged_flash_decode(
        jnp.asarray(q), *map(jnp.asarray, pool), jnp.asarray(tables),
        jnp.asarray(pos), jf, prefix_planes=pp)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **F32_TOL)


def test_chunk_scores_at_rep12():
    """The scores of 12 query heads a KV head as partial products over the
    head's 32-lane chunks equal the whole dot products."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal(
        (2, MIRROR_KH, REP, MIRROR_HD)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal(
        (2, 64, MIRROR_KH, MIRROR_HD)).astype(np.float32))
    want = torch.einsum("bhgd,blhd->bhgl", q, k)
    torch.testing.assert_close(tpfd.chunk_scores(q, k), want, atol=1e-4,
                               rtol=1e-5)


def test_state_from_jax_carries_the_heads_residual(params):
    """With compressed gradients the JAX state's error-feedback residual
    has a head leaf; ``state_from_jax`` hands it over, and the port's own
    ``init_state`` makes one too."""
    jparams, jc, tc = params
    jm = JModel(jc, jpolicies.get("qm", container="sfp8"))
    jtc = jstep.TrainConfig(grad_compress_bits=5)
    js = jstep.init_state(jm, jax.random.PRNGKey(0), jtc)
    rng = np.random.default_rng(4)
    js = js._replace(grad_residual=jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        js.grad_residual))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), tc)
    np.testing.assert_array_equal(ts.grad_residual["head"].numpy(),
                                  np.asarray(js.grad_residual["head"]))
    tm = TModel(tc, tpolicies.get("qm", container="sfp8"), device="cpu")
    own = tstep.init_state(tm, 0, tstep.TrainConfig(grad_compress_bits=5))
    assert own.grad_residual["head"].shape == (jc.d_model, jc.padded_vocab)
    assert own.grad_residual["head"].dtype == torch.float32
    # The checkpoint manager names the head's leaves as JAX does and
    # compresses the parameter (a >= 2-D float leaf without "opt").
    names = tmanager.leaf_names(own)
    for name in (".params['head']", ".opt.m['head']", ".opt.v['head']",
                 ".grad_residual['head']"):
        assert name in names, name


def test_checkpoint_crosses_packages(params, tmp_path):
    """JAX's parameter tree, head included, saved by one package's
    CheckpointManager and restored by the other's, bit for bit, both ways
    (also under ``compress_bits``); the port's restore converts to its
    model's tree."""
    jp, jc, tc = params
    jt = jax.tree.map(jnp.asarray, jp)
    tt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    for sub, kw in (("raw", {}), ("c4", dict(compress_bits=4))):
        JManager(str(tmp_path / sub / "jax"), **kw).save(1, jt)
        tmanager.CheckpointManager(str(tmp_path / sub / "port"),
                                   **kw).save(1, tt)
        zeros_t = jax.tree.map(torch.zeros_like, tt)
        t_of_j = tmanager.CheckpointManager(
            str(tmp_path / sub / "jax")).restore(1, zeros_t)
        j_of_t = JManager(str(tmp_path / sub / "port")).restore(
            1, jax.tree.map(jnp.zeros_like, jt))
        for a, b in zip(jax.tree.leaves(j_of_t), jax.tree.leaves(t_of_j)):
            assert np.asarray(a).tobytes() == b.detach().numpy().tobytes()
        if not kw:
            for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(t_of_j)):
                assert np.asarray(a).tobytes() == b.numpy().tobytes()
        tp = convert.from_jax(jax.tree.map(lambda t: t.numpy(), t_of_j), tc)
        np.testing.assert_array_equal(tp["head"].numpy(),
                                      np.asarray(j_of_t["head"]))
