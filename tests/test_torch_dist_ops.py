"""The port's distributed pieces on four CPU ranks against the JAX package:
the vocab-sharded embedding lookup, logits and cross-entropy (with their
gradients), ``psum_compressed``, GPipe stages (``pipeline_apply``, with
gradients), the elastic restore of a sharded training state onto another
mesh and onto fewer ranks (read back by JAX's manager too), the batch
placement by batch specs, what a mesh of more than one rank refuses and
builds, the expert-parallel ``all_to_all`` (against a plain gather), and
the reduced gemma2-2b's sharded step with a compressed gradient wire.
One spawn of four ranks (``torch_dist_harness.run_step_cases``) runs every
case of the file; JAX runs here.
"""
import collections

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.models import common as jcommon
from repro.train import grad_compress as jgc
from torch_dist_harness import (COMPRESSED_CASE, WORLD, check_step_case,
                                elastic_restore, exchange, pipeline_stages,
                                placement_and_gates, psum, run_step_cases,
                                vocab_parallel)


def _vocab_inputs():
    rng = np.random.default_rng(0)
    V, D = 64, 16
    return {"table": rng.standard_normal((V, D)).astype(np.float32),
            "head": rng.standard_normal((D, V)).astype(np.float32),
            "tokens": rng.integers(0, V - 24, (8, 5)).astype(np.int32),
            "labels": rng.integers(0, V - 24, (8, 5)).astype(np.int32),
            "dh": rng.standard_normal((8, 5, D)).astype(np.float32),
            "h": rng.standard_normal((8, 5, D)).astype(np.float32)}


def _psum_inputs():
    rng = np.random.default_rng(1)
    return [rng.standard_normal((WORLD, 8, 32)).astype(np.float32),
            (rng.standard_normal((WORLD, 5, 3)) * np.exp(
                rng.uniform(-8, 8, (WORLD, 5, 3)))).astype(np.float32)]


def _pipeline_inputs():
    rng = np.random.default_rng(2)
    S, d = WORLD, 16
    return {"ws": (rng.standard_normal((S, d, d)) * 0.3).astype(np.float32),
            "x": rng.standard_normal((6, 4, d)).astype(np.float32),
            "c": rng.standard_normal((6, 4, d)).astype(np.float32)}


def _exchange_inputs():
    """Per rank, a tensor of blocks to exchange and the cotangent of the
    exchanged one: four blocks over the whole group, two over a model
    group."""
    rng = np.random.default_rng(4)
    return {k: {"world": rng.standard_normal((WORLD, 4 * 3, 5)).astype(
        np.float32), "model": rng.standard_normal((WORLD, 2 * 3, 5)).astype(
            np.float32)} for k in ("x", "c")}


def _batches():
    rng = np.random.default_rng(3)
    return [{"tokens": rng.integers(0, 512, (8, 6)).astype(np.int32),
             "labels": rng.integers(0, 512, (8, 6)).astype(np.int32),
             "cond_embeddings": rng.standard_normal((8, 2, 4)).astype(
                 np.float32)} for _ in range(3)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each job's results, rank by rank, from the file's one spawn (which
    runs the compressed step case first); ``dir`` holds its files."""
    d = tmp_path_factory.mktemp("dist_ops")
    jobs = {"vocab": (vocab_parallel, (_vocab_inputs(),)),
            "psum": (psum, ({"grads": _psum_inputs(), "bits": 3},)),
            "pipeline": (pipeline_stages, (_pipeline_inputs(),)),
            "elastic": (elastic_restore, (str(d / "ckpt"),)),
            "placement": (placement_and_gates, ({"batches": _batches()},)),
            "exchange": (exchange, (_exchange_inputs(),))}
    out = run_step_cases([COMPRESSED_CASE], d, jobs.values())
    return dict({name: [r[i] for r in out] for i, name in enumerate(jobs)},
                dir=d)


def test_vocab_parallel_embed_logits_and_xent(ranks):
    """On a (2, 2) mesh each rank looks up its rows in its vocab shard
    (bit-equal to JAX's ``common.embed``, the table's gradient summed over
    the data ranks equal to the plain gather's), and its rows' logits are
    JAX's ``unembed`` (tied and untied, softcap 30, the last 24 of the
    vocab padded) on its vocab shard, with JAX's ``softmax_xent`` over its
    rows and ``jax.grad`` of it (f32 rounding: 1e-6 of the largest)."""
    inputs = _vocab_inputs()
    V, D = inputs["table"].shape
    params = {"embed": {"table": jnp.asarray(inputs["table"])},
              "head": jnp.asarray(inputs["head"])}
    emb = np.asarray(jcommon.embed(params["embed"],
                                   jnp.asarray(inputs["tokens"]), 2.0))
    g_table = np.zeros((V, D), np.float32)
    np.add.at(g_table, inputs["tokens"], 2.0 * inputs["dh"])
    for rank, out in enumerate(ranks["vocab"]):
        d, m = divmod(rank, 2)
        rows, cols = slice(d * 4, (d + 1) * 4), slice(m * 32, (m + 1) * 32)
        np.testing.assert_array_equal(out["embed"], emb[rows])
        np.testing.assert_allclose(out["g_table"], g_table[cols],
                                   rtol=1e-6, atol=1e-6)
        for tied in (True, False):
            def loss(p, h):
                logits = jcommon.unembed(p, h, tied=tied, softcap=30.0,
                                         valid_vocab=V - 24)
                return jcommon.softmax_xent(
                    logits, jnp.asarray(inputs["labels"][rows])), logits
            h = jnp.asarray(inputs["h"][rows])
            (xent, logits), (gp, gh) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(params, h)
            gw = np.asarray(gp["embed"]["table"])[cols] if tied else \
                np.asarray(gp["head"])[:, cols]
            got = out[tied]
            np.testing.assert_allclose(got["logits"],
                                       np.asarray(logits)[..., cols],
                                       rtol=1e-6, atol=1e-5)
            np.testing.assert_allclose(got["xent"], float(xent), rtol=1e-6)
            for a, b in ((got["gx"], np.asarray(gh)), (got["gw"], gw)):
                assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


def test_psum_compressed_matches_jax(ranks):
    """Four ranks, 3-bit bit_exact wire, two round trips, against JAX's
    ``psum_compressed`` over a named axis of four (``jax.vmap`` with
    ``axis_name``; its ``psum`` is the same collective): each rank's new
    residual bit-equal to JAX's; the mean the same bits on every rank, and
    within JAX's by the rounding of a bf16 sum in another order (each of
    the two sums within (n - 1) bf16 unit roundoffs of the sum of the
    payloads' magnitudes, so the means within 2 (n - 1) / n of that); and
    close to the exact mean (JAX's cosine check)."""
    grads, ranks = _psum_inputs(), ranks["psum"]
    jpsum = jax.vmap(lambda g, r: jgc.psum_compressed(g, r, 3, "ranks"),
                     axis_name="ranks")
    res = [jnp.zeros(g.shape, jnp.float32) for g in grads]
    for step in range(2):
        scale = 1.0 if step == 0 else 0.5
        g_in = [jnp.asarray(g * scale) for g in grads]
        # The payloads JAX's psum sums: the round trips of this step.
        q, _ = jax.vmap(lambda g, r: jgc.compress_grads(g, r, 3))(g_in, res)
        want, res = jpsum(g_in, res)
        for j in range(len(grads)):
            payload = np.abs(np.asarray(q[j].astype(jnp.bfloat16).astype(
                jnp.float32))).sum(axis=0)
            tol = 2 * (WORLD - 1) / WORLD * 2.0 ** -8 * payload
            w = np.asarray(want[j][0])
            for r in range(WORLD):
                np.testing.assert_array_equal(ranks[r][step][1][j],
                                              np.asarray(res[j][r]))
                got = ranks[r][step][0][j]
                np.testing.assert_array_equal(got, ranks[0][step][0][j])
                assert np.all(np.abs(got - w) <= tol), (step, j)
        exact = np.mean(grads[0], axis=0)
        got = ranks[0][0][0][0]
        cos = float(np.sum(got * exact)
                    / (np.linalg.norm(got) * np.linalg.norm(exact)))
        assert cos > 0.97, cos


def test_pipeline_apply_matches_sequential_stages(ranks):
    """Four stages, 6 microbatches (9 ticks): every rank's outputs equal
    JAX's sequential stages (atol 1e-5, as JAX's own check); the gradients
    of sum(out * c) equal autograd through the sequential stages, each
    rank's for its stage weight, and x's on every rank."""
    import torch
    inputs = _pipeline_inputs()
    ws, x, c = inputs["ws"], inputs["x"], inputs["c"]
    S = WORLD
    want = jnp.asarray(x)
    for s in range(S):
        want = jax.vmap(lambda mb: jnp.tanh(mb @ ws[s]))(want)
    tw = torch.from_numpy(ws).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    h = tx
    for s in range(S):
        h = torch.tanh(h @ tw[s])
    gw, gx = torch.autograd.grad((h * torch.from_numpy(c)).sum(), [tw, tx])
    for rank, out in enumerate(ranks["pipeline"]):
        np.testing.assert_allclose(out["out"], np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(out["gw"], gw[rank].numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out["gx"], gx.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_elastic_restore_onto_another_mesh(ranks):
    """A sharded qm state (parameters, moments, 4-bit wire residual) saved
    from a (2, 2) tp mesh restores bit for bit onto a (4, 1) fsdp mesh, in
    the new model's placements, and onto the 2-rank sub-mesh of
    ``plan_remesh(2, ...)``; JAX's ``CheckpointManager.restore`` reads the
    same parameters from the port's files."""
    ckpt = ranks["dir"] / "ckpt"
    out = ranks["elastic"][0]
    saved = out["saved"]
    got, want = out["fsdp_placements"]
    assert got == want
    assert out["sub_shape"] == (1, 2)
    for what in ("fsdp", "sub"):
        assert out[what].keys() == saved.keys()
        for name, a in out[what].items():
            np.testing.assert_array_equal(a, saved[name], err_msg=name)
    like = collections.namedtuple("S", ["params"])(params=_params_like())
    back = JManager(str(ckpt)).restore(3, like)
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert len(flat) == sum(n.startswith(".params") for n in saved)
    for path, a in flat:
        name = jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(a), saved[name],
                                      err_msg=name)


def _params_like():
    """Zeros shaped as the saved parameters (the reduced gemma2-2b's), in
    the port's structure, whose keystr names the port's leaves."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.models.model import META, DecoderModel
    cfg = dataclasses.replace(reduced(configs.get("gemma2-2b"), n_layers=4),
                              dtype="float32")
    meta = DecoderModel(cfg, device="cpu")._draw(None, META)

    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        if isinstance(t, list):
            return [zeros(v) for v in t]
        return np.zeros(tuple(t.shape), np.float32)
    return zeros(meta)


def test_batch_placement_and_what_a_mesh_refuses(ranks):
    """``prefetch`` with the batch specs: in the tp layout each rank holds
    its data rank's rows (the same on both model ranks), in fsdp its own
    quarter; every shard gathers back to the batch, tokens as int64. Under
    a (2, 2) mesh the paged engine raises ``NotYetPorted`` (pointing at
    ROADMAP), the reduced gemma2-2b's ``prefill`` and ``decode_step`` run
    and give the whole batch's logits, and the reduced MoE, SSD and
    RG-LRU models build in both layouts."""
    batches = _batches()
    for out in ranks["placement"]:
        d, m = out["coord"]
        for layout, lo, n in (("tp", d * 4, 4), ("fsdp", (2 * d + m) * 2,
                                                  2)):
            for b, placed in zip(batches, out[layout]):
                for k, (loc, full, dtype) in placed.items():
                    np.testing.assert_array_equal(loc, b[k][lo:lo + n])
                    np.testing.assert_array_equal(full, b[k])
                    assert dtype == ("torch.float32" if k == "cond_embeddings"
                                     else "torch.int64")
        refused = out["refused"]
        assert sorted(refused) == ["PagedEngine"]
        assert all("ROADMAP" in v for v in refused.values())
        assert out["served"] == ((2, 1, 512), (2, 1, 512))
        assert out["built"] == [(name, layout) for name in (
            "olmoe-1b-7b", "mamba2-370m", "recurrentgemma-9b")
            for layout in ("tp", "fsdp")]


def test_all_to_all_exchange_and_its_gradient(ranks):
    """``sharding.all_to_all`` against a plain gather on CPU ranks: over
    the whole group and over each (2, 2) mesh's model group (ranks r and
    r ^ 1), rank r receives block r of every member's tensor in rank
    order, and the gradient of sum(out * c) for its tensor is block r of
    every member's c (the inverse exchange)."""
    inputs = _exchange_inputs()
    for what, members in (("world", lambda r: list(range(WORLD))),
                          ("model", lambda r: [r & ~1, r | 1])):
        x, c = inputs["x"][what], inputs["c"][what]
        for r, out in enumerate(ranks["exchange"]):
            group = members(r)
            me = group.index(r)
            blocks = lambda t: np.split(t, len(group))[me]
            y = np.concatenate([blocks(x[m]) for m in group])
            g = np.concatenate([blocks(c[m]) for m in group])
            np.testing.assert_array_equal(out[what]["y"], y)
            np.testing.assert_array_equal(out[what]["g"], g)


def test_sharded_step_with_compressed_gradients(ranks, tmp_path_factory):
    """A 4-bit bit_exact wire (``grad_compress_bits=4``) under qm + sfp8 on
    a (2, 2) tp mesh, against JAX's one-device step (as
    ``tests/test_torch_dist_step_gemma.py``): each rank round-trips its
    gradient shards against its residual shards."""
    check_step_case(*COMPRESSED_CASE[:2], "tp", tmp_path_factory,
                    grad_compress_bits=4)
