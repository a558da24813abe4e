"""The port's checkpoint manager (``repro_torch.checkpoint``) and the codec
host streams it writes, against the JAX package's.

Format parity in both directions: the same tree (an f32 (8, 16), a bf16
(4, 64), an int32 (10) and a bf16 (4) leaf, nested in dicts and a list),
saved from the same numpy inputs by both managers, raw and under
``compress_bits=4``, ``bit_exact`` with bits 3, ``gecko8`` and ``sfp8``
with bits, gives equal manifests (less ``time``) and byte-equal ``.npy``
files, and each package restores the other's checkpoint bit for bit.
Then JAX's own manager tests (``tests/test_checkpoint.py``) on the port,
the leaf names against ``jax.tree_util.keystr``, a ``TrainState`` round
trip after three steps, and the ``validate_name`` repair.
"""
import json
import os
import threading
import time
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import codecs as jcodecs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import containers as jcontainers
from repro_torch import codecs as tcodecs
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager, leaf_names
from repro_torch.configs.base import reduced
from repro_torch.core import containers as tcontainers
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import DecoderModel
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

torch.set_num_threads(2)

STEP_DIR = "step_00000001"


def _bf16(a: np.ndarray) -> torch.Tensor:
    """An ml_dtypes bf16 array as a torch tensor with the same bits."""
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy (bf16 through ml_dtypes, the same bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((8, 16)).astype(np.float32),
            "b": (rng.standard_normal((4, 64)) * 3).astype(
                ml_dtypes.bfloat16),
            "c": np.arange(10, dtype=np.int32),
            "d": rng.standard_normal((4,)).astype(ml_dtypes.bfloat16)}


def _trees(seed=0):
    x = _inputs(seed)
    jt = {"a": jnp.asarray(x["a"]),
          "nested": {"c": jnp.asarray(x["c"]),
                     "lst": [jnp.asarray(x["b"]), jnp.asarray(x["d"])]}}
    tt = {"a": torch.from_numpy(x["a"]),
          "nested": {"c": torch.from_numpy(x["c"]),
                     "lst": [_bf16(x["b"]), _bf16(x["d"])]}}
    return jt, tt


def _manifest(path):
    m = json.loads((path / "manifest.json").read_text())
    m.pop("time")
    return m


def _same_bits(j, t) -> bool:
    a = np.asarray(j)
    b = _np(t.detach())
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.view(np.uint8).tobytes() == b.view(np.uint8).tobytes())


CASES = {"raw": {}, "compress_bits=4": dict(compress_bits=4),
         "bit_exact bits 3": dict(compress_codec="bit_exact",
                                  compress_bits=3),
         "gecko8": dict(compress_codec="gecko8"),
         "sfp8 bits 3": dict(compress_codec="sfp8", compress_bits=3)}


@pytest.mark.parametrize("case", list(CASES))
def test_format_parity_both_directions(tmp_path, case):
    kw = CASES[case]
    jt, tt = _trees()
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    JManager(str(jdir), **kw).save(1, jt, extra={"policy": "qm"})
    CheckpointManager(str(tdir), **kw).save(1, tt, extra={"policy": "qm"})
    assert _manifest(tdir / STEP_DIR) == _manifest(jdir / STEP_DIR)
    files = sorted(p.name for p in (jdir / STEP_DIR).glob("*.npy"))
    assert files == sorted(p.name for p in (tdir / STEP_DIR).glob("*.npy"))
    assert len(files) == 4
    for f in files:
        assert ((jdir / STEP_DIR / f).read_bytes()
                == (tdir / STEP_DIR / f).read_bytes()), f
    # Each package restores the other's checkpoint, and its own, alike.
    j_of_t = JManager(str(tdir), **kw).restore(1, jt)
    j_of_j = JManager(str(jdir), **kw).restore(1, jt)
    t_of_j = CheckpointManager(str(jdir), **kw).restore(1, tt)
    jl = jax.tree.leaves(j_of_j)
    for got in (jax.tree.leaves(j_of_t),):
        assert all(np.asarray(a).tobytes() == np.asarray(b).tobytes()
                   for a, b in zip(got, jl))
    tl = jax.tree.leaves(t_of_j, is_leaf=lambda x: isinstance(
        x, torch.Tensor))
    assert [t.dtype for t in tl] == [torch.float32, torch.int32,
                                     torch.bfloat16, torch.bfloat16]
    assert all(_same_bits(j, t) for j, t in zip(jl, tl))
    if not kw:   # raw: both restore the inputs themselves
        assert all(_same_bits(j, t) for j, t in zip(jax.tree.leaves(jt),
                                                     tl))


@pytest.mark.parametrize("case", list(CASES))
def test_compression_matches_jax_codec_by_codec(tmp_path, case):
    """Which leaves are coded, and with which meta, follows JAX's rule:
    float leaves of rank >= 2, bits asked for or the codec lossless."""
    kw = CASES[case]
    _, tt = _trees(1)
    CheckpointManager(str(tmp_path), **kw).save(1, tt)
    coded = {e["name"]: e.get("codec") for e in
             _manifest(tmp_path / STEP_DIR)["leaves"]}
    expect = {"raw": {}, "compress_bits=4": {"['a']": "bit_exact"},
              "bit_exact bits 3": {"['a']": "bit_exact",
                                   "['nested']['lst'][0]": "bit_exact"},
              "gecko8": {"['nested']['lst'][0]": "gecko8"},
              "sfp8 bits 3": {"['a']": "sfp8",
                              "['nested']['lst'][0]": "sfp8"}}[case]
    assert {k: v for k, v in coded.items() if v} == expect


# -- JAX's manager tests (tests/test_checkpoint.py), on the port ------------


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": torch.ones((4,), dtype=torch.bfloat16)}}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _leaves(tree):
    return [t for _, t in sorted(_flat(tree))]


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    else:
        yield path, tree


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(3, t)
    back = mgr.restore(3, _zeros_like(t))
    for a, b in zip(_leaves(t), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


@pytest.mark.parametrize("codec", [None, "gecko8"])
def test_async_save_snapshots_before_returning(tmp_path, monkeypatch,
                                               codec):
    """The caller may update the tree in place as soon as save returns (the
    port's AdamW does): the checkpoint holds the values at the call, even
    when the writer starts only after the update."""
    gate = threading.Event()
    write = CheckpointManager._write

    def gated_write(self, *args):
        gate.wait(30)
        write(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write", gated_write)
    mgr = CheckpointManager(str(tmp_path), compress_codec=codec)
    t = {"w": torch.randn(64, 128).to(torch.bfloat16),
         "v": torch.randn(32, 16), "n": np.arange(4)}
    before = {k: v.clone() if isinstance(v, torch.Tensor) else v.copy()
              for k, v in t.items()}
    mgr.save(1, t, blocking=False)
    t["w"].add_(1.0)
    t["v"].add_(1.0)
    t["n"] += 1
    gate.set()
    mgr.wait()
    back = mgr.restore(1, t)
    for k in ("w", "v"):
        assert torch.equal(back[k], before[k]), k
    np.testing.assert_array_equal(back["n"], before["n"])


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(2))
    assert mgr.all_steps() == [3, 4]


def test_atomic_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, _tree(3))
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000007"]


def test_resave_swaps_the_old_step_out(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"a": torch.zeros(3)})
    mgr.save(2, {"a": torch.ones(3)})
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000002"]
    assert torch.equal(mgr.restore(2, {"a": torch.zeros(3)})["a"],
                       torch.ones(3))


def test_gc_reaps_only_stale_tmp_dirs(tmp_path):
    stale = tmp_path / "step_00000001.tmp-deadbeef"
    fresh = tmp_path / "step_00000002.tmp-cafecafe"
    stale.mkdir()
    fresh.mkdir()
    old = time.time() - 301
    os.utime(stale, (old, old))
    CheckpointManager(str(tmp_path)).save(3, {"a": torch.zeros(2)})
    assert not stale.exists() and fresh.exists()
    assert CheckpointManager(str(tmp_path)).all_steps() == [3]


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros((4,))})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"a": torch.zeros((5,))})


def test_restore_missing_leaf_names_the_saved_run(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(2)}, extra={"policy": "qm"})
    with pytest.raises(ValueError, match="lacks leaves.*'policy': 'qm'"):
        mgr.restore(1, {"a": torch.zeros(2), "b": torch.zeros(2)})


def test_restore_onto_shardings_is_not_ported(tmp_path):
    """``restore(shardings=)`` raised NotImplementedError until the
    distributed slice ported it: a None sharding keeps the leaf as
    ``like``'s, a ``Sharding`` makes it a DTensor of this rank's shard
    (here on a gloo world of one; multi-rank restores are
    ``tests/test_torch_dist_ops.py``'s)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed import sharding as shd
    mgr = CheckpointManager(str(tmp_path))
    a = torch.arange(4, dtype=torch.float32)
    mgr.save(1, {"a": a})
    back = mgr.restore(1, {"a": torch.zeros(4)}, shardings={"a": None})
    assert type(back["a"]) is torch.Tensor and torch.equal(back["a"], a)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        sh = shd.Sharding(mesh, (shd.Shard(0), shd.Replicate()))
        back = mgr.restore(1, {"a": torch.zeros(4)}, shardings={"a": sh})
        assert isinstance(back["a"], shd.DTensor)
        assert tuple(back["a"].placements) == sh.placements
        assert torch.equal(shd.full(back["a"]), a)
    finally:
        dist.destroy_process_group()


def test_compressed_checkpoint_truncates_mantissas(tmp_path):
    mgr = CheckpointManager(str(tmp_path), compress_bits=4)
    w = torch.randn((32, 32), generator=torch.Generator().manual_seed(0))
    mgr.save(1, {"w": w})
    back = mgr.restore(1, {"w": w})["w"]
    assert torch.equal(back, tcontainers.truncate_mantissa(w, 4))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcontainers.truncate_mantissa(
            jnp.asarray(w.numpy()), 4)))
    err = float((back - w).abs().max())
    assert 0 < err < 0.25


def test_legacy_compress_bits_leaves_bf16_raw(tmp_path):
    g = torch.Generator().manual_seed(0)
    mgr = CheckpointManager(str(tmp_path), compress_bits=4)
    t = {"wb": torch.randn((32, 128), generator=g).to(torch.bfloat16),
         "wf": torch.randn((32, 32), generator=g)}
    mgr.save(1, t)
    back = mgr.restore(1, t)
    assert torch.equal(back["wb"].view(torch.int16), t["wb"].view(torch.int16))
    assert float((back["wf"] - t["wf"]).abs().max()) > 0  # f32 truncated


def test_gecko8_checkpoint_lossless_bf16_and_never_silently_lossy(tmp_path):
    g = torch.Generator().manual_seed(0)
    mgr = CheckpointManager(str(tmp_path), compress_codec="gecko8")
    t = {"wb": torch.randn((64, 128), generator=g).to(torch.bfloat16),
         "wf": torch.randn((32, 32), generator=g)}
    mgr.save(1, t)
    back = mgr.restore(1, t)
    assert torch.equal(back["wb"].view(torch.int16), t["wb"].view(torch.int16))
    assert torch.equal(back["wf"], t["wf"])
    by_name = {e["name"]: e for e in _manifest(tmp_path / STEP_DIR)["leaves"]}
    assert by_name["['wb']"]["codec"] == "gecko8"
    assert "codec" not in by_name["['wf']"]


def test_optimizer_leaves_are_never_compressed(tmp_path):
    t = {"params": {"w": torch.randn(16, 32)},
         "opt": {"m": torch.randn(16, 32)}}
    CheckpointManager(str(tmp_path), compress_bits=3).save(1, t)
    coded = {e["name"]: e.get("codec") for e in
             _manifest(tmp_path / STEP_DIR)["leaves"]}
    assert coded == {"['opt']['m']": None, "['params']['w']": "bit_exact"}


# -- leaf names, ints, generators, devices ----------------------------------


def _tiny_model(policy="qm"):
    args = tlaunch.build_parser().parse_args(
        ["--arch", "gemma2-2b", "--preset", "tiny", "--policy", policy,
         "--container", "sfp8", "--steps", "3", "--device", "cpu"])
    return tlaunch.build(args)


def test_leaf_names_are_jax_keystr():
    """The port's TrainState (a NamedTuple of dicts, lists, ints, tensors
    and a generator) is named as jax.tree_util names the same structure:
    the AdamW moments under ``.opt``, so the no-"opt" rule skips them."""
    _, model, tc, _, _ = _tiny_model("qm+bitchop")
    state = tstep.init_state(model, 0, tc)
    jnames = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(state)[0]]
    names = leaf_names(state)
    assert names == jnames
    assert ".params['layers'][0]['attn']['wq']" in names
    assert ".opt.m['layers'][0]['attn']['wq']" in names
    assert ".pstate.learn['qm']['act']" in names
    assert names[-2:] == [".step", ".gen"]
    nested = {"b": [1, None, (2, {"z": 3, "a": 4})], "a": None}
    assert leaf_names(nested) == [
        jax.tree_util.keystr(p) for p, _ in
        jax.tree_util.tree_flatten_with_path(nested)[0]]


def test_train_state_roundtrip_after_three_steps(tmp_path):
    """init_state and three steps, saved and restored into a fresh state:
    every leaf, the generator's state and requires_grad come back."""
    cfg, model, tc, batch, seq = _tiny_model()
    step_fn = tstep.make_train_step(model, tc)
    state = tstep.init_state(model, 0, tc)
    from repro_torch.data import synthetic
    dcfg = synthetic.SyntheticConfig(vocab=cfg.vocab, seq_len=seq,
                                     global_batch=batch, seed=0)
    for _, b in zip(range(3), synthetic.batches(dcfg, 0)):
        state, _ = step_fn(state, {k: torch.from_numpy(v).long()
                                   for k, v in b.items()})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, state, blocking=False)
    mgr.wait()
    fresh = tstep.init_state(model, 1, tc)
    back = mgr.restore(3, fresh)
    assert back.step == 3 and isinstance(back.step, int)
    assert back.opt.count == 3 and isinstance(back.opt.count, int)
    assert torch.equal(back.gen.get_state(), state.gen.get_state())
    assert back.gen is not state.gen
    for (name, a), (_, b) in zip(_named(back), _named(state)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
            assert a.requires_grad == b.requires_grad, name
    # the generator continues the same stream
    assert torch.equal(torch.rand(4, generator=back.gen),
                       torch.rand(4, generator=state.gen))
    assert any(p.requires_grad for _, p in _named(back.params))
    assert all(p.requires_grad for p in adamw.leaves(back.params))
    assert all(t.requires_grad for t in back.pstate.learn.values())


def _named(tree):
    from repro_torch.checkpoint import named_leaves
    return named_leaves(tree)


def test_ints_and_generators_restore_as_such(tmp_path):
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"n": 7, "g": gen, "x": None})
    manifest = _manifest(tmp_path / STEP_DIR)
    assert [(e["name"], e["dtype"], e["shape"]) for e in manifest["leaves"]] \
        == [("['g']", "uint8", [int(gen.get_state().numel())]),
            ("['n']", "int64", [])]
    back = mgr.restore(1, {"n": 0, "g": torch.Generator(), "x": None})
    assert back["n"] == 7 and isinstance(back["n"], int)
    assert back["x"] is None
    assert torch.equal(back["g"].get_state(), gen.get_state())


def test_restore_places_leaves_on_likes_device_and_dtype(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3)})
    back = mgr.restore(1, {"a": torch.zeros((2, 3), dtype=torch.float64)})
    assert back["a"].dtype == torch.float64
    assert back["a"].tolist() == [[0, 1, 2], [3, 4, 5]]


def test_restore_of_cuda_leaves_needs_a_gpu(tmp_path, monkeypatch):
    """A leaf the caller wants on CUDA is placed there or the restore
    raises: it never lands on the CPU unasked."""
    mgr = CheckpointManager(str(tmp_path), compress_codec="gecko8")
    w = torch.randn(16, 64).to(torch.bfloat16)
    mgr.save(1, {"w": w})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cuda_like = types.SimpleNamespace(shape=(16, 64), dtype=torch.bfloat16,
                                      device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        mgr.restore(1, {"w": cuda_like})
    assert torch.equal(mgr.restore(1, {"w": w})["w"], w)


# -- the codec base: roundtrip, lossless_for, host streams ------------------


@pytest.mark.parametrize("name", ["sfp8", "sfp16", "bit_exact", "gecko8",
                                  "sfp-m2e4", "sfp8-m2e4"])
def test_codec_roundtrip_and_lossless_for_match_jax(name):
    x = np.random.default_rng(0).standard_normal((8, 256)).astype(
        np.float32) * 5
    jc, tc = jcodecs.get(name), tcodecs.get(name)
    for dt_np, dt_t in ((np.float32, torch.float32),
                        (ml_dtypes.bfloat16, torch.bfloat16)):
        xj = jnp.asarray(x.astype(dt_np))
        xt = torch.from_numpy(x) if dt_t == torch.float32 else _bf16(
            x.astype(dt_np))
        assert tc.lossless_for(dt_t) == jc.lossless_for(jnp.dtype(dt_np))
        for bits in (None, 2):
            assert _same_bits(jc.roundtrip(xj, bits), tc.roundtrip(xt, bits))


@pytest.mark.parametrize("name", ["sfp8", "sfp16", "bit_exact", "gecko8",
                                  "sfp-m3e5"])
def test_encode_host_is_jaxs_stream(name):
    x = (np.random.default_rng(1).standard_normal((4, 160)) * 2).astype(
        ml_dtypes.bfloat16)
    for bits in (None, 3):
        js, jm = jcodecs.get(name).encode_host(x, bits)
        ts, tm = tcodecs.get(name).encode_host(_bf16(x), bits)
        assert ts.dtype == np.uint8 and js.tobytes() == ts.tobytes()
        assert json.loads(json.dumps(tm)) == json.loads(json.dumps(jm))
        back = tcodecs.get(name).decode_host(ts, tm, (4, 160),
                                             torch.bfloat16)
        jback = jcodecs.get(name).decode_host(js, jm, (4, 160),
                                              jnp.bfloat16)
        assert _same_bits(jback, back)


def test_encode_host_names_parts_by_numpy_dtype():
    x = torch.randn(4, 128).to(torch.bfloat16)
    _, meta = tcodecs.get("bit_exact").encode_host(x, 2)
    assert meta == {"parts": {"payload": {"shape": [4, 128],
                                          "dtype": "bfloat16",
                                          "nbytes": 1024}}, "bits": 2}
    _, meta = tcodecs.get("sfp16").encode_host(torch.randn(4, 100), None)
    assert meta["parts"]["payload"]["dtype"] == "uint16"
    assert list(meta["parts"]) == ["bases", "payload"]


# -- the validate_name repair ----------------------------------------------


@pytest.mark.parametrize("typo,expect", [
    ("sfp-2me4", "sfp-m2e4"), ("sfpm2e4", "sfp-m2e4"),
    ("sfp8-2m4", "sfp8-m2e4"), ("gecko9", "gecko8")])
def test_validate_name_suggests_what_jax_suggests(typo, expect):
    assert tcodecs.base.suggest_name(typo) == expect
    assert jcodecs.suggest_name(typo) == expect
    msgs = []
    for validate in (jcodecs.validate_name, tcodecs.validate_name):
        with pytest.raises(ValueError) as e:
            validate(typo)
        msgs.append(str(e.value))
    # JAX's registered list grows as its factories build codecs; the port
    # keeps what they build apart, so the did-you-mean part is compared.
    assert [m.split(" (registered")[0] for m in msgs] == [
        f"unknown container codec {typo!r}; did you mean {expect!r}?"] * 2
    assert msgs[1].endswith(f"; parametric: {jcodecs.base.PARAMETRIC_GRAMMAR})")
    assert tcodecs.base.PARAMETRIC_GRAMMAR == jcodecs.base.PARAMETRIC_GRAMMAR


def test_reduced_config_checkpoint_names_match(tmp_path):
    """A port checkpoint of a model's parameters carries the leaf names of
    the parameter dict (one dict a layer)."""
    model = DecoderModel(reduced(tconfigs.get("gemma2-2b")), device="cpu")
    params = model.init(0)
    CheckpointManager(str(tmp_path)).save(1, params)
    names = [e["name"] for e in _manifest(tmp_path / STEP_DIR)["leaves"]]
    assert names == leaf_names(params)
    assert "['layers'][0]['mlp']['w_out']" in names
