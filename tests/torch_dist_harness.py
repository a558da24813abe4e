"""Rank harness of the port's distributed tests (``test_torch_dist_*.py``):
CPU ranks over gloo.

``run_ranks(fn, world, tmp_path, *args)`` spawns ``world`` processes, each
at one thread and joined to a gloo process group through a ``FileStore``
in ``tmp_path`` (no TCP port, so parallel test workers cannot collide),
calls ``fn(rank, world, *args)`` there and returns each rank's (pickled)
result. A rank that fails ends the run at once with its traceback; the
whole run has ``TIMEOUT`` seconds. The rank functions live here, not in
the test files, because a spawned process imports the module that defines
its function, and this one imports no JAX: the JAX package runs in the
test process on one device, and its inputs and results reach the ranks
as files.
"""
from __future__ import annotations

import multiprocessing
import pickle
import time
import traceback
import uuid
from pathlib import Path

import numpy as np

TIMEOUT = 120          # seconds for a whole spawn, ranks' start included
LR = 1e-3
ADAM_B1 = 0.9          # AdamWConfig's default
SCHED = dict(kind="cosine", base_lr=LR, warmup_steps=1, total_steps=10)
MICRO = 2              # microbatches a step


def _entry(rank, world, store, out, fn, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        res = ("ok", fn(rank, world, *args))
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - reported to the test process
        res = ("error", f"rank {rank}:\n{traceback.format_exc()}")
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)
    if res[0] == "error":
        raise SystemExit(1)


def run_ranks(fn, world: int, tmp_path: Path, *args, timeout=TIMEOUT):
    """Each rank's ``fn(rank, world, *args)``, in rank order."""
    tag = uuid.uuid4().hex[:8]
    store, out = str(tmp_path / f"store-{tag}"), str(tmp_path / f"res-{tag}")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(r, world, store, out, fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    results = []
    for r in range(world):
        path = Path(f"{out}.{r}")
        if not path.exists():
            results.append(("error", f"rank {r}: no result (killed or "
                                     f"past the {timeout} s limit)"))
            continue
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    errors = [msg for kind, msg in results if kind == "error"]
    assert not errors, "\n".join(errors)
    return [res for _, res in results]


# --- the sharded train step ----------------------------------------------------


def _policy(tpolicies, spec):
    """The port's policy of a case's ``(name, kwargs)``."""
    if spec is None:
        return None
    name, kw = spec
    if name == "qm+qe":
        return tpolicies.CompositePolicy(policies=(
            tpolicies.get("qm", **kw), tpolicies.get("qe", **kw)),
            container=kw["container"])
    return tpolicies.get(name, **kw)


def _t_ceil(n_float, generator, max_bits, min_bits=0, shape=None):
    """Every draw its bitlength's ceiling (the JAX side injects the same)."""
    import torch
    nf = torch.clamp(n_float.detach().float(), float(min_bits),
                     float(max_bits))
    n = torch.ceil(nf).to(torch.int32)
    return n if shape is None else n.expand(tuple(shape)).clone()


def _stash_jax_inputs(codec, rows, records, flips):
    """Patch the registry codec instance ``codec`` to pack, in place of
    each stash input, this rank's rows of JAX's (held to the port's
    within 1e-5 of the largest), counting the packed values that differ
    by a truncation step (``flips``)."""
    import torch
    pack, inputs = codec.pack, iter(records)

    def substituted(x, bits=None):
        theirs = rows(torch.from_numpy(next(inputs)))
        gap = (theirs - x.detach()).abs().max() / theirs.abs().max()
        assert float(gap) <= 1e-5, float(gap)
        a = codec.unpack(pack(x, bits))
        b = codec.unpack(pack(theirs, bits))
        differ = a != b
        step = (a - b).abs()[differ]
        assert bool((step <= 0.5 * b.abs()[differ] + 1e-30).all())
        flips.append((int(differ.sum()), differ.numel()))
        return pack(theirs, bits)
    codec.pack = substituted


def sharded_steps(rank, world, case_file):
    """Run each of a case's steps through the sharded train step, in each
    of its layouts, from the state JAX started that step from; returns per
    layout and step the metrics, the stash flips and (gathered) the first
    moments, parameters and learned bitlengths."""
    import dataclasses
    import torch
    from repro_torch import configs as tconfigs
    from repro_torch import policies as tpolicies
    from repro_torch.configs.base import reduced
    from repro_torch.core import containers as tcontainers
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import Schedule
    from repro_torch.train import step as tstep

    case = torch.load(case_file, weights_only=False)
    arch, heads = CONFIGS[case["arch"]]
    cfg = dataclasses.replace(reduced(tconfigs.get(arch), n_layers=4),
                              dtype="float32", **heads)
    mesh = _mesh(world, case["shape"])
    policy = _policy(tpolicies, case["policy"])
    tc = tstep.TrainConfig(opt=adamw.AdamWConfig(lr=LR),
                           schedule=Schedule(**SCHED),
                           num_microbatches=MICRO,
                           grad_compress_bits=case["grad_compress_bits"])
    # The patches of this case, undone for the spawn's next job.
    draw = tcontainers.stochastic_bitlength
    compress = tstep.grad_compress.compress_grads
    try:
        return _steps(case, cfg, mesh, policy, tc, rank, _t_ceil if
                      case["ceil"] else draw, compress)
    finally:
        tcontainers.stochastic_bitlength = draw
        tstep.grad_compress.compress_grads = compress


def _steps(case, cfg, mesh, policy, tc, rank, draw, compress):
    """``sharded_steps``'s loop over the case's layouts and steps, with
    ``draw`` as the stash's bitlength draw and the wire captured around
    ``compress``."""
    import torch
    from repro_torch import codecs as tcodecs
    from repro_torch.core import containers as tcontainers
    from repro_torch.core.stash import float_leaves
    from repro_torch.data import pipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import DecoderModel
    from repro_torch.optim import adamw
    from repro_torch.policies import PolicyState
    from repro_torch.train import step as tstep
    from repro_torch.train.state import TrainState

    tcontainers.stochastic_bitlength = draw
    wire = []
    if tc.grad_compress_bits is not None:

        def capturing(grads, residual, bits, codec):
            gf = [g.float() + r for g, r in zip(grads, residual)]
            q, r = compress(grads, residual, bits, codec)
            wire.append((gf, [t.clone() for t in q],
                         [t.clone() for t in r]))
            return q, r
        tstep.grad_compress.compress_grads = capturing
    gen = torch.Generator()
    gen.manual_seed(0)
    results = {}
    for layout in case["layouts"]:
        rules = shd.rules_for(mesh, layout=layout)
        model = DecoderModel(cfg, policy, device="cpu", mesh=mesh,
                             rules=rules)
        forward = None
        if "forward" in case:
            forward = _forward_metrics(model, case, rules)

        def start(st):
            return tstep.shard_state(model, TrainState(
                params=st["params"],
                opt=adamw.AdamWState(m=st["m"], v=st["v"],
                                     count=st["count"]),
                pstate=PolicyState(learn=st["learn"], ctrl=st["ctrl"]),
                step=st["step"], gen=gen, grad_residual=st["residual"]))
        flips = []
        if policy is not None:
            row_sh = shd.Sharding(mesh, shd.spec_from_axes(
                ("batch", None, None), rules, mesh))
            _stash_jax_inputs(tcodecs.get(policy.container),
                              lambda t: shd.local_chunk(t, row_sh),
                              [r for step in case["records"] for r in step],
                              flips)
        step_fn = tstep.make_train_step(model, tc)
        specs = shd.batch_specs(rules, "train",
                                "cond_embeddings" in case["batches"][0],
                                mesh)
        out = []
        for st, b in zip(case["states"], case["batches"]):
            n0 = len(flips)
            state, met = step_fn(start(st), pipeline.place(b, specs))
            rec = {"metrics": {k: float(v) for k, v in met.items()},
                   "flips": flips[n0:]}
            gathered = {k: [shd.full(t).detach().numpy()
                            for _, t in float_leaves(tree)]
                        for k, tree in (("m", state.opt.m),
                                        ("params", state.params))}
            if wire:
                gathered["wire"] = [[shd.full(shd.DTensor.from_local(
                    t, mesh, p.placements, run_check=False)).numpy()
                    for t, p in zip(part, adamw.leaves(state.params))]
                    for part in wire.pop()]
            if rank == 0:
                rec.update(gathered, learn={
                    path: t.detach().numpy() for path, t in float_leaves(
                        state.pstate.learn)})
            out.append(rec)
        if policy is not None:
            del tcodecs.get(policy.container).pack
        results[layout] = out
        if forward is not None:
            results[layout + " forward"] = forward
    return results


def _forward_metrics(model, case, rules):
    """The sharded model's forward metrics on the case's first state and
    the first microbatch of its first batch (policy off)."""
    import torch
    from repro_torch.data import pipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import RunState
    params = shd.tree_map(lambda t, sh: shd.local(shd.distribute(t, sh)),
                          case["states"][0]["params"], model.shardings)
    rows = {k: v[:B // MICRO] for k, v in case["batches"][0].items()}
    mb = pipeline.place(rows, shd.batch_specs(rules, "train", False,
                                              model.mesh))
    with torch.no_grad():
        _, met = model.forward(params, shd.local(mb["tokens"]),
                               RunState(gen=None, pol=None))
    return {k: float(v) for k, v in met.items()}


# --- the JAX side of a step case (run in the test process) ----------------

B, S, STEPS = 8, 32, 2  # global batch rows and tokens, steps a case
# The step cases' configs by name: an arch, reduced to 4 layers in f32,
# with these changes (the same in both packages).
CONFIGS = {"gemma2-2b": ("gemma2-2b", {}),
           "mistral-large-123b": ("mistral-large-123b", {}),
           # paligemma's one KV head, at 4 query heads of 32
           "paligemma-3b": ("paligemma-3b",
                            dict(n_heads=4, n_kv_heads=1, head_dim=32)),
           "olmoe-1b-7b": ("olmoe-1b-7b", {}),  # 4 experts, top 2
           "mamba2-370m": ("mamba2-370m", {}),
           "recurrentgemma-9b": ("recurrentgemma-9b", {}),
           # 6 query heads over 2 KV heads: replicated at a TP degree of 4
           "gemma2-2b-6q2kv": ("gemma2-2b",
                               dict(n_heads=6, n_kv_heads=2, head_dim=32))}
# The (config, policy) cases whose JAX step runs op by op
# (``jax.disable_jit``): jitted, XLA's fusions reassociate f32 sums, which
# put the reduced olmoe's first moments after its second step 1.09e-5 of
# a leaf's largest from the port's one-device step's (ROADMAP §C).
EAGER = {("olmoe-1b-7b", "none")}
# The policies of the step cases: qm over sfp8 from integer bits, qm+qe
# over sfp-m2e4 from fractional bits. The bits are fractional after the
# first SGD step, and the two packages' generators differ, so every draw
# is injected as its bitlength's ceiling on both sides.
POLICIES = {
    "none": (None, None, False),
    "qm-sfp8": (("qm", dict(gamma=0.05, lr=0.05, container="sfp8")),
                {"act": 3.0, "w": 5.0}, True),
    "qm+qe-sfp-m2e4": (("qm+qe", dict(gamma=0.05, lr=0.05,
                                      container="sfp-m2e4")),
                       {"qm": {"act": 1.5, "w": 4.5},
                        "qe": {"act": 3.5, "w": 4.5}}, True),
}


def _j_ceil(n_float, key, max_bits, min_bits=0, shape=None):
    import jax.numpy as jnp
    nf = jnp.clip(jnp.asarray(n_float, jnp.float32), float(min_bits),
                  float(max_bits))
    n = jnp.ceil(nf).astype(jnp.int32)
    return n if shape is None else jnp.broadcast_to(n, shape)


def _set_learn(learn, bits):
    import jax.numpy as jnp
    if "qm" in bits:
        return {s: _set_learn(learn[s], bits[s]) for s in learn}
    return {k: jnp.full_like(v, bits["act" if k.startswith("act") else "w"])
            for k, v in learn.items()}


def jax_steps(config, policy, monkeypatch, grad_compress_bits=None):
    """JAX's one-device step on the config ``config`` of ``CONFIGS`` for
    STEPS steps of B x S batches, MICRO microbatches: (the case's inputs
    for ``sharded_steps``, JAX's per-step results in the port's layout).
    An MoE case without a policy also holds JAX's forward metrics of the
    first microbatch (``forward``)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro import codecs as jcodecs
    from repro import configs as jconfigs
    from repro import policies as jpolicies
    from repro.configs.base import reduced as jreduced
    from repro.core import containers as jcontainers
    from repro.data import synthetic as jsyn
    from repro.models.model import DecoderModel as JModel
    from repro.optim import adamw as jadamw
    from repro.optim.schedule import Schedule as JSchedule
    from repro.train import step as jstep
    from repro_torch import configs as tconfigs
    from repro_torch import convert
    from repro_torch.configs.base import reduced as treduced

    spec, bits, ceil = POLICIES[policy]
    arch, heads = CONFIGS[config]
    jc = dataclasses.replace(jreduced(jconfigs.get(arch), n_layers=4),
                             dtype="float32", **heads)
    tcfg = dataclasses.replace(treduced(tconfigs.get(arch), n_layers=4),
                               dtype="float32", **heads)
    jpol = None
    if spec is not None:
        name, kw = spec
        jpol = (jpolicies.CompositePolicy(policies=(
            jpolicies.get("qm", **kw), jpolicies.get("qe", **kw)),
            container=kw["container"]) if name == "qm+qe"
            else jpolicies.get(name, **kw))
    if ceil:
        monkeypatch.setattr(jcontainers, "stochastic_bitlength", _j_ceil)
    corpus = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0))
    batches = []
    for i in range(STEPS):
        b = corpus.batch(i)
        if jc.prefix_tokens:
            b["cond_embeddings"] = np.random.default_rng(i).standard_normal(
                (B, jc.prefix_tokens, jc.d_model)).astype(np.float32)
        batches.append(b)
    jtc = jstep.TrainConfig(opt=jadamw.AdamWConfig(lr=LR),
                            schedule=JSchedule(**SCHED),
                            num_microbatches=MICRO,
                            grad_compress_bits=grad_compress_bits)
    jm = JModel(jc, jpol)
    js = jstep.init_state(jm, jax.random.PRNGKey(0), jtc)
    if bits is not None:
        js = js._replace(pstate=js.pstate._replace(
            learn=_set_learn(js.pstate.learn, bits)))
    js = js._replace(step=jnp.asarray(1, jnp.int32))
    record = []
    if jpol is not None:
        codec = jcodecs.get(jpol.container)
        pack = codec.pack

        def recording(x, bits=None):
            jax.debug.callback(lambda a: record.append(np.array(a)), x,
                               ordered=True)
            return pack(x, bits)
        monkeypatch.setattr(codec, "pack", recording)
    wire = []
    if grad_compress_bits is not None:
        compress = jstep.grad_compress.compress_grads

        def capturing(grads, residual, bits, codec):
            q, r = compress(grads, residual, bits, codec)
            gf = jax.tree.map(lambda g, r0: g.astype(jnp.float32) + r0,
                              grads, residual)
            jax.debug.callback(lambda *t: wire.append(t), gf, q, r)
            return q, r
        monkeypatch.setattr(jstep.grad_compress, "compress_grads",
                            capturing)
    forward = None
    if jc.is_moe and jpol is None:
        rows = {k: jnp.asarray(v[:B // MICRO]) for k, v in batches[0].items()}
        _, met = jax.jit(lambda p, t: jm.forward(
            p, t, jm.run_state(jax.random.PRNGKey(1))))(js.params,
                                                         rows["tokens"])
        forward = {k: float(v) for k, v in met.items()}
    step = jstep.make_train_step(jm, jtc)
    eager = (config, policy) in EAGER
    if not eager:
        step = jax.jit(step)
    records, outs, states = [], [], []
    for b in batches:
        ts = convert.state_from_jax(jax.tree.map(np.asarray, js), tcfg)
        states.append({"params": ts.params, "m": ts.opt.m, "v": ts.opt.v,
                       "count": ts.opt.count,
                       "learn": _detached(ts.pstate.learn),
                       "ctrl": ts.pstate.ctrl, "step": ts.step,
                       "residual": ts.grad_residual})
        n0 = len(record)
        with jax.disable_jit(eager):
            js, met = step(js, {k: jnp.asarray(v) for k, v in b.items()})
        jax.effects_barrier()
        records.append(record[n0:])
        host = jax.tree.map(np.asarray, js)
        outs.append({
            "metrics": {k: float(np.asarray(v)) for k, v in met.items()},
            "m": [t.numpy() for t in _leaves(convert.from_jax(host.opt.m,
                                                               tcfg))],
            "params": [t.numpy() for t in _leaves(convert.from_jax(
                host.params, tcfg))],
            "learn": _paths(host.pstate.learn)})
        if wire:
            outs[-1]["wire"] = [[t.numpy() for t in _leaves(convert.from_jax(
                jax.tree.map(np.asarray, part), tcfg))] for part in wire.pop()]
    case = {"arch": config, "policy": spec,
            "ceil": ceil, "grad_compress_bits": grad_compress_bits,
            "states": states, "batches": batches, "records": records}
    if forward is not None:
        case["forward"] = forward
    return case, outs


def _paths(tree, path=()):
    """{path: array} of a nest of dicts (JAX's learned bitlengths)."""
    if isinstance(tree, dict):
        return {p: a for k, v in tree.items()
                for p, a in _paths(v, path + (k,)).items()}
    return {path: np.asarray(tree, np.float32)}


def _leaves(tree):
    from repro_torch.core.stash import float_leaves
    return [t for _, t in float_leaves(tree)]


def _detached(tree):
    """A nest of tensors detached from their graph (to pickle), each
    keeping its ``requires_grad``."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(tree.requires_grad)


WORLD = 4  # ranks of every spawn
# The step cases, (config name, policy, mesh shape, grad_compress_bits):
# each arch's policies on a (2, 2) mesh (both layouts), gemma2-2b's qm +
# sfp8 on a (4, 1) mesh and the replicated heads' policies on a (1, 4)
# mesh (tp only). One spawn of ranks runs every case of a config name. The
# compressed wire's case (tp only) runs in the spawn of
# ``tests/test_torch_dist_ops.py``.
REPLICATED = "gemma2-2b-6q2kv"
STEP_CASES = ([(name, policy, (2, 2), None) for name in CONFIGS
               if name != REPLICATED for policy in POLICIES]
              + [("gemma2-2b", "qm-sfp8", (4, 1), None)]
              + [(REPLICATED, policy, (1, 4), None) for policy in POLICIES])
COMPRESSED_CASE = ("gemma2-2b", "qm-sfp8", (2, 2), 4)
_RESULTS = {}


def run_jobs(rank, world, jobs):
    """A rank's results of each ``(fn, args)`` of ``jobs``, in order: one
    spawn runs several, so that ranks start (and import torch) once."""
    return [fn(rank, world, *args) for fn, args in jobs]


def run_step_cases(keys, tmp_dir, jobs=()):
    """JAX's steps for each case of ``keys`` (see ``STEP_CASES``), then
    one spawn of ranks that runs every case's sharded steps and then
    ``jobs``; keeps the cases' results for ``check_step_case`` and returns
    each rank's results of ``jobs``."""
    import pytest
    import torch
    prepared, step_jobs = [], []
    for key in keys:
        arch, policy, shape, bits = key
        with pytest.MonkeyPatch.context() as mp:
            case, outs = jax_steps(arch, policy, mp, grad_compress_bits=bits)
        layouts = ("tp", "fsdp") if shape == (2, 2) and bits is None \
            else ("tp",)
        path = tmp_dir / f"case-{len(prepared)}.pt"
        torch.save(dict(case, layouts=layouts, shape=shape), path)
        prepared.append((key, case, outs))
        step_jobs.append((sharded_steps, (str(path),)))
    ranks = run_ranks(run_jobs, WORLD, tmp_dir, step_jobs + list(jobs))
    for i, (key, case, outs) in enumerate(prepared):
        _RESULTS[key] = (case, outs, [r[i] for r in ranks])
    return [r[len(prepared):] for r in ranks]


def check_step_case(arch, policy, layout, tmp_path_factory, shape=(2, 2),
                    grad_compress_bits=None):
    """Run the reduced ``arch``'s steps under ``policy`` on ranks of a
    ``shape`` mesh in ``layout`` and hold them to JAX's one-device steps
    (ROADMAP §C parity rules): every rank's metrics equal; loss, xent,
    grad norm, penalty and the MoE metrics ``moe_lb_loss`` and
    ``moe_drop_frac`` (zeros when dense) at rtol 1e-5, and an MoE model's
    forward metrics (``moe_z_loss`` too) without a policy; stash flips
    isolated (under 1e-3 of the values, one truncation step each, as the
    port's one-device test allows); every gradient (AdamW's first moment after each step) at
    1e-5 of its largest, or the compressed wire's rule (``_wire_flips``);
    the learned bitlengths after their SGD step at 1e-6 (the draws are
    injected); the parameters at rtol 1e-4 / atol 1e-6 where |g| > 1e-6
    (g the step's gradient, from JAX's first moments before and after it)
    and within 2 lr elsewhere. Each step starts from JAX's state: Adam
    moves a parameter whose gradient two summation orders cannot agree on
    (|g| below ~1e-6) by up to 2 lr, and such a move shifts the next
    step's gradients by more than their tolerance. The first case of an
    arch runs all of the arch's ``STEP_CASES`` (JAX once each, the ranks
    in one spawn); the results are kept for the other cases' tests."""
    key = (arch, policy, shape, grad_compress_bits)
    if key not in _RESULTS:
        keys = ([k for k in STEP_CASES if k[0] == arch]
                if key in STEP_CASES else [key])
        run_step_cases(keys, tmp_path_factory.mktemp("steps"))
    case, outs, ranks_all = _RESULTS[key]
    ranks = [r[layout] for r in ranks_all]
    mine = ranks[0]
    for r in ranks[1:]:
        for a, b in zip(mine, r):
            assert a["metrics"] == b["metrics"]
    if "forward" in case:
        for r in ranks_all:
            got = r[layout + " forward"]
            for k, v in case["forward"].items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    for i, (got, want) in enumerate(zip(mine, outs)):
        for k in ("loss", "xent", "grad_norm", "policy_penalty",
                  "moe_lb_loss", "moe_drop_frac"):
            np.testing.assert_allclose(got["metrics"][k],
                                       want["metrics"][k], rtol=1e-5,
                                       err_msg=(i, k))
        flips = [f for r in ranks for f in r[i]["flips"]]
        assert all(n <= 1e-3 * size for n, size in flips), flips
        assert got["learn"].keys() == want["learn"].keys()
        for k, v in want["learn"].items():
            np.testing.assert_allclose(got["learn"][k], v, atol=1e-6,
                                       err_msg=str(k))
        if "wire" in want:
            same = _wire_flips(got["wire"], want["wire"],
                               case["grad_compress_bits"], i)
        else:
            same = [True] * len(want["m"])
            for j, (a, b) in enumerate(zip(got["m"], want["m"])):
                gap = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
                assert gap <= 1e-5, (i, j, gap)
        for a, b, m, m0, q in zip(got["params"], want["params"], want["m"],
                                  _leaves(case["states"][i]["m"]), same):
            # The step's gradient, from JAX's moments before and after it.
            g = (m - ADAM_B1 * m0.detach().numpy()) / (1 - ADAM_B1)
            d = np.abs(a - b)
            sure = (np.abs(g) > 1e-6) & q
            assert (d[sure] <= 1e-6 + 1e-4 * np.abs(b[sure])).all(), i
            assert d.max() <= 2 * LR + 1e-6, i


def _wire_flips(got, want, bits, i):
    """Hold the compressed gradients (gf = g + the residual fed in, its
    ``bits``-bit round trip q, the new residual) to JAX's with the wire
    rule of ROADMAP §C ("gradient wire flips"): the gf at 1e-5 of each
    leaf's largest (both steps start from one residual, so this is the
    gradient's gap), q within one truncation step plus the gf gap (under
    1e-2 of the values a step apart), the residual within the gf gap where
    the q agree. Returns per leaf where the q agree."""
    same, flips, n = [], 0, 0
    for a_gf, b_gf, a_q, b_q, a_r, b_r in zip(want[0], got[0], want[1],
                                              got[1], want[2], got[2]):
        tol = 1e-5 * np.abs(a_gf).max()
        gap = np.abs(a_gf - b_gf)
        assert gap.max() <= tol, i
        gap = gap + tol
        step = np.exp2(np.floor(np.log2(np.maximum(
            np.maximum(np.abs(a_q), np.abs(b_q)), 1e-38))) - bits)
        assert np.all(np.abs(a_q - b_q) <= step + gap), i
        agree = a_q == b_q
        assert np.all((np.abs(a_r - b_r) <= gap)[agree]), i
        same.append(agree)
        flips += int((~agree).sum())
        n += agree.size
    assert flips <= 1e-2 * n, (i, flips, n)
    return same


# --- the distributed pieces ------------------------------------------------


_MESHES = {}


def _mesh(world, shape):
    """The rank's (data, model) mesh of ``shape`` over the whole group,
    built once a spawn (every rank builds it in the same order)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    if shape not in _MESHES:
        _MESHES[shape] = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                                    mesh_dim_names=("data", "model"))
    return _MESHES[shape]


def vocab_parallel(rank, world, inputs):
    """``sharded_embed``, ``unembed(mesh=)`` and the vocab-parallel
    ``softmax_xent`` on a (2, 2) mesh: this rank's rows (over data) and
    vocab shard (over model), forward and gradients."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import common
    mesh = _mesh(world, (2, 2))
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    rows = slice(d * 4, (d + 1) * 4)
    V = t["table"].shape[0]
    cols = slice(m * V // 2, (m + 1) * V // 2)
    table = t["table"][cols].clone().requires_grad_()
    h = common.embed({"table": table}, t["tokens"][rows].long(), 2.0,
                     mesh=mesh)
    (g_table,) = torch.autograd.grad((h * t["dh"][rows]).sum(), table)
    shd.all_reduce_(g_table, mesh.get_group("data"))
    x = t["h"][rows].clone().requires_grad_()
    head = t["head"][:, cols].clone().requires_grad_()
    out = {"embed": h.detach().numpy(), "g_table": g_table.numpy()}
    for tied in (True, False):
        logits = common.unembed({"embed": {"table": table}, "head": head},
                                x, tied=tied, softcap=30.0,
                                valid_vocab=V - 24, mesh=mesh)
        xent = common.softmax_xent(logits, t["labels"][rows].long(),
                                   mesh=mesh)
        wrt = [x, table if tied else head]
        gx, gw = torch.autograd.grad(xent, wrt)
        out[tied] = {"logits": logits.detach().numpy(),
                     "xent": float(xent), "gx": gx.numpy(),
                     "gw": gw.numpy()}
    return out


def psum(rank, world, inputs):
    """``psum_compressed`` over the whole group, twice (the second round
    trip from the first's residual)."""
    import torch
    import torch.distributed as dist
    from repro_torch.train import grad_compress
    g = [torch.from_numpy(a[rank]) for a in inputs["grads"]]
    r = [torch.zeros_like(t) for t in g]
    out = []
    for step in range(2):
        s, r = grad_compress.psum_compressed(
            [t.clone() for t in g] if step == 0 else
            [torch.from_numpy(a[rank]) * 0.5 for a in inputs["grads"]],
            r, inputs["bits"], dist.group.WORLD)
        out.append(([t.numpy().copy() for t in s],
                    [t.numpy().copy() for t in r]))
    return out


def pipeline_stages(rank, world, inputs):
    """``pipeline_apply`` over the whole group, one stage a rank:
    outputs, and the gradients of sum(out * c) for this rank's stage
    weight and for x."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.pipeline import pipeline_apply
    w = torch.from_numpy(inputs["ws"][rank]).requires_grad_()
    x = torch.from_numpy(inputs["x"]).requires_grad_()
    out = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), {"w": w}, x,
                         dist.group.WORLD)
    gw, gx = torch.autograd.grad((out * torch.from_numpy(inputs["c"])).sum(),
                                 [w, x])
    return {"out": out.detach().numpy(), "gw": gw.numpy(),
            "gx": gx.numpy()}


def elastic_restore(rank, world, ckpt_dir):
    """Save a reduced gemma2-2b's sharded training state from a (2, 2) tp
    mesh, restore it onto a (4, 1) fsdp mesh and onto the 2-rank sub-mesh
    ``plan_remesh`` picks (the other ranks off it), and return every leaf
    gathered whole each time (rank 0), with the placements restored."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager, named_leaves
    from repro_torch.configs.base import reduced
    from repro_torch.core.stash import float_leaves
    from repro_torch.distributed import elastic
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import DecoderModel
    from repro_torch.train import step as tstep
    cfg = dataclasses.replace(reduced(configs.get("gemma2-2b"), n_layers=4),
                              dtype="float32")
    tc = tstep.TrainConfig(grad_compress_bits=4)

    def gathered(state):
        """Every tensor leaf whole, by its checkpoint name."""
        return {name: shd.full(t).detach().numpy()
                for name, t in named_leaves(state)
                if isinstance(t, torch.Tensor)}

    def placements(state):
        return [tuple(t.placements) for _, t in float_leaves(state.params)]
    a = DecoderModel(cfg, "qm", device="cpu", mesh=_mesh(world, (2, 2)))
    state = tstep.init_state(a, 0, tc)
    # Give the moments and residual values of their own.
    for i, (_, t) in enumerate(float_leaves([state.opt.m, state.opt.v,
                                             state.grad_residual])):
        shd.local(t).copy_(torch.randn(shd.local(t).shape,
                                       generator=torch.Generator()
                                       .manual_seed(100 * i + rank)))
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(3, state, blocking=False)
    mgr.wait()
    out = {"saved": gathered(state)}
    b = DecoderModel(cfg, "qm", device="cpu", mesh=_mesh(world, (4, 1)),
                     rules=shd.rules_for(_mesh(world, (4, 1)),
                                         layout="fsdp"))
    back = mgr.restore(3, state, shardings=tstep.state_shardings(b, state))
    out["fsdp"] = gathered(back)
    out["fsdp_placements"] = (placements(back),
                              [s.placements for _, s in
                               _shardings(b.shardings)])
    plan = elastic.plan_remesh(2, cfg, global_batch=8, prefer_tp=2)
    sub = elastic.build_mesh(plan, device_type="cpu")
    if sub.get_coordinate() is not None:
        c = DecoderModel(cfg, "qm", device="cpu", mesh=sub)
        back = mgr.restore(3, state,
                           shardings=tstep.state_shardings(c, state))
        out["sub"] = gathered(back)
        out["sub_shape"] = tuple(sub.shape)
    return out if rank == 0 else None


def _shardings(tree):
    from repro_torch.models.model import _sharding_leaves
    return _sharding_leaves(tree)


def exchange(rank, world, inputs):
    """``sharding.all_to_all`` over the whole group and over each (2, 2)
    mesh's ``model`` dim: every rank's exchange of its block tensor, and
    the gradient of sum(out * c) for that tensor."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    mesh = _mesh(world, (2, 2))
    out = {}
    for what, group in (("world", dist.group.WORLD),
                        ("model", mesh.get_group("model"))):
        x = torch.from_numpy(inputs["x"][what][rank]).requires_grad_()
        y = shd.all_to_all(x, group)
        (g,) = torch.autograd.grad(
            (y * torch.from_numpy(inputs["c"][what][rank])).sum(), x)
        out[what] = {"y": y.detach().numpy(), "g": g.numpy()}
    return out


def placement_and_gates(rank, world, inputs):
    """``data.pipeline.place`` / ``prefetch`` with the batch specs of both
    layouts on a (2, 2) mesh, what a mesh of four ranks refuses (the
    paged engine) and serves (the reduced gemma2-2b's ``prefill`` and a
    ``decode_step``: the logits' shape) and the reduced MoE, SSD and
    RG-LRU models it builds in both layouts."""
    import dataclasses
    import torch
    from repro_torch import NotYetPorted, configs
    from repro_torch.configs.base import reduced
    from repro_torch.data import pipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import DecoderModel
    from repro_torch.serve import engine
    mesh = _mesh(world, (2, 2))
    out = {}
    for layout in ("tp", "fsdp"):
        specs = shd.batch_specs(shd.rules_for(mesh, layout=layout), "train",
                                True, mesh)
        placed = list(pipeline.prefetch(iter(inputs["batches"]), specs))
        out[layout] = [{k: (v.to_local().numpy(), shd.full(v).numpy(),
                            str(v.to_local().dtype))
                        for k, v in b.items()} for b in placed]
    refused, built = {}, []
    for name in ("olmoe-1b-7b", "mamba2-370m", "recurrentgemma-9b"):
        for layout in ("tp", "fsdp"):
            try:
                DecoderModel(reduced(configs.get(name)), device="cpu",
                             mesh=mesh, rules=shd.rules_for(mesh,
                                                            layout=layout))
                built.append((name, layout))
            except NotYetPorted as e:
                refused[name] = str(e)
    out["built"] = built
    cfg = dataclasses.replace(reduced(configs.get("gemma2-2b")),
                              dtype="float32")
    model = DecoderModel(cfg, kv_container="sfp8", device="cpu", mesh=mesh)
    params = model.local_params(DecoderModel(cfg, device="cpu").init(0))
    tokens = torch.zeros((2, 4), dtype=torch.long)
    try:
        engine.PagedEngine(model, params)
    except NotYetPorted as e:
        refused["PagedEngine"] = str(e)
    out["refused"] = refused
    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens, 8)
        step, _ = model.decode_step(params, cache, tokens[:, :1], 4)
    out["served"] = (tuple(logits.shape), tuple(step.shape))
    out["coord"] = tuple(mesh.get_coordinate())
    return out
