"""Rank side of the sharded serving tests (``test_torch_dist_serve*.py``):
CPU ranks over gloo, spawned by ``torch_dist_harness.run_ranks``.

A case file holds a reduced config's JAX parameters (numpy), the prompt,
and per cache container the greedy tokens the test holds the port to; the
ranks build the port's model on each of the case's meshes and layouts,
serve it (``prefill``, the teacher-forced ``decode_step``s, ``generate``
and ``make_prefill_step`` + ``make_decode_loop``) and return what they
computed, the caches gathered whole. The JAX side of a case
(``jax_serve``, ``serve_and_spawn``) runs in the test process and imports
JAX inside its functions, so the ranks, which import this module, never
do.
"""
from __future__ import annotations

import contextlib
import dataclasses

from torch_dist_harness import _mesh

# Seconds for a serving spawn: a case serves up to 20 (mesh, layout,
# cache) configurations, ~40 s alone, and the tier-1 run shares the host
# with five other workers.
SPAWN_TIMEOUT = 300


def _cfg(case):
    from repro_torch import configs
    from repro_torch.configs.base import reduced
    cfg = reduced(configs.get(case["arch"]), **case["reduce"])
    return dataclasses.replace(cfg, **case["change"])


def _numpy(t):
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _whole(cache):
    """Every leaf of a served cache gathered whole, as numpy."""
    from repro_torch.distributed import sharding as shd
    return shd.tree_map(lambda t: _numpy(shd.full(t)), cache)


def _placements(cache):
    """Per layer, the placements of its cache's first leaf, as strings."""
    from repro_torch.distributed import sharding as shd
    out = []
    for entry in cache["layers"]:
        leaves = []
        shd.tree_map(lambda t: leaves.append(t), entry)
        out.append(tuple(str(p) for p in leaves[0].placements))
    return out


def serve_case(rank, world, case_file):
    """Per (mesh shape, layout, container) of the case: the prefill's last
    logits and whole cache, each teacher-forced step's logits (fed the
    case's tokens of that container), ``generate``'s tokens, prefill
    logits and margins, the step functions' tokens, and the MoE layers'
    dropped assignments per step where the arch routes."""
    import torch
    from repro_torch import convert
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe
    from repro_torch.models.model import DecoderModel
    from repro_torch.serve import engine

    case = torch.load(case_file, weights_only=False)
    cfg = _cfg(case)
    params = convert.from_jax(case["params"], cfg)
    prompt = torch.from_numpy(case["prompt"]).long()
    S, new, max_len = prompt.shape[1], case["new"], case["max_len"]
    out = {}
    for shape, layouts in case["meshes"]:
        mesh = _mesh(world, shape)
        for layout in layouts:
            rules = shd.rules_for(mesh, layout=layout)
            for container in case["containers"]:
                model = DecoderModel(cfg, kv_container=container,
                                     device="cpu", mesh=mesh, rules=rules)
                lp = model.local_params(params)
                toks = torch.from_numpy(case["tokens"][container]).long()
                drops, place = [], moe.place

                def counting(idx, c):
                    pos, keep = place(idx, c)
                    if idx.shape[:2] == (1, prompt.shape[0]):  # a decode
                        drops.append(int((~keep).sum()))      # step's group
                    return pos, keep
                moe.place = counting
                try:
                    with torch.inference_mode():
                        logits, cache = model.prefill(lp, prompt, max_len)
                        rec = {"prefill": logits[:, -1].numpy(),
                               "cache": _whole(cache), "steps": [],
                               "placements": _placements(cache)}
                        for i in range(new - 1):
                            lg, cache = model.decode_step(
                                lp, cache, toks[:, i:i + 1], S + i)
                            rec["steps"].append(lg[:, -1].numpy())
                        rec["drops"] = list(drops)
                        res = engine.generate(model, lp, prompt, new,
                                              max_len=max_len)
                        rec.update(tokens=res.tokens.numpy(),
                                   gen_prefill=res.prefill_logits.numpy(),
                                   margins=res.margins.numpy())
                        lg, cache = engine.make_prefill_step(
                            model, max_len)(lp, prompt)
                        tok = torch.argmax(lg[:, -1], -1, keepdim=True)
                        loop_toks, _ = engine.make_decode_loop(
                            model, new - 1)(lp, cache, tok, S)
                        rec["loop_tokens"] = torch.cat(
                            [tok, loop_toks[:, :, 0].T], 1).numpy()
                finally:
                    moe.place = place
                if rank:
                    rec.pop("cache")
                out[(shape, layout, container)] = rec
    return out


# --- the JAX side (run in the test process) ---------------------------------

def jax_serve(case, containers, max_len, new, prompt, eager=False):
    """JAX's one-device serving of ``case``'s config (weights from
    PRNGKey(0)) per container: prefill logits, greedy tokens, the logits
    of each decode step and, with ``eager`` (op by op, MoE archs), the
    assignments each decode step's whole-batch group dropped in each
    layer; and the parameters, as numpy."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro import configs as jconfigs
    from repro.configs.base import reduced as jreduced
    from repro.kernels import ops as jops
    from repro.models import moe as jmoe
    from repro.models.model import DecoderModel as JModel
    jcfg = dataclasses.replace(jreduced(jconfigs.get(case["arch"]),
                                        **case["reduce"]), **case["change"])
    drops, forward = [], jmoe.moe_forward

    def recording(params, h, cfg):
        out, aux = forward(params, h, cfg)
        if h.shape[:2] == (1, prompt.shape[0]):   # a decode step's group
            drops.append(int(round(float(aux["moe_drop_frac"])
                                   * h.shape[1] * cfg.top_k)))
        return out, aux
    jops.force_backend("interpret")
    jmoe.moe_forward = recording
    try:
        runs, params = {}, None
        for container in containers:
            jm = JModel(jcfg, kv_container=container)
            jp = jm.init(jax.random.PRNGKey(0))
            params = jax.tree.map(np.asarray, jp)
            ctx = jax.disable_jit() if eager else contextlib.nullcontext()
            with ctx:
                jit = (lambda f: f) if eager else jax.jit
                logits, cache = jit(lambda p, t: jm.prefill(p, t, max_len))(
                    jp, jnp.asarray(prompt))
                step = jit(jm.decode_step)
                lg, toks, steps = logits, [], []
                drops.clear()
                for i in range(new):
                    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
                    toks.append(np.asarray(tok))
                    if i == new - 1:
                        break
                    lg, cache = step(jp, cache, tok, jnp.asarray(
                        prompt.shape[1] + i, jnp.int32))
                    steps.append(np.asarray(lg)[:, -1])
            runs[container] = {"prefill": np.asarray(logits)[:, -1],
                               "tokens": np.concatenate(toks, 1),
                               "steps": steps, "drops": list(drops)}
        return runs, params
    finally:
        jops.force_backend(None)
        jmoe.moe_forward = forward


def serve_and_spawn(case, tmp, *, batch, seq, new, containers, jax_run,
                    meshes, eager=False):
    """JAX's runs of ``case`` (``jax_run`` maps each port container to the
    JAX container it is held to), then one spawn of four ranks serving it
    on ``meshes``: (JAX's runs, the parameters, each rank's results)."""
    import numpy as np
    import torch
    from torch_dist_harness import WORLD, run_ranks
    prompt = np.random.default_rng(0).integers(
        0, 512, (batch, seq)).astype(np.int32)
    runs, params = jax_serve(case, sorted(set(jax_run.values()), key=str),
                             seq + new, new, prompt, eager=eager)
    path = tmp / "case.pt"
    torch.save(dict(case, params=params, prompt=prompt, new=new,
                    max_len=seq + new, containers=containers, meshes=meshes,
                    tokens={c: runs[jax_run[c]]["tokens"]
                            for c in containers}), path)
    return runs, params, prompt, run_ranks(serve_case, WORLD, tmp, str(path),
                                           timeout=SPAWN_TIMEOUT)


def close(got, want, tol):
    """Logits within ``tol``'s largest and mean absolute gaps."""
    import numpy as np
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= tol["max"] and d.mean() <= tol["mean"], \
        (d.max(), d.mean())


def by_margin(got, want, logits, tol):
    """Greedy streams agree up to a first difference, which may only fall
    where JAX's top-2 margin is below twice the logit tolerance."""
    import numpy as np
    for b in range(got.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if len(diff):
            t = diff[0]
            top2 = np.sort(logits[t][b])[-2:]
            assert top2[1] - top2[0] < 2 * tol["max"], (b, t, got[b],
                                                          want[b])


def check_served(runs, ranks, key, jax_container, tol, new):
    """A case's prefill, teacher-forced step logits and greedy tokens
    against JAX's run, at ``tol`` and the near-tie rule; every rank's
    results the same, ``generate``'s equal to the step functions'."""
    import numpy as np
    run = runs[jax_container]
    mine = ranks[0][key]
    close(mine["prefill"], run["prefill"], tol)
    assert len(mine["steps"]) == len(run["steps"]) == new - 1
    for got, want in zip(mine["steps"], run["steps"]):
        close(got, want, tol)
    by_margin(mine["tokens"], run["tokens"], [run["prefill"]] + run["steps"],
              tol)
    for r in ranks:
        np.testing.assert_array_equal(r[key]["gen_prefill"], mine["prefill"])
        np.testing.assert_array_equal(r[key]["prefill"], mine["prefill"])
        for a, b in zip(r[key]["steps"], mine["steps"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r[key]["tokens"], mine["tokens"])
        np.testing.assert_array_equal(r[key]["loop_tokens"], mine["tokens"])
