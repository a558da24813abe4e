"""The per-layer stash loops of the two launchers, on the CPU.

``repro_torch.launch.train --preset tiny --policy qm+qe
--container sfp-m2e4 --per-layer-stash --stash-refresh 2 --steps 6``
against ``repro.launch.train`` with the same arguments, from one
initial state and with the stochastic draws of both sides replaced by
the ceiling of the learned bits. The qm act bits start at 3.1 and a
strong footprint penalty (``--gamma 2 --qm-lr 0.5``) moves them down
by ~0.13 a step, so the plan changes at the step-2 refresh (m4 to m3,
the bits 0.13 below the boundary) and the model is rebuilt once. The
same plans at the same steps, the same losses (bf16: rtol 1e-3,
ROADMAP §C) and one metrics file holding every step on both sides.
"""
import json
import re
import sys

import numpy as np

import jax
import jax.numpy as jnp
import torch

from repro.core import containers as jcontainers
from repro.launch import train as jlaunch
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.core import containers as tcontainers
from repro_torch.launch import train as tlaunch
from repro_torch.train import step as tstep

torch.set_num_threads(2)

CONTAINER = "sfp-m2e4"


def _j_draw(n_float, key, max_bits, min_bits=0):
    nf = jnp.clip(jnp.asarray(n_float, jnp.float32), float(min_bits),
                  float(max_bits))
    return jnp.ceil(nf).astype(jnp.int32)


def _t_draw(n_float, generator, max_bits, min_bits=0, shape=None):
    nf = torch.clamp(n_float.detach().float(), float(min_bits),
                     float(max_bits))
    n = torch.ceil(nf).to(torch.int32)
    return n if shape is None else n.expand(tuple(shape)).clone()


ARGV = ["--arch", "gemma2-2b", "--preset", "tiny", "--policy", "qm+qe",
        "--container", CONTAINER, "--per-layer-stash", "--stash-refresh", "2",
        "--steps", "6", "--qm-init-bits", "3.1", "--qm-lr", "0.5",
        "--gamma", "2"]
PLAN_LINE = re.compile(r"\[train\] per-layer stash plan @ step (\d+): (\S+)")
FINAL_LINE = re.compile(r"\[train\] final per-layer stash plan: (\S+)")


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_per_layer_launcher_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jcontainers, "stochastic_bitlength", _j_draw)
    monkeypatch.setattr(tcontainers, "stochastic_bitlength", _t_draw)
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    # JAX's launcher (argv from sys.argv), and its initial state for the
    # port's launcher.
    jargs = jlaunch.build_parser().parse_args(ARGV)
    _, jmodel, jtc, _, _ = jlaunch.build(jargs)
    js0 = jax.tree.map(np.asarray, jstep.init_state(
        jmodel, jax.random.PRNGKey(jargs.seed), jtc))
    monkeypatch.setattr(sys, "argv",
                        ["train"] + ARGV + ["--metrics", str(jpath)])
    jlaunch.main()
    jout = capsys.readouterr().out
    monkeypatch.setattr(tstep, "init_state", lambda model, seed, tc:
                        convert.state_from_jax(js0, model.cfg))
    res = tlaunch.main(ARGV + ["--metrics", str(tpath), "--device", "cpu"])
    tout = capsys.readouterr().out
    jplans, tplans = PLAN_LINE.findall(jout), PLAN_LINE.findall(tout)
    assert tplans == jplans == [("0", "sfp-m4e7"), ("2", "sfp-m3e7")]
    assert FINAL_LINE.findall(tout) == FINAL_LINE.findall(jout) == [
        "sfp-m3e7"]
    assert res["plans"] == [(0, ("sfp-m4e7",)), (2, ("sfp-m3e7",))]
    jm, tm = _metrics(jpath), _metrics(tpath)
    assert [m["step"] for m in tm] == [m["step"] for m in jm] == list(
        range(6))
    for a, b in zip(tm, jm):
        for k in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3,
                                       err_msg=(a["step"], k))
        # The learned bits move by the penalty (equal) and the stash
        # estimator, a bf16 sum in another order (measured gaps up to
        # 3.3e-4); the plans turn on them 0.13 from a boundary.
        for k in ("qm_act_mean", "qe_act_mean"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-3,
                                       err_msg=(a["step"], k))
