"""Training launcher.

  python -m repro_torch.launch.train --arch gemma2-2b --preset full \
      --policy qm --container sfp8 --batch 4 --seq 1024 --steps 4

``--policy`` takes a registered precision policy (none, static, qm, qe,
afloat, bitchop, bitwave) or a '+'-composition such as ``qm+qe`` (learn
mantissa and exponent bitlengths in one run; the ``--qm-*`` flags reach
qm, the ``--qe-*`` flags qe), ``qm+afloat`` or ``qm+bitchop``;
``--container`` the stash codec (sfp8, sfp16, bit_exact, gecko8, or a
dense geometry such as sfp-m2e4). ``--grad-compress-bits N`` sends the
gradients through a ``bit_exact`` round trip at N mantissa bits with an
error-feedback residual in the state (``train/grad_compress.py``; the
other wire codecs through ``TrainConfig.grad_codec``).
``--per-layer-stash`` packs each period's stash in its own dense container
from the policy's per-layer decisions (``DecoderModel.stash_plan``),
re-derived every ``--stash-refresh`` steps (default ``--ckpt-every``); the
model is rebuilt only when the plan changes. The loop is fault-tolerant:
with ``--ckpt-dir`` it resumes from the latest checkpoint there, saves
every ``--ckpt-every`` steps (stamping the policy, the container and the
policy's current decision into the manifest, which ``launch.serve
--policy-ckpt`` reads) and restores and continues after a failed step.
``--metrics`` is the per-step JSONL event stream; ``--metrics-out``,
``--trace-out`` and ``--timeline-out`` write the Prometheus text, the
Perfetto trace of ``train_step`` spans and the per-layer precision
timeline (every ``--timeline-every`` steps). Runs on CUDA; ``--device
cpu`` runs the plain PyTorch path on the CPU. Weights are random, drawn from
``--seed``; batches come from the seeded synthetic Markov corpus. The
tiny and small presets shrink the config and fix batch 8 and sequence 64
or 128, as the JAX launcher does. ``--profile-steps N`` brackets
``torch.profiler`` around N steps from ``--profile-start`` (default 1,
after the warm-up step), prints device time by kernel and writes the
window's Chrome trace under ``--profile-dir``.
The final report is the last step's metrics (with the controllers'
bitlengths ``bc_bits``, ``bw_man_bits``, ``bw_exp_bits``) and the modeled
stash footprint under the learned decisions.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch import codecs, configs, policies, resolve_device
from repro_torch import obs as obs_mod
from repro_torch.configs.base import reduced
from repro_torch.data import synthetic
from repro_torch.launch.args import (container_name, policy_name,
                                     prefix_zeros)
from repro_torch.models.model import DecoderModel
from repro_torch.optim import adamw
from repro_torch.optim.schedule import Schedule
from repro_torch.train import loop as loop_mod
from repro_torch.train import step as step_mod

REPORT_KEYS = ("step", "loss", "xent", "qm_act_mean", "qm_w_mean",
               "qe_act_mean", "qe_w_mean", "bc_bits", "bw_man_bits",
               "bw_exp_bits", "step_time_s")
# An MoE model's report adds its routing metrics (JAX's step reports them
# for every model, zeros when dense; its launcher prints neither).
MOE_REPORT_KEYS = ("moe_lb_loss", "moe_drop_frac")


def build_policy(args) -> policies.Policy:
    """Resolve --policy, each '+'-part with its own flags (QE has its own
    knobs: the exponent field is smaller, and flushing a binade is harsher
    than dropping a mantissa bit), composed once. The composite carries
    ``--container`` too: the model stashes in ``policy.container``."""
    per_sub = {
        "qm": dict(gamma=args.gamma, lr=args.qm_lr,
                   init_bits=args.qm_init_bits),
        "qe": dict(gamma=args.qe_gamma, lr=args.qe_lr),
    }
    parts = policies.validate_name(args.policy)
    subs = [policies.get(part, container=args.container,
                         **per_sub.get(part, {})) for part in parts]
    return (subs[0] if len(subs) == 1 else policies.CompositePolicy(
        policies=tuple(subs), container=args.container))


def build(args):
    cfg = configs.get(args.arch)
    if args.preset == "tiny":
        cfg = reduced(cfg)
        batch, seq = 8, 64
    elif args.preset == "small":
        cfg = reduced(cfg, n_layers=max(2 * len(cfg.period), 4), d_model=256)
        batch, seq = 8, 128
    else:
        batch, seq = args.batch, args.seq
    model = DecoderModel(cfg, build_policy(args),
                         device=resolve_device(args.device))
    tc = step_mod.TrainConfig(
        opt=adamw.AdamWConfig(lr=args.lr),
        schedule=Schedule(kind="cosine", base_lr=args.lr,
                          warmup_steps=min(50, args.steps // 10),
                          total_steps=args.steps),
        num_microbatches=args.microbatches,
        grad_compress_bits=args.grad_compress_bits)
    return cfg, model, tc, batch, seq


def run_per_layer(model, tc, state, batches, lc, refresh: int,
                  make_step=step_mod.make_train_step, log=print):
    """The loop in segments of ``refresh`` steps: at each boundary the
    per-layer stash plan is re-derived from the live policy state, and the
    model and its step are rebuilt only when the plan changed (printing
    it). The segments append to one metrics file and share ``lc``'s
    checkpointing: as in the JAX launcher, each segment's ``loop.run``
    starts by restoring the latest checkpoint (the one the previous
    segment's final save wrote). ``make_step(model, tc)``
    builds each plan's step. Returns (the loop's result over all steps,
    the final model, [(step, plan), ...] of every plan put in force)."""
    plan, plans, history, res = None, [], [], None
    while state.step < lc.total_steps:
        new_plan = model.stash_plan(state.pstate)
        if new_plan != plan:
            plan = new_plan
            log(f"[train] per-layer stash plan @ step {state.step}: "
                f"{','.join(plan)}")
            plans.append((state.step, plan))
            model = DecoderModel(model.cfg, model.policy, device=model.device,
                                 stash_containers=plan)
            train_step = make_step(model, tc)
        seg = dataclasses.replace(
            lc, total_steps=min(state.step + refresh, lc.total_steps),
            metrics_truncate=res is None)
        res = loop_mod.run(train_step, state, batches, seg,
                           device=model.device)
        state = res.state
        history.extend(res.history)
    log(f"[train] final per-layer stash plan: {','.join(plan)}")
    return (dataclasses.replace(res, state=state, history=history), model,
            plans)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="tiny",
                    choices=["tiny", "small", "full"])
    ap.add_argument("--policy", default="qm", metavar="NAME[+NAME...]",
                    type=policy_name,
                    help=f"precision policy ({'/'.join(policies.names())}), "
                         f"composable with '+', e.g. qm+qe")
    ap.add_argument("--container", default="bit_exact", type=container_name,
                    help=f"stash codec ({'/'.join(codecs.names())}) or a "
                         f"dense geometry like sfp-m2e4")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--gamma", type=float, default=0.05,
                    help="QM footprint-penalty strength (eq. 7)")
    ap.add_argument("--qm-init-bits", type=float, default=7.0)
    ap.add_argument("--qm-lr", type=float, default=0.05)
    ap.add_argument("--qe-gamma", type=float, default=0.05,
                    help="QE footprint-penalty strength")
    ap.add_argument("--qe-lr", type=float, default=0.05)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress-bits", type=int, default=None,
                    help="compress the gradients to this many mantissa bits "
                         "(bit_exact wire) with error feedback")
    ap.add_argument("--per-layer-stash", action="store_true",
                    help="pack each period's stash in its own dense "
                         "container from the policy's per-layer decisions "
                         "(model.stash_plan); the plan is re-derived every "
                         "--stash-refresh steps and the model rebuilt when "
                         "it changes")
    ap.add_argument("--stash-refresh", type=int, default=None,
                    help="steps between per-layer stash plan refreshes "
                         "(default: --ckpt-every)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--metrics", default=None,
                    help="per-step metrics JSONL (the obs event stream)")
    ap.add_argument("--metrics-out", default=None,
                    help="write Prometheus-text metrics (step-time "
                         "histogram, failure counters) here at exit")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace_event JSON of train-step "
                         "spans here at exit (opens in Perfetto)")
    ap.add_argument("--timeline-out", default=None,
                    help="stream the per-layer precision timeline "
                         "(JSONL; one entry per --timeline-every steps)")
    ap.add_argument("--timeline-every", type=int, default=10)
    ap.add_argument("--profile-steps", type=int, default=None, metavar="N",
                    help="bracket torch.profiler around N steps (starting at "
                         "--profile-start), print device time by kernel and "
                         "write a Chrome trace under --profile-dir")
    ap.add_argument("--profile-start", type=int, default=1)
    ap.add_argument("--profile-dir", default="experiments/traces/train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                    "path on the CPU)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg, model, tc, batch, seq = build(args)
    state = step_mod.init_state(model, args.seed, tc)
    n_params = model.param_count()
    print(f"arch={cfg.name} params~{n_params / 1e6:.1f}M "
          f"policy={model.policy.name} container={args.container} "
          f"device={model.device}")
    dcfg = synthetic.SyntheticConfig(vocab=cfg.vocab, seq_len=seq,
                                     global_batch=batch, seed=args.seed)

    cond = prefix_zeros(cfg, batch, model.device)

    def batches(start):
        for b in synthetic.batches(dcfg, start):
            out = {k: torch.from_numpy(v).long().to(model.device)
                   for k, v in b.items()}
            if cond is not None:    # a prefix-LM's stub frontend: zeros
                out["cond_embeddings"] = cond
            yield out

    def ckpt_extra(state):
        # The policy's current decision beside the run's identity:
        # policy-aware serving (serve/precision.py) derives the KV pool's
        # geometry from these bitlengths through read_extra, without
        # restoring any state.
        d = model.policy.decision_summary(state.pstate, model.dims)
        return {"policy": model.policy.name, "container": args.container,
                "decision": {"man_bits": float(d["man_bits"]),
                             "exp_bits": float(d["exp_bits"])}}

    obs = obs_mod.Obs(metrics_path=args.metrics_out,
                      trace_path=args.trace_out,
                      timeline_path=args.timeline_out)

    def timeline_fn(state):
        # Late-binds `model`, as the JAX launcher does (the per-layer
        # segments rebuild it around the same policy and dims).
        return model.policy.layer_decisions(state.pstate, model.dims)

    lc = loop_mod.LoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, metrics_file=args.metrics,
        log_every=max(1, args.steps // 50), ckpt_extra=ckpt_extra,
        obs=obs, timeline_fn=timeline_fn,
        timeline_every=args.timeline_every,
        profile_steps=(None if args.profile_steps is None
                       else (args.profile_start, args.profile_steps)),
        profile_dir=args.profile_dir)
    plans = None
    if args.per_layer_stash:
        refresh = max(1, args.stash_refresh or args.ckpt_every)
        res, model, plans = run_per_layer(model, tc, state, batches, lc,
                                          refresh)
    else:
        res = loop_mod.run(step_mod.make_train_step(model, tc), state,
                           batches, lc, device=model.device)
    if res.profile is not None:
        print("profile " + json.dumps(res.profile))
    last = res.history[-1]
    keys = REPORT_KEYS + (MOE_REPORT_KEYS if cfg.is_moe else ())
    print(json.dumps({k: last[k] for k in keys if k in last}, indent=2))
    fp = policies.modeled_footprint(model.policy, res.state.pstate,
                                    model.dims)
    print("footprint " + json.dumps({k: round(v, 4) for k, v in fp.items()}))
    obs.close()  # writes --metrics-out / --trace-out, closes the timeline
    return {"history": res.history, "footprint": fp, "state": res.state,
            "profile": res.profile, "plans": plans,
            "restarts": res.restarts}


if __name__ == "__main__":
    main()
