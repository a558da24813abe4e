"""Serving launcher: batch mode, or a continuous-batching request trace
over the paged packed-KV engine.

Batch mode (one prefill + one greedy decode loop):

  python -m repro_torch.launch.serve --arch gemma2-2b --preset full \
      --batch 4 --prompt-len 1024 --max-new 64 --kv-container sfp8

``--kv-container`` takes any registry codec: sfp8, sfp16 or a dense
bit-plane geometry such as sfp-m2e4 (read by the fused decode kernel),
or gecko8 and bit_exact (the cache is unpacked whole every step).

Trace mode drives Poisson arrivals with mixed prompt and output lengths
through the scheduler's admission, continuous batching and preemption on a
virtual clock, with bursts (``--burst K``) or self-speculation
(``--speculate K``):

  python -m repro_torch.launch.serve --arch gemma2-2b --preset tiny \
      --trace --requests 16 --kv-container sfp8 --max-slots 8 \
      --max-len 256 --device cpu

The fault-tolerance flags are those of the JAX launcher: deadlines
(``--deadline``, a TTL after arrival), a bounded queue with shedding
(``--max-pending``), seeded chaos (``--inject-flip-p``,
``--inject-alloc-p``), the preemption-storm guard (``--storm-guard``) and
the pressure downshift (``--degraded-container`` with
``--pressure-low``/``--pressure-high``); ``--flood`` lands every request
at once. ``--policy-ckpt`` at a training run's checkpoint directory
derives the KV container from the decision stamped in its manifest (see
``serve/precision.py``), overriding ``--kv-container``.

Runs on CUDA; ``--device cpu`` runs the plain PyTorch path on the CPU.
Weights are random, drawn from ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch import obs as obs_mod
from repro_torch.configs.base import reduced
from repro_torch.kernels.ref import GROUP
from repro_torch.launch.args import container_name, prefix_zeros
from repro_torch.models.model import DecoderModel
from repro_torch.serve import engine, faults, precision
from repro_torch.serve.scheduler import Request, Scheduler


def build_model(args):
    cfg = configs.get(args.arch)
    if args.preset == "tiny":
        cfg = reduced(cfg)
    elif args.preset == "small":
        cfg = reduced(cfg, n_layers=max(2 * len(cfg.period), 4), d_model=256)
    if args.preset != "full" and getattr(args, "trace", False):
        cfg = paged_heads(cfg)
    container = args.kv_container
    if args.policy_ckpt:
        container = precision.container_from_checkpoint(args.policy_ckpt)
        print(f"policy-aware container from {args.policy_ckpt}: {container}")
    model = DecoderModel(cfg, kv_container=container,
                         device=resolve_device(args.device))
    return cfg, model, model.init(args.seed)


def paged_heads(cfg):
    """``cfg``, or a cut whose KV rows do not fill a whole 128-lane group
    (mamba2's and recurrentgemma's: one KV head of 64 or 32 lanes) with
    its KV heads widened to fill one: the paged pool and the packed rings
    store whole groups (the JAX launcher's cut fails its lane assert)."""
    D = cfg.n_kv_heads * cfg.head_dim_
    if D % GROUP == 0 or GROUP % cfg.n_kv_heads:
        return cfg
    return dataclasses.replace(cfg, head_dim=GROUP // cfg.n_kv_heads)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_summary(prof, wall: float, top: int) -> dict:
    """Device time by kernel of a finished ``torch.profiler`` capture and
    the device's busy share of the ``wall`` seconds it covered."""
    # Self device time of the device-side entries is the kernels' own time
    # (one stream: no overlap); the CPU ops that launched them report the
    # same time again, so they are left out.
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / (wall * 1e3),
            "top_kernels": [{"name": k[:80], "device_ms": t / 1e3,
                             "count": c} for k, t, c in rows[:top]]}


def _profiler():
    from torch.profiler import ProfilerActivity
    return torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def profile(model, params, prompt, max_new: int, top: int,
            cond=None) -> dict:
    """Run ``generate`` under torch.profiler (one device, CUDA only)."""
    _sync(model.device)
    t0 = time.perf_counter()
    with _profiler() as prof:
        engine.generate(model, params, prompt, max_new=max_new,
                        cond_embeddings=cond)
        _sync(model.device)
    return profile_summary(prof, time.perf_counter() - t0, top)


def run_batch(args) -> dict:
    cfg, model, params = build_model(args)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=model.device)
    cond = prefix_zeros(cfg, args.batch, model.device)
    if args.profile:
        engine.generate(model, params, prompt, max_new=2,     # warm-up
                        cond_embeddings=cond)
        print(json.dumps(profile(model, params, prompt, args.max_new,
                                 args.profile, cond)))
    _sync(model.device)
    t0 = time.perf_counter()
    res = engine.generate(model, params, prompt, max_new=args.max_new,
                          cond_embeddings=cond)
    _sync(model.device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    report = {"arch": cfg.name, "kv": model.kv_container or "raw",
              "device": str(model.device), "tokens": toks,
              "seconds": dt, "tok_per_s": toks / dt,
              "sample": res.tokens[0].tolist()}
    if model.device.type == "cuda":
        report["gpu"] = torch.cuda.get_device_name(model.device)
    print(json.dumps(report))
    return report


def make_trace(args, vocab: int):
    """Poisson arrivals (exponential gaps at --arrival-rate req/s) with
    prompt/output lengths drawn uniformly from the given ranges: the JAX
    launcher's draws from the same seed. ``--flood`` lands every request
    at t=0; ``--deadline`` stamps each with arrival + TTL."""
    rng = np.random.RandomState(args.seed + 2)
    lo_p, hi_p = args.prompt_len_min, args.prompt_len_max
    lo_n, hi_n = args.max_new_min, args.max_new_max
    t = 0.0
    reqs = []
    for i in range(args.requests):
        if not getattr(args, "flood", False):
            t += rng.exponential(1.0 / args.arrival_rate)
        reqs.append(Request(
            uid=i,
            prompt=rng.randint(0, vocab,
                               size=rng.randint(lo_p, hi_p + 1)
                               ).astype(np.int32),
            max_new=int(rng.randint(lo_n, hi_n + 1)),
            arrival=t,
            deadline=(t + args.deadline if getattr(args, "deadline", None)
                      else None)))
    return reqs


def run_trace(args) -> dict:
    cfg, model, params = build_model(args)
    container = model.kv_container
    if container is None:
        raise SystemExit("--trace needs a packed cache: pass --kv-container "
                         "(or --policy-ckpt)")
    if cfg.prefix_tokens:
        raise SystemExit(f"--trace: {cfg.name} is a prefix-LM, which the "
                         f"paged engine does not serve (as in the JAX "
                         f"package); use batch mode")
    eng = engine.PagedEngine(model, params, max_slots=args.max_slots,
                             max_len=args.max_len,
                             num_blocks=args.num_blocks,
                             degraded_container=args.degraded_container,
                             integrity=not args.no_integrity)
    reqs = make_trace(args, cfg.vocab)
    # Time to first token in scheduler decode steps, per request.
    ttft = {}
    pressure = None
    if args.degraded_container:
        pressure = precision.PressureController(low=args.pressure_low,
                                                high=args.pressure_high)
    obs = obs_mod.Obs(metrics_path=args.metrics_out,
                      events_path=args.events_out,
                      trace_path=args.trace_out,
                      timeline_path=args.timeline_out)
    sched = Scheduler(eng, on_token=lambda uid, tok, done:
                      ttft.setdefault(uid, sched.stats.decode_steps),
                      max_pending=args.max_pending,
                      storm_guard=args.storm_guard,
                      pressure=pressure, obs=obs)
    hook = None
    if args.inject_flip_p or args.inject_alloc_p:
        hook = faults.FaultInjector(eng, seed=args.fault_seed,
                                    p_flip=args.inject_flip_p,
                                    p_alloc_fail=args.inject_alloc_p)
    # --profile-steps N brackets torch.profiler around scheduler steps
    # [1, 1+N): step 0 is left out, so the capture skips the kernel build.
    prof = {"p": None, "t0": 0.0, "summary": None}

    def stop_profile():
        _sync(model.device)
        prof["p"].stop()
        wall = time.perf_counter() - prof["t0"]
        prof["summary"] = profile_summary(prof["p"], wall, 15)
        Path(args.profile_dir).mkdir(parents=True, exist_ok=True)
        prof["p"].export_chrome_trace(
            str(Path(args.profile_dir) / "serve_trace.json"))
        prof["p"] = None

    def step_hook(i):
        if args.profile_steps:
            if prof["p"] is None and prof["summary"] is None and i == 1:
                _sync(model.device)
                prof["p"] = _profiler()
                prof["p"].start()
                prof["t0"] = time.perf_counter()
            elif prof["p"] is not None and i >= 1 + args.profile_steps:
                stop_profile()
        if hook is not None:
            hook(i)

    # Virtual clock: admission sees arrivals in step time (one scheduler
    # step advances it by --step-dt), so the trace replays identically on
    # any hardware.
    clock = {"t": 0.0}

    def now():
        clock["t"] += args.step_dt
        return clock["t"]

    t0 = time.time()
    try:
        out = sched.run(reqs, now_fn=now, burst=args.burst,
                        fault_hook=step_hook, speculate=args.speculate,
                        draft_planes=args.draft_planes)
        _sync(model.device)
    finally:
        if prof["p"] is not None:
            stop_profile()
    dt = time.time() - t0
    if prof["summary"] is not None:
        print("profile " + json.dumps(prof["summary"]))
    total = int(sum(len(v) for v in out.values()))
    s = sched.stats
    pool = eng.pool.stats()
    n = max(1, len(reqs))
    report = {
        "arch": cfg.name, "container": container,
        "device": str(model.device),
        "requests": len(reqs), "emitted_tokens": total,
        "wall_s": round(dt, 2), "tok_per_s": round(total / max(dt, 1e-9), 1),
        "decode_steps": s.decode_steps,
        "mean_batch_occupancy": round(total / max(s.decode_steps, 1), 2),
        "preemptions": s.preemptions,
        "mean_ttft_steps": round(float(np.mean(list(ttft.values()))), 2)
        if ttft else None,
        # Wall-clock latency percentiles from the obs histograms
        # (bucket resolution: log-spaced bounds, see obs/registry.py).
        "ttft_s_p50": round(sched._h_ttft.percentile(0.50), 6),
        "ttft_s_p95": round(sched._h_ttft.percentile(0.95), 6),
        "ttft_s_p99": round(sched._h_ttft.percentile(0.99), 6),
        "token_latency_s_p50": round(sched._h_tok.percentile(0.50), 6),
        "token_latency_s_p95": round(sched._h_tok.percentile(0.95), 6),
        "token_latency_s_p99": round(sched._h_tok.percentile(0.99), 6),
        "pool_blocks": pool.num_blocks, "pool_peak_used": pool.peak_used,
        "block_l": eng.block_l, "max_slots": eng.max_slots,
        "max_len": eng.max_len,
        # fault-tolerance layer
        "finished_ok": s.finished,
        "deadline_miss_pct": round(100.0 * s.deadline_misses / n, 1),
        "shed_pct": round(100.0 * s.shed / n, 1),
        "cancelled": s.cancelled, "failed": s.failed,
        "recoveries": s.recoveries, "corrupt_blocks": s.corrupt_blocks,
        "nan_guard_trips": s.nan_guard_trips,
        "alloc_failures": s.alloc_failures,
        "downshifted": s.downshifted,
        "quarantined_blocks": pool.quarantined,
        "injected_faults": hook.counts() if hook else {},
    }
    if model.device.type == "cuda":
        report["gpu"] = torch.cuda.get_device_name(model.device)
    if args.speculate:
        report["speculate"] = args.speculate
        report["draft_planes"] = (args.draft_planes if args.draft_planes
                                  is not None
                                  else eng.default_draft_planes())
        report["spec_rounds"] = s.spec_rounds
        report["drafted"] = s.drafted
        report["draft_accepted"] = s.draft_accepted
        report["draft_rejected"] = s.draft_rejected
        report["acceptance_rate"] = round(
            s.draft_accepted / max(1, s.drafted), 3)
    obs.close()  # writes --metrics-out / --trace-out, closes streams
    if args.tokens_out:
        # Per-request emitted streams, for identity diffs across runs
        # (e.g. --speculate K streams against --burst 1 streams).
        Path(args.tokens_out).write_text(json.dumps(
            {int(uid): [int(t) for t in toks] for uid, toks in out.items()},
            sort_keys=True))
    print(json.dumps(report, indent=2))
    return report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="tiny",
                    choices=["tiny", "small", "full"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-container", default=None, type=container_name,
                    help="registry codec for the packed KV cache (sfp8, "
                    "sfp16, a dense geometry such as sfp-m2e4, gecko8 or "
                    "bit_exact); None = raw bf16 cache")
    ap.add_argument("--policy-ckpt", default=None,
                    help="checkpoint dir of a trained policy run; the KV "
                    "container geometry is derived from its stamped "
                    "PrecisionDecision (overrides --kv-container)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                    "path on the CPU)")
    # batch mode
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--profile", type=int, default=0, metavar="TOP",
                    help="first run generate under torch.profiler and print "
                    "the TOP kernels by device time and the busy share")
    # trace mode (continuous batching over the paged pool)
    ap.add_argument("--trace", action="store_true",
                    help="simulate a Poisson request trace through the "
                    "paged engine + scheduler")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="mean request arrivals per virtual second")
    ap.add_argument("--step-dt", type=float, default=0.1,
                    help="virtual seconds one scheduler step advances")
    ap.add_argument("--prompt-len-min", type=int, default=8)
    ap.add_argument("--prompt-len-max", type=int, default=48)
    ap.add_argument("--max-new-min", type=int, default=4)
    ap.add_argument("--max-new-max", type=int, default=24)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="pool capacity in packed blocks (default: full "
                    "residency for every slot)")
    ap.add_argument("--burst", type=int, default=1,
                    help="decode tokens per scheduler step")
    ap.add_argument("--speculate", type=int, default=None, metavar="K",
                    help="self-speculative decoding: K draft steps at "
                    "prefix-precision reads + K full-width verify steps per "
                    "scheduler step (token-identical to --burst 1)")
    ap.add_argument("--draft-planes", type=int, default=None,
                    help="leading payload bits the draft decodes (default: "
                    "max(payload width - 1, delta-exponent bits + 2))")
    ap.add_argument("--tokens-out", default=None,
                    help="write the per-request emitted token streams "
                    "(JSON uid -> tokens) for identity diffs across runs")
    # fault tolerance / chaos
    ap.add_argument("--flood", action="store_true",
                    help="collapse every trace arrival to t=0")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request TTL in virtual seconds after arrival")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="bounded admission queue: arrived requests beyond "
                    "this are explicitly shed")
    ap.add_argument("--storm-guard", action="store_true",
                    help="reserve running slots' growth blocks at "
                    "admission (no preemption thrash)")
    ap.add_argument("--no-integrity", action="store_true",
                    help="disable per-block checksum verification")
    ap.add_argument("--degraded-container", default=None,
                    type=container_name,
                    help="narrower geometry for pressure-downshifted "
                    "admissions (enables the pressure controller)")
    ap.add_argument("--pressure-low", type=float, default=0.25,
                    help="degrade when free pool bytes fall below this "
                    "fraction of capacity")
    ap.add_argument("--pressure-high", type=float, default=0.5,
                    help="restore once free bytes recover above this "
                    "fraction")
    ap.add_argument("--inject-flip-p", type=float, default=0.0,
                    help="per-step probability of a seeded bit flip in an "
                    "allocated packed block")
    ap.add_argument("--inject-alloc-p", type=float, default=0.0,
                    help="per-step probability of arming one transient "
                    "admission alloc failure")
    ap.add_argument("--fault-seed", type=int, default=0)
    # observability (repro_torch.obs)
    ap.add_argument("--metrics-out", default=None,
                    help="write Prometheus-text metrics here at exit "
                    "(counters + TTFT/latency histograms)")
    ap.add_argument("--events-out", default=None,
                    help="structured-event JSONL (quarantine/scrub/"
                    "corruption lifecycle)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace_event JSON of per-request "
                    "span chains here (opens in Perfetto)")
    ap.add_argument("--timeline-out", default=None,
                    help="stream the per-step pool geometry/occupancy/"
                    "pressure timeline (JSONL)")
    ap.add_argument("--profile-steps", type=int, default=None, metavar="N",
                    help="run torch.profiler over N scheduler steps (from "
                    "step 1, past the kernel build); prints a 'profile' "
                    "line of device time by kernel against wall time")
    ap.add_argument("--profile-dir", default="experiments/traces/serve",
                    help="where --profile-steps writes its Chrome trace")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.trace:
        run_trace(args)
    else:
        run_batch(args)


if __name__ == "__main__":
    main()
