"""Serving launcher, batch mode: one prefill + one greedy decode loop.

  python -m repro_torch.launch.serve --arch gemma2-2b --preset full \
      --batch 4 --prompt-len 1024 --max-new 64 --kv-container sfp8

``--kv-container`` takes any registry codec: sfp8, sfp16 or a dense
bit-plane geometry such as sfp-m2e4 (read by the fused decode kernel),
or gecko8 and bit_exact (the cache is unpacked whole every step).

Runs on CUDA; ``--device cpu`` runs the plain PyTorch path on the CPU.
Weights are random, drawn from ``--seed``. The trace (continuous
batching) mode of the JAX launcher is not ported yet.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.configs.base import reduced
from repro_torch.launch.args import container_name
from repro_torch.models.model import DecoderModel
from repro_torch.serve import engine


def build_model(args):
    cfg = configs.get(args.arch)
    if args.preset == "tiny":
        cfg = reduced(cfg)
    elif args.preset == "small":
        cfg = reduced(cfg, n_layers=max(2 * len(cfg.period), 4), d_model=256)
    model = DecoderModel(cfg, kv_container=args.kv_container,
                         device=resolve_device(args.device))
    return cfg, model, model.init(args.seed)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile(model, params, prompt, max_new: int, top: int) -> dict:
    """Run ``generate`` under torch.profiler: device time by kernel and
    the device's busy share of the wall time (one device, CUDA only)."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    _sync(model.device)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        engine.generate(model, params, prompt, max_new=max_new)
        _sync(model.device)
    wall = time.perf_counter() - t0
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


def run_batch(args) -> dict:
    cfg, model, params = build_model(args)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=model.device)
    if args.profile:
        engine.generate(model, params, prompt, max_new=2)    # warm-up
        print(json.dumps(profile(model, params, prompt, args.max_new,
                                 args.profile)))
    _sync(model.device)
    t0 = time.perf_counter()
    res = engine.generate(model, params, prompt, max_new=args.max_new)
    _sync(model.device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    report = {"arch": cfg.name, "kv": args.kv_container or "raw",
              "device": str(model.device), "tokens": toks,
              "seconds": dt, "tok_per_s": toks / dt,
              "sample": res.tokens[0].tolist()}
    if model.device.type == "cuda":
        report["gpu"] = torch.cuda.get_device_name(model.device)
    print(json.dumps(report))
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
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--profile", type=int, default=0, metavar="TOP",
                    help="first run generate under torch.profiler and print "
                    "the TOP kernels by device time and the busy share")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                    "path on the CPU)")
    return ap


def main(argv=None):
    run_batch(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
