"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name, power limit) and builds the CUDA
   kernels from ``src/repro_torch/csrc``.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, and times both.
3. Serves gemma2-2b at full width (random weights from a seed, batch 4,
   1024-token prompts, 64 new tokens, sfp8 KV cache) through
   ``serve.engine.generate``; checks by the wrappers' launch counters that
   the run went through every kernel; repeats it on the plain path and
   compares logits and greedy tokens.

Any failure exits non-zero. The last line is the device JSON.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): device memory rate and bf16
# tensor-core rate, used for the least time the card could take.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
# ~12 ms of device sleep at ~1.7 GHz: longer than the host takes to
# enqueue the slowest timed function (the plain decode's block loop).
SLEEP_CYCLES = 20_000_000

# Kernel vs plain on the card. Both sides compute in f32 from identical
# bf16 (or packed) inputs and round the result to bf16 once; they differ
# in summation order and exp/tanh rounding (~1e-6 relative), which can
# flip the final bf16 rounding by one ulp (2^-8 relative): |d| <= 2^-7
# |plain| + 1e-3.
KERNEL_RTOL, KERNEL_ATOL = 2 ** -7, 1e-3
# End to end, kernel path vs plain path: those one-ulp flips in 26 layers'
# attention outputs ride the residual stream into the 2304-wide tied
# unembedding (bf16, softcapped at 30). Held to max 1.0 and mean 0.1 on
# the prefill logits; greedy streams must agree up to a first difference
# that falls where the plain run's top-2 margin is below twice the max.
E2E_MAX, E2E_MEAN = 1.0, 0.1

B, PROMPT, MAX_NEW, CONTAINER, SEED = 4, 1024, 64, "sfp8", 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, *, reps: int, flush=None) -> float:
    """Mean device time of ``fn`` in ms by CUDA events, after a warm-up.
    ``flush`` (a large tensor) is overwritten before each launch so every
    launch finds its inputs out of L2, as in the serving loop. A device
    sleep queued ahead of the start event keeps the card busy while the
    host enqueues ``fn``, so host overhead stays out of the window."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def check_close(torch, name, got, want):
    err = (got.float() - want.float()).abs()
    lim = KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite kernel output")
    if (err > lim).any():
        fail(f"{name}: {(err > lim).sum().item()} elements off, max abs "
             f"error {err.max().item():.3e}")
    return err.max().item()


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")

    from repro_torch import configs
    from repro_torch.codecs import fields_for
    from repro_torch.kernels import _lib, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import packed_flash_decode as pfd
    from repro_torch.kernels import sfp_pack as sp
    from repro_torch.models.model import DecoderModel
    from repro_torch.serve import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _lib.load()
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_lib.build_seconds:.2f} s)")
    for line in _lib.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")

    cfg = configs.get("gemma2-2b")
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    rep, D = H // KH, KH * hd
    L = PROMPT + MAX_NEW
    L = -(-L // ops.DECODE_BLOCK_L) * ops.DECODE_BLOCK_L          # 1152
    G = D // ref.GROUP
    fields = fields_for(CONTAINER, torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    results = {}

    # -- sfp_pack at the prefill cache shape --------------------------------
    x = torch.randn((B, L, D), generator=gen, device=dev)
    x = x * torch.exp2(torch.randint(-40, 40, x.shape, generator=gen,
                                     device=dev).float())
    r = torch.rand(x.shape, generator=gen, device=dev)
    x = torch.where(r < 0.05, torch.zeros_like(x), x)
    x = torch.where((r >= 0.05) & (r < 0.08), x.sign() * 1e-39, x)
    x = x.to(torch.bfloat16)
    rows = x.reshape(-1, ref.GROUP)
    kp, kb = sp.sfp_pack(rows, fields)
    pp, pb = sp.plain(rows, fields)
    torch.cuda.synchronize()
    if not (torch.equal(kp, pp) and torch.equal(kb, pb)):
        fail("sfp_pack: kernel bytes differ from the plain version")
    n = rows.numel()
    results["sfp_pack"] = dict(
        replaces="src/repro/kernels/sfp_pack.py:155",
        source="src/repro_torch/csrc/sfp_pack.cu", max_abs_err=0.0,
        ms=time_ms(torch, lambda: sp.sfp_pack(rows, fields), reps=20,
                   flush=flush),
        plain_ms=time_ms(torch, lambda: sp.plain(rows, fields), reps=5,
                         flush=flush),
        bound_ms=(n * 2 + n * 1 + n // ref.GROUP) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None)

    # -- flash_attention at the prefill shape (GQA folded) ------------------
    q = torch.randn((B, PROMPT, H, hd), generator=gen, device=dev) * 4
    k = torch.randn((B, PROMPT, KH, hd), generator=gen, device=dev)
    v = torch.randn((B, PROMPT, KH, hd), generator=gen, device=dev)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    qf = q.reshape(B, PROMPT, KH, rep, hd).transpose(2, 3).reshape(
        B, PROMPT * rep, KH, hd).contiguous()
    fa_err = 0.0
    for window in (None, 256):
        kw = dict(causal=True, window=window, softcap=cfg.attn_softcap,
                  q_rep=rep)
        got = fa.flash_attention(qf, k, v, **kw)
        want = fa.plain(qf, k, v, **kw)
        torch.cuda.synchronize()
        fa_err = max(fa_err, check_close(torch, f"flash_attention "
                                         f"window={window}", got, want))
    kw = dict(causal=True, window=None, softcap=cfg.attn_softcap, q_rep=rep)
    pairs = PROMPT * (PROMPT + 1) // 2
    fa_ops = 2 * 2 * B * H * hd * pairs
    fa_bytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
    qs = q.transpose(1, 2)
    ks, vs = (t.repeat_interleave(rep, dim=2).transpose(1, 2) for t in (k, v))
    sdpa_ms = time_ms(torch, lambda: torch.nn.functional
                      .scaled_dot_product_attention(qs, ks, vs,
                                                    is_causal=True), reps=10)
    results["flash_attention"] = dict(
        replaces="src/repro/kernels/flash_attention.py:120",
        source="src/repro_torch/csrc/flash_attention.cu", max_abs_err=fa_err,
        ms=time_ms(torch, lambda: fa.flash_attention(qf, k, v, **kw), reps=10),
        plain_ms=time_ms(torch, lambda: fa.plain(qf, k, v, **kw), reps=3),
        bound_ms=max(fa_ops / BF16_OPS_PER_S, fa_bytes / HBM_BYTES_PER_S)
        * 1e3,
        bound_by="operations" if fa_ops / BF16_OPS_PER_S
        > fa_bytes / HBM_BYTES_PER_S else "bytes",
        library_ms=None,
        note=f"scaled_dot_product_attention without softcap (a different "
             f"function) took {sdpa_ms:.4f} ms")

    # -- packed_flash_decode at the decode shape ----------------------------
    kc = torch.randn((B, L, D), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((B, L, D), generator=gen, device=dev).to(torch.bfloat16)
    kpk, vpk = ops.sfp_compress_nd(kc, fields), ops.sfp_compress_nd(vc, fields)
    qd = (torch.randn((B, 1, H, hd), generator=gen, device=dev) * 4).to(
        torch.bfloat16)
    pos_global = torch.tensor([L - 1, 1100, 1087, 600], dtype=torch.int32,
                              device=dev)
    pos_ring = torch.tensor([3000, 1500, 777, 2047], dtype=torch.int32,
                            device=dev)
    args = (qd, kpk.payload, kpk.bases, vpk.payload, vpk.bases)
    pd_err = 0.0
    for window, pos in ((None, pos_global), (512, pos_ring)):
        kw = dict(window=window, softcap=cfg.attn_softcap)
        got = pfd.packed_flash_decode(*args, pos, fields, **kw)
        want = pfd.plain(*args, pos, fields, **kw)
        torch.cuda.synchronize()
        pd_err = max(pd_err, check_close(
            torch, f"packed_flash_decode window={window}", got, want))
    kw = dict(window=None, softcap=cfg.attn_softcap)
    live = sum(min(int(p) + 1, L) for p in pos_global.tolist())
    pd_bytes = live * 2 * (D + G) + 2 * qd.numel() * 2
    results["packed_flash_decode"] = dict(
        replaces="src/repro/kernels/packed_flash_decode.py:196",
        source="src/repro_torch/csrc/packed_flash_decode.cu",
        max_abs_err=pd_err,
        ms=time_ms(torch, lambda: pfd.packed_flash_decode(
            *args, pos_global, fields, **kw), reps=50, flush=flush),
        plain_ms=time_ms(torch, lambda: pfd.plain(*args, pos_global, fields,
                                                  **kw), reps=5, flush=flush),
        bound_ms=max(pd_bytes / HBM_BYTES_PER_S,
                     2 * 2 * H * hd * live / BF16_OPS_PER_S) * 1e3,
        bound_by="bytes", library_ms=None)
    del x, rows, kp, kb, pp, pb, q, k, v, qf, qs, ks, vs, kc, vc, kpk, vpk
    torch.cuda.empty_cache()

    # -- end to end: gemma2-2b, full width ----------------------------------
    model = DecoderModel(cfg, kv_container=CONTAINER, device=dev)
    params = model.init(SEED)
    prompt = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                           device=dev)
    engine.generate(model, params, prompt[:, :64], 2)      # warm-up
    counters = (sp.sfp_pack, fa.flash_attention, pfd.packed_flash_decode)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate(model, params, prompt, MAX_NEW)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    n_layers, steps = cfg.n_layers, MAX_NEW - 1
    expect = {"flash_attention": n_layers,
              "packed_flash_decode": n_layers * steps,
              "sfp_pack": 2 * n_layers * (1 + steps)}
    if launches != expect:
        fail(f"launch counts {launches} != expected {expect}")
    toks = res.tokens
    if toks.shape != (B, MAX_NEW) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        fail(f"bad tokens {tuple(toks.shape)}")
    if not torch.isfinite(res.prefill_logits).all():
        fail("non-finite prefill logits")
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.inference_mode():
            model.prefill(params, prompt, PROMPT + MAX_NEW)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t1)
    prefill_ms = sorted(pre)[1] * 1e3
    decode_ms = (total_s * 1e3 - prefill_ms) / steps
    for c in counters:  # the timing prefills above are not the main path
        c.launches = 0

    ops.force_backend("plain")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_res = engine.generate(model, params, prompt, MAX_NEW)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        ops.force_backend(None)
    if any(c.launches for c in counters):
        fail("the plain run launched a kernel")
    d = (res.prefill_logits - plain_res.prefill_logits).abs()
    if d.max().item() > E2E_MAX or d.mean().item() > E2E_MEAN:
        fail(f"prefill logits: max {d.max().item():.4f} mean "
             f"{d.mean().item():.4f} over {E2E_MAX}/{E2E_MEAN}")
    # Each row's stream must equal the plain run's up to its first
    # difference, and that difference may only come where the plain run's
    # top-2 margin is below twice the logit tolerance (a near tie).
    margins = plain_res.margins.cpu()
    diff = (toks != plain_res.tokens).cpu()
    agree = []
    for b in range(B):
        idx = torch.nonzero(diff[b]).flatten()
        t = int(idx[0]) if len(idx) else MAX_NEW
        if t < MAX_NEW and margins[b, t] >= 2 * E2E_MAX:
            fail(f"row {b}: token {t} differs from the plain run with "
                 f"margin {margins[b, t].item():.3f}")
        agree.append(t)
    same = (toks.cpu() == plain_res.tokens.cpu()).float().mean().item()
    e2e = {"arch": cfg.name, "batch": B, "prompt": PROMPT,
           "max_new": MAX_NEW, "kv": CONTAINER, "card": card,
           "total_s": total_s, "prefill_ms": prefill_ms,
           "decode_ms_per_step": decode_ms,
           "tok_per_s": B * MAX_NEW / total_s, "plain_total_s": plain_s,
           "prefill_logit_max_diff": d.max().item(),
           "prefill_logit_mean_diff": d.mean().item(),
           "tokens_equal_before_first_difference": agree,
           "token_agreement": same, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("e2e: " + json.dumps(e2e))

    kernels = []
    for name in ("sfp_pack", "flash_attention", "packed_flash_decode"):
        r = results[name]
        kernels.append(dict(name=name, route="cuda", source=r["source"],
                            replaces=r["replaces"], launches=launches[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"],
                            **({"note": r["note"]} if "note" in r else {})))
    for r in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(r[key]):
                fail(f"{r['name']}: {key} is not finite")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
