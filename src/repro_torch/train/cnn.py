"""CNN training and stash accounting: the paper's Table I mechanism.

A CNN trains with AdamW (lr 1e-2, no weight decay) under one of three
modes: ``none`` (full precision), ``qm`` (Quantum Mantissa, one learned
mantissa bitlength per stash site, §IV-A) or ``bitchop`` (one network-wide
bitlength from the loss-EMA controller, §IV-B). QM's eq. 7 penalty weighs
each site by its share of the stash's values, ``pool`` included (a site
whose bitlength only the penalty moves), and clips through
``policies.base.jclip``: many sites end on the bound 0, where ``jnp.clip``
gives half the gradient. BitChop's registers live on the device; the step
reads ``n`` before observing its own loss.

``stash`` reruns a forward that collects the stashed activations and
``stash_footprint`` prices them bit-exactly (mantissa bits from the
bitlengths, exponents through Gecko, signs elided for ReLU outputs)
against fp32 and bf16.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import torch

from repro_torch import policies, resolve_device
from repro_torch.core import bitchop, footprint
from repro_torch.models import cnn as cnn_mod
from repro_torch.optim import adamw
from repro_torch.policies.base import jclip

MODES = ("none", "qm", "bitchop")
OPT = adamw.AdamWConfig(lr=1e-2, weight_decay=0.0)
GAMMA = 2.0         # QM footprint penalty (eq. 7)
QM_LR = 0.6         # SGD rate of the learned bitlengths
QM_INIT_BITS = 7.0
MAX_BITS = 23       # f32's mantissa: QM's clip and BitChop's full width
BC_WARMUP = 6


class CNNTrainState(NamedTuple):
    params: Dict[str, Any]           # leaves require grad
    opt: adamw.AdamWState
    qm_bits: Dict[str, torch.Tensor]  # site -> f32 0-d leaf (requires grad)
    bc: bitchop.BitChopState
    lam: Dict[str, float]            # site -> share of the stash's values
    gen: torch.Generator             # the forwards' draws
    step: int


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _site_shares(model: cnn_mod.CNN, params) -> Dict[str, float]:
    """Each stash site's share of the values one image stashes."""
    cfg = model.cfg
    probe = torch.zeros((1, cfg.in_ch, cfg.img_size, cfg.img_size),
                        dtype=cfg.compute_dtype, device=model.device)
    with torch.no_grad():
        _, stash = model.forward(params, probe, collect_stash=True)
    numels = {s["name"]: s["tensor"].numel() for s in stash}
    total = sum(numels.values())
    return {k: v / total for k, v in numels.items()}


def _bc_cfg(warmup: int) -> bitchop.BitChopConfig:
    return bitchop.BitChopConfig(warmup_steps=warmup, max_bits=MAX_BITS)


def init_state(model: cnn_mod.CNN, seed: int, params=None
               ) -> CNNTrainState:
    """Parameters from ``seed`` (or ``params``), AdamW moments, QM bits at
    ``QM_INIT_BITS`` on every site, BitChop at its full width, and the
    draws' generator from ``seed + 2``."""
    dev = model.device
    params = model.init(seed) if params is None else params
    for p in adamw.leaves(params):
        p.requires_grad_(True)
    lam = _site_shares(model, params)
    qm_bits = {k: torch.tensor(QM_INIT_BITS, dtype=torch.float32,
                               device=dev, requires_grad=True) for k in lam}
    return CNNTrainState(params=params, opt=adamw.init(params),
                         qm_bits=qm_bits,
                         bc=bitchop.init(_bc_cfg(BC_WARMUP), dev), lam=lam,
                         gen=_generator(dev, seed + 2), step=0)


def make_step(model: cnn_mod.CNN, mode: str,
              bc_warmup: int = BC_WARMUP) -> Callable:
    """``step(state, batch, collect_stash=False) -> (state, metrics)``.

    ``metrics``: the loss (with QM's penalty), ``xent``, ``acc``,
    ``grad_norm`` (pre-clip), ``qm_bits`` (mean over sites) and ``bc_bits``
    (BitChop's n after this step's update, its first ``bc_warmup`` steps
    observe only), as device tensors; with ``collect_stash`` also
    ``stash``, this step's stash entries."""
    if mode not in MODES:
        raise ValueError(f"unknown CNN training mode {mode!r}; "
                         f"one of {MODES}")
    bc_cfg = _bc_cfg(bc_warmup)

    def step(state: CNNTrainState, batch, collect_stash: bool = False):
        params, qm_bits = state.params, state.qm_bits
        act_bits = {"qm": qm_bits, "bitchop": state.bc.n}.get(mode)
        logits, stash = model.forward(params, batch["images"],
                                      act_bits=act_bits, generator=state.gen,
                                      collect_stash=collect_stash)
        labels = batch["labels"]
        logp = torch.log_softmax(logits, dim=-1)
        xent = -torch.gather(logp, 1, labels[:, None]).mean()
        acc = torch.mean((torch.argmax(logits, -1) == labels)
                         .to(torch.float32))
        loss = xent
        sites = list(qm_bits)
        if mode == "qm":
            pen = sum(state.lam[k] * jclip(qm_bits[k], 0.0, MAX_BITS)
                      for k in sites)
            loss = loss + GAMMA * pen
        leaves = adamw.leaves(params)
        wrt = leaves + ([qm_bits[k] for k in sites] if mode == "qm" else [])
        grads = torch.autograd.grad(loss, wrt)
        params, opt, gnorm = adamw.update(list(grads[:len(leaves)]),
                                          state.opt, params, OPT, OPT.lr)
        if mode == "qm":
            with torch.no_grad():
                qm_bits = {
                    k: torch.clamp(qm_bits[k] - QM_LR * g, 0.0,
                                   MAX_BITS).requires_grad_()
                    for k, g in zip(sites, grads[len(leaves):])}
        loss = loss.detach()
        bc = bitchop.update(state.bc, loss, bc_cfg)
        metrics = {"loss": loss, "xent": xent.detach(), "acc": acc,
                   "grad_norm": gnorm,
                   "qm_bits": torch.mean(torch.stack(
                       [v.detach() for v in qm_bits.values()])),
                   "bc_bits": bc.n}
        if collect_stash:
            metrics["stash"] = stash
        return state._replace(params=params, opt=opt, qm_bits=qm_bits,
                              bc=bc, step=state.step + 1), metrics

    return step


def batch_at(cfg: cnn_mod.CNNConfig, seed: int, i: int, n: int,
             device) -> Dict[str, torch.Tensor]:
    """Training batch ``i`` of a run seeded with ``seed``."""
    return cnn_mod.synthetic_images(
        _generator(device, (seed + 1) * 1_000_003 + i), n, cfg, device)


def run(mode: str, steps: int = 80, seed: int = 0,
        cfg: cnn_mod.CNNConfig = cnn_mod.RESNET8, batch: int = 16,
        device: Optional[Union[str, torch.device]] = None
        ) -> Dict[str, Any]:
    """Train ``cfg`` for ``steps`` steps of ``batch`` synthetic images
    under ``mode``; returns the per-step history (loss, acc, mean QM bits,
    BitChop bits), the final parameters and the final bitlengths. The
    weights and images are drawn on the CPU and moved to ``device``, so a
    seed names the same run on every device (a CUDA generator draws other
    numbers); QM's draws come from the device's generator."""
    dev = resolve_device(device)
    pol = policies.get(mode, container="bit_exact")
    model = cnn_mod.CNN(cfg, pol, dev)
    params = _moved(cnn_mod.CNN(cfg, pol, "cpu").init(seed), dev)
    state = init_state(model, seed, params=params)
    step = make_step(model, mode)
    hist: List[Dict[str, float]] = []
    for i in range(steps):
        state, m = step(state, _moved(batch_at(cfg, seed, i, batch, "cpu"),
                                      dev))
        hist.append({"loss": float(m["loss"]), "acc": float(m["acc"]),
                     "qm_bits": float(m["qm_bits"]),
                     "bc_bits": int(m["bc_bits"])})
    final_bits = {k: float(v.detach()) for k, v in state.qm_bits.items()}
    return {"history": hist,
            "params": {k: _detached(v) for k, v in state.params.items()},
            "final_qm_bits": sum(final_bits.values()) / len(final_bits),
            "final_qm_bits_per_layer": final_bits,
            "final_bc_bits": int(state.bc.n)}


def _moved(tree, device):
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    return tree.to(device)


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def stash(params, mode: str, act_bits=None,
          device: Optional[Union[str, torch.device]] = None) -> List[Dict]:
    """The stash of a ResNet-8 forward over 8 images (seed 7 on the CPU,
    draws seed 8 on the device) with ``params`` (e.g.
    ``run(...)["params"]``): QM quantizes at ``act_bits`` (None, a number
    or ``{site: bits}``); every other mode stashes full precision, and
    BitChop's bits are priced by ``stash_footprint``."""
    dev = resolve_device(device)
    cfg = cnn_mod.RESNET8
    model = cnn_mod.CNN(cfg, "qm" if mode == "qm" else "none", dev)
    images = _moved(cnn_mod.synthetic_images(_generator("cpu", 7), 8, cfg,
                                             "cpu"), dev)
    if isinstance(act_bits, dict):
        bits = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                for k, v in act_bits.items()}
    elif act_bits is not None:
        bits = torch.tensor(act_bits, dtype=torch.float32, device=dev)
    else:
        bits = None
    with torch.no_grad():
        _, entries = model.forward(params, images["images"], act_bits=bits,
                                   generator=_generator(dev, 8),
                                   collect_stash=True)
    return entries


def stash_footprint(entries: List[Dict], mantissa_bits, exp_bits=None
                    ) -> Dict[str, float]:
    """Bit-exact SFP footprint of a stash against fp32 and bf16, with the
    JS zero-skip variant and the sign / mantissa / exponent shares.
    ``mantissa_bits`` and ``exp_bits`` are scalars or ``{site: bits}``;
    ``exp_bits`` None keeps the full exponent (QM, BitChop), a value
    prices a reduced exponent field (the QE / BitWave account)."""
    total_sfp = total_js = total_fp32 = total_bf16 = 0
    parts = {"sign": 0, "mantissa": 0, "exponent": 0}
    for s in entries:
        t, name = s["tensor"], s["name"]
        bits = (mantissa_bits[name] if isinstance(mantissa_bits, dict)
                else mantissa_bits)
        ebits = exp_bits[name] if isinstance(exp_bits, dict) else exp_bits
        rep = footprint.sfp_footprint(t, bits, exp_bits=ebits,
                                      signless=s["signless"])
        rep_js = footprint.sfp_js_footprint(t, bits, signless=s["signless"])
        total_sfp += rep.total_bits
        total_js += min(rep_js.total_bits, rep.total_bits)
        total_fp32 += footprint.baseline_bits(t, "fp32")
        total_bf16 += footprint.baseline_bits(t, "bf16")
        parts["sign"] += rep.sign_bits
        parts["mantissa"] += rep.mantissa_bits
        parts["exponent"] += rep.exponent_bits
    return {"sfp_bits": total_sfp, "fp32_bits": total_fp32,
            "bf16_bits": total_bf16,
            "vs_fp32": total_sfp / total_fp32,
            "vs_bf16": total_sfp / total_bf16,
            "js_vs_fp32": total_js / total_fp32,
            "share_sign": parts["sign"] / total_sfp,
            "share_mantissa": parts["mantissa"] / total_sfp,
            "share_exponent": parts["exponent"] / total_sfp}
