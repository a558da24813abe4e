"""Train-step builder: microbatched grad accumulation + precision policies
(the port of ``repro.train.step``).

  * microbatch loop: gradients accumulate in f32 across
    ``num_microbatches`` slices of the global batch; only the final sum
    feeds the optimizer.
  * precision policy: the model's stash and weight quantization follow
    the policy's decisions; learned bitlengths receive their weight-side
    and stash-estimator gradients plus the eq. 7 footprint penalty, then
    the policy's own SGD step; a controller policy observes the
    (pre-penalty) cross-entropy once per step. The loss adds an MoE
    model's auxiliary loss; its ``moe_lb_loss`` and ``moe_drop_frac``
    are reported as means over the micro-batches (zeros when dense).
  * optional gradient compression with error feedback
    (``train/grad_compress.py``): with ``grad_compress_bits`` the
    accumulated parameter gradients go through ``grad_codec``'s round trip
    once per step, before AdamW (so ``grad_norm`` is the compressed
    gradients' norm), and the residual rides in the state.

Parameter shardings are not ported (the port runs on one device).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.stash import float_leaves, substitute
from repro_torch.kernels.sfp_pack import device_bits
from repro_torch.models.model import DecoderModel, RunState
from repro_torch.optim import adamw
from repro_torch.optim.schedule import Schedule
from repro_torch.policies import PolicyState
from repro_torch.train import grad_compress
from repro_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    schedule: Schedule = Schedule()
    num_microbatches: int = 1
    grad_compress_bits: Optional[int] = None  # e.g. 4: a 4-bit mantissa wire
    grad_codec: str = "bit_exact"  # registry codec realizing the wire format


def init_state(model: DecoderModel, seed: int, tc: TrainConfig
               ) -> TrainState:
    """Parameters from ``seed``; the step's generator from ``seed`` too
    (a separate stream object); an f32 zero residual when gradients are
    compressed."""
    params = model.init(seed)
    for p in adamw.leaves(params):
        p.requires_grad_(True)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed + 999)
    return TrainState(params=params, opt=adamw.init(params),
                      pstate=model.policy.init_state(model.dims,
                                                     model.device),
                      step=0, gen=gen,
                      grad_residual=(grad_compress.init_residual(params)
                                     if tc.grad_compress_bits else None))


def _scope_lambdas(model: DecoderModel, batch_shape: Tuple[int, int]
                   ) -> Dict[str, torch.Tensor]:
    """Footprint weights (eq. 7): each scope's share of the total stash
    and weight footprint. Activation stash per period: B * (S + P) * d
    values, P a prefix-LM's prefix (``cfg.prefix_tokens``, counted as the
    JAX package counts it, whether or not the batch carries one); weights
    per period: the parameter count of its layers, 1-D leaves included
    (each kind its own: an RG-LRU layer and a LOCAL one differ); per
    remainder scope: the mean of the remainder layers' counts, as the JAX
    package weighs them."""
    cfg = model.cfg
    B, S = batch_shape
    per_period = sum(model.layer_param_count(k) for k in cfg.period)
    act = float(B * (S + cfg.prefix_tokens) * cfg.d_model)
    n_rem = len(cfg.remainder)
    rem_w = (sum(model.layer_param_count(k) for k in cfg.remainder) / n_rem
             if n_rem else 0.0)
    total = (act + per_period) * cfg.n_periods + (act + rem_w) * n_rem

    def full(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=model.device)

    return {"act": full(cfg.n_periods, act / total),
            "w": full(cfg.n_periods, per_period / total),
            "act_rem": full(n_rem, act / total),
            "w_rem": full(n_rem, rem_w / total)}


def make_train_step(model: DecoderModel, tc: TrainConfig):
    policy, dims = model.policy, model.dims
    # The wire's bitlength goes to the device once, not once per leaf.
    wire_bits = (None if tc.grad_compress_bits is None else
                 device_bits(tc.grad_compress_bits, model.device))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        B, S = batch["tokens"].shape
        nm = tc.num_microbatches
        if B % nm:
            raise ValueError(f"batch {B} is not a multiple of "
                             f"{nm} microbatches")
        lam = _scope_lambdas(model, (B // nm, S))
        lr = tc.schedule(state.step)
        learn = state.pstate.learn
        cview = policy.control_view(state.pstate.ctrl, dims)
        p_leaves = adamw.leaves(state.params)
        # A composite's learn is nested ({"qm": {...}, "qe": {...}}): its
        # leaves are differentiated flat and the gradients renested.
        paths = [path for path, _ in float_leaves(learn)]
        wrt = p_leaves + [t for _, t in float_leaves(learn)]
        acc = [None] * len(wrt)
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        loss_acc = xent_acc = pen_acc = lb_acc = drop_acc = zero
        for i in range(nm):
            mb = {k: v[i * (B // nm):(i + 1) * (B // nm)]
                  for k, v in batch.items()}
            run = RunState(gen=state.gen,
                           pol=policy.forward_view(learn, cview, dims))
            loss, metrics = model.loss(state.params, mb, run)
            penalty = policy.penalty(learn, lam, dims).to(loss.device)
            total = loss + penalty
            grads = list(torch.autograd.grad(total, wrt, allow_unused=True))
            for j, t in enumerate(wrt):
                g = (torch.zeros(t.shape, dtype=torch.float32,
                                 device=t.device)
                     if grads[j] is None else grads[j].to(torch.float32))
                grads[j] = None  # free the working-dtype gradient early
                acc[j] = g / nm if acc[j] is None else acc[j] + g / nm
            loss_acc = loss_acc + total.detach() / nm
            xent_acc = xent_acc + metrics["xent"].detach() / nm
            pen_acc = pen_acc + penalty.detach() / nm
            lb_acc = lb_acc + metrics["moe_lb_loss"].detach() / nm
            drop_acc = drop_acc + metrics["moe_drop_frac"].detach() / nm

        n_p = len(p_leaves)
        grads, residual = acc[:n_p], state.grad_residual
        if wire_bits is not None:
            if residual is None:
                raise ValueError("grad_compress_bits is set but the state "
                                 "has no grad_residual (init_state with "
                                 "this TrainConfig)")
            # Error feedback, in place over the gradients and the residual.
            grads, _ = grad_compress.compress_grads(
                grads, adamw.leaves(residual), wire_bits, tc.grad_codec)
        new_params, new_opt, gnorm = adamw.update(
            grads, state.opt, state.params, tc.opt, lr)
        new_learn = policy.update_learn(
            learn, substitute(learn, dict(zip(paths, acc[n_p:]))), dims)
        new_ctrl = policy.observe(state.pstate.ctrl, xent_acc,
                                  tc.schedule.lr_changed(state.step), dims)
        new_pstate = PolicyState(learn=new_learn, ctrl=new_ctrl)
        metrics = {"loss": loss_acc, "xent": xent_acc, "lr": lr,
                   "grad_norm": gnorm, "moe_lb_loss": lb_acc,
                   "moe_drop_frac": drop_acc, "policy_penalty": pen_acc,
                   **policy.metrics(new_pstate, dims)}
        return TrainState(params=new_params, opt=new_opt, pstate=new_pstate,
                          step=state.step + 1, gen=state.gen,
                          grad_residual=residual), metrics

    return train_step
