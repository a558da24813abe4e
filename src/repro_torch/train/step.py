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
  * a sharded step for a model built on a mesh (``DecoderModel(mesh=)``):
    the parameters, AdamW moments and residual are DTensors of the
    model's ``shardings`` (the placements belong to the model, whose
    layers compute in them), the gradient accumulators their local
    shards. Each rank takes its rows of
    every microbatch (the one-device step's microbatches, split over the
    batch ranks) and differentiates its share of the global mean; the
    layers' gathers reduce-scatter the shares of sharded leaves, and the
    step sums the rest over the ranks that hold different shares: a
    replicated leaf's over the batch axes (and the TP axis where each TP
    rank holds a share, ``DecoderModel.grad_reduce_axes``), a learned
    activation bitlength's over the batch axes, a weight bitlength's over
    the whole mesh (each rank sees its own weight shard). The penalty's
    gradient is added once. Every rank draws the one-device step's
    bitlengths from its own copy of the generator, so all must run every
    step. The metrics are global and equal on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.stash import float_leaves, substitute
from repro_torch.distributed import sharding as shd
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
    compressed. Under a mesh every rank draws the whole tree and keeps its
    shards (DTensors of the model's ``shardings``)."""
    params = model.init(seed)
    shardings = model.shardings
    if shardings is None:
        for p in adamw.leaves(params):
            p.requires_grad_(True)
    else:
        params = shd.tree_map(shd.distribute, params, shardings)
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


def shard_state(model: DecoderModel, state: TrainState) -> TrainState:
    """A whole (one-device) state, the same on every rank, as the sharded
    step's: the parameters, moments and residual as DTensors of the
    model's ``shardings`` (this rank's shards); the rest as it is."""
    sh = model.shardings

    def dist(tree):
        return None if tree is None else shd.tree_map(shd.distribute, tree,
                                                      sh)
    return state._replace(
        params=dist(state.params),
        opt=state.opt._replace(m=dist(state.opt.m), v=dist(state.opt.v)),
        grad_residual=dist(state.grad_residual))


def state_shardings(model: DecoderModel, state: TrainState) -> TrainState:
    """``state``'s structure with the sharding of each leaf that has one
    under ``model``'s mesh: the model's ``shardings`` for the parameters,
    moments and residual; None elsewhere, so the policy state stays whole
    on every rank (the ``shardings=`` of ``CheckpointManager.restore``,
    onto this model's mesh)."""
    sh = model.shardings
    return TrainState(
        params=sh, opt=adamw.AdamWState(m=sh, v=sh, count=None),
        pstate=None, step=None, gen=None,
        grad_residual=None if state.grad_residual is None else sh)


def make_train_step(model: DecoderModel, tc: TrainConfig):
    policy, dims, mesh = model.policy, model.dims, model.mesh
    # The wire's bitlength goes to the device once, not once per leaf.
    wire_bits = (None if tc.grad_compress_bits is None else
                 device_bits(tc.grad_compress_bits, model.device))
    if mesh is not None:
        n_batch = model._batch_shards()
        batch_group = shd.axes_group(mesh, model.batch_axes)
        mesh_group = shd.mesh_group(mesh)
        reduce_groups = {path: shd.axes_group(mesh, a)
                         for path, a in model.grad_reduce_axes().items()}

    def learn_grads(shares, penalty, learn):
        """The learned bitlengths' gradients from this rank's shares: an
        activation bitlength's summed over the batch axes (the stash
        estimate covers this rank's rows), any other over the whole mesh
        (the weight estimate covers this rank's weight shard and rows),
        then the penalty's gradient once."""
        paths, leaves = zip(*float_leaves(learn)) if learn else ((), ())
        pen = (torch.autograd.grad(penalty, leaves, allow_unused=True)
               if penalty.requires_grad else [None] * len(leaves))
        out = []
        for path, t, g, p in zip(paths, leaves, shares, pen):
            g = (torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                 if g is None else g.to(torch.float32))
            shd.all_reduce_(g, batch_group if path[-1].startswith("act")
                            else mesh_group)
            out.append(g if p is None else g + p)
        return out

    def rows(batch, i, nm):
        """Microbatch ``i`` of the global batch: under a mesh this rank's
        rows of it (a DTensor batch is gathered first unless it is one
        microbatch already in the batch placements)."""
        B = batch["tokens"].shape[0]
        if mesh is None:
            return {k: v[i * (B // nm):(i + 1) * (B // nm)]
                    for k, v in batch.items()}
        if (B // nm) % n_batch:
            raise ValueError(f"a microbatch of {B // nm} rows does not "
                             f"split over {n_batch} batch ranks")
        specs = shd.batch_specs(model.rules, "train",
                                "cond_embeddings" in batch, mesh)
        out = {}
        for k, v in batch.items():
            if isinstance(v, shd.DTensor):
                if nm == 1 and tuple(v.placements) == specs[k].placements:
                    out[k] = v.to_local()
                    continue
                v = shd.full(v)
            out[k] = shd.local_chunk(v[i * (B // nm):(i + 1) * (B // nm)],
                                     specs[k])
        return out

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
        params = state.params
        p_paths = [path for path, _ in float_leaves(params)]
        p_leaves = adamw.leaves(params)
        if mesh is not None:
            # Differentiate the local shards (views of the DTensors).
            p_leaves = [shd.local(p).detach().requires_grad_()
                        for p in p_leaves]
            params = substitute(params, dict(zip(p_paths, p_leaves)))
        # A composite's learn is nested ({"qm": {...}, "qe": {...}}): its
        # leaves are differentiated flat and the gradients renested.
        paths = [path for path, _ in float_leaves(learn)]
        wrt = p_leaves + [t for _, t in float_leaves(learn)]
        n_p = len(p_leaves)
        acc = [None] * len(wrt)
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        loss_acc = xent_acc = pen_acc = lb_acc = drop_acc = zero
        for i in range(nm):
            mb = rows(batch, i, nm)
            run = RunState(gen=state.gen,
                           pol=policy.forward_view(learn, cview, dims))
            loss, metrics = model.loss(params, mb, run)
            penalty = policy.penalty(learn, lam, dims).to(loss.device)
            if mesh is None:
                total = loss + penalty
                grads = list(torch.autograd.grad(total, wrt,
                                                 allow_unused=True))
            else:
                # This rank's share; the penalty is added once, after the
                # shares are summed.
                total = loss
                grads = list(torch.autograd.grad(loss, wrt,
                                                 allow_unused=True))
                grads[n_p:] = learn_grads(grads[n_p:], penalty, learn)
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

        if mesh is not None:
            for g, path in zip(acc[:n_p], p_paths):
                shd.all_reduce_(g, reduce_groups[path])
            # The MoE metrics are the global batch's on every rank already.
            sums = shd.all_reduce_(torch.stack([loss_acc, xent_acc]),
                                   batch_group)
            loss_acc, xent_acc = sums.unbind()
            loss_acc = loss_acc + pen_acc
        grads, residual = acc[:n_p], state.grad_residual
        if wire_bits is not None:
            if residual is None:
                raise ValueError("grad_compress_bits is set but the state "
                                 "has no grad_residual (init_state with "
                                 "this TrainConfig)")
            # Error feedback, in place over the gradients and the residual.
            grads, _ = grad_compress.compress_grads(
                grads, [shd.local(r) for r in adamw.leaves(residual)],
                wire_bits, tc.grad_codec)
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
