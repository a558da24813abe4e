"""Shared model pieces: seeded init, norms, RoPE, embeddings, dense MLP,
cross-entropy, and their tensor-parallel forms.

Parameters are plain nested dicts of tensors on an explicit device, laid
out as in the JAX package (``x @ w`` with w of shape (in, out)). Each
block's ``*_AXES`` names the logical axes of its leaves, as the JAX
package's ``ParamFactory`` axes mode does (``distributed.sharding`` maps
them onto a mesh).

Under tensor parallelism (``tp``, a ``sharding.TensorParallel``) the MLP is
column-parallel in ``w_in`` / ``w_gate`` and row-parallel in ``w_out``; with
a ``mesh`` the embedding table or untied head is this rank's vocab shard
over the mesh's ``model`` dim, and the lookup, the logits and the
cross-entropy run across the shards.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd

EMBED_AXES = {"table": ("vocab", "embed_r")}
HEAD_AXES = ("embed_r", "vocab")
MLP_AXES = {"w_in": ("embed", "ff"), "w_gate": ("embed", "ff"),
            "w_out": ("ff", "embed")}


def normal_init(shape: Sequence[int], gen: torch.Generator,
                device: torch.device, dtype: torch.dtype,
                scale: Optional[float] = None) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 from ``gen``, then cast; ``scale``
    defaults to fan_in ** -0.5 (fan_in = shape[0] of a matrix)."""
    shape = tuple(int(s) for s in shape)
    if scale is None:
        fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
        scale = fan_in ** -0.5
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def rmsnorm_init(dim: int, device, dtype):
    return {"scale": torch.zeros((dim,), device=device, dtype=dtype)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6, tp=None
            ) -> torch.Tensor:
    """Gemma-style: (1 + scale), in f32, cast back. Under ``tp`` ``x`` and
    ``scale`` hold this rank's equal share of the normed dim, and the
    mean square is the mean of the ranks' means (the same bits on one
    rank), its gradient summed back over the group."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    if tp is not None:
        var = shd.sum_over(var, tp.group) / tp.size
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embeddings on halves of each head (no interleave).
    x: (B, S, H, D); positions: (B, S) or (S,)."""
    d = x.shape[-1]
    half = d // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exponent)
    if positions.dim() == 1:
        positions = positions[None, :]
    angle = positions[..., None].to(torch.float32) * freq
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _vocab_shard(mesh):
    """(group, rank) of this rank over the mesh's ``model`` dim."""
    return mesh.get_group("model"), mesh.get_local_rank("model")


def sharded_embed(table: torch.Tensor, tokens: torch.Tensor, mesh
                  ) -> torch.Tensor:
    """Embedding lookup with the vocab sharded over the mesh's ``model``
    dim: ``table`` is this rank's (V / tp, d) rows, ``tokens`` its batch
    rows. A masked local gather, then a sum over ``model`` (the JAX
    package's ``shard_map`` form); each shard's gradient is exact."""
    group, rank = _vocab_shard(mesh)
    vloc = table.shape[0]
    rel = tokens - rank * vloc
    ok = (rel >= 0) & (rel < vloc)
    out = table[torch.clamp(rel, 0, vloc - 1)]
    out = torch.where(ok[..., None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return shd.reduce(out, group)


def embed(params, tokens: torch.Tensor, scale: Optional[float] = None,
          mesh=None) -> torch.Tensor:
    """The table's rows of ``tokens``, times ``scale``; with ``mesh``, the
    table is this rank's vocab shard (``sharded_embed``)."""
    if mesh is not None:
        h = sharded_embed(params["table"], tokens, mesh)
    else:
        h = params["table"][tokens]
    if scale is not None:
        # The scale is cast to the activation dtype before the multiply.
        h = h * torch.tensor(scale, dtype=h.dtype, device=h.device)
    return h


def unembed(params, h: torch.Tensor, *, tied: bool,
            softcap: Optional[float] = None,
            valid_vocab: Optional[int] = None, mesh=None) -> torch.Tensor:
    """Unembedding in the activation dtype: through the embedding table
    when ``tied``, else through ``params["head"]`` (d_model, padded
    vocab); then f32 softcap, then -1e30 on the padded vocab. With
    ``mesh`` the table or head is this rank's vocab shard and so are the
    logits (the padded vocab masked at its global indices)."""
    start = 0
    if mesh is not None:
        group, rank = _vocab_shard(mesh)
        h = shd.copy_to(h, group)
    if tied:
        logits = h @ params["embed"]["table"].T
    else:
        logits = h @ params["head"]
    if mesh is not None:
        start = rank * logits.shape[-1]
    logits = logits.to(torch.float32)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if valid_vocab is not None and valid_vocab - start < logits.shape[-1]:
        logits[..., max(valid_vocab - start, 0):] = -1e30
    return logits


def mlp_init(d: int, ff: int, glu: bool, gen, device, dtype):
    out = {"w_in": normal_init((d, ff), gen, device, dtype),
           "w_out": normal_init((ff, d), gen, device, dtype)}
    if glu:
        out["w_gate"] = normal_init((d, ff), gen, device, dtype)
    return out


def activation(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu
            "relu": F.relu}[name]


def mlp(params, x: torch.Tensor, act: str, glu: bool, tp=None
        ) -> torch.Tensor:
    """The (gated) MLP; under ``tp`` on this rank's ff columns, its
    partial output summed over the TP group."""
    group = tp.group if tp is not None else None
    x = shd.copy_to(x, group)
    h = x @ params["w_in"]
    a = activation(act)(h.to(torch.float32)).to(x.dtype)
    if glu:
        a = a * (x @ params["w_gate"])
    return shd.reduce(a @ params["w_out"], group)


class _VocabParallelXent(torch.autograd.Function):
    """Per-position cross-entropy over vocab-sharded f32 logits: the max
    and the sum of exponentials summed across the shards, the label's
    logit picked on the shard that holds it. The same operations as
    ``torch.logsumexp`` and a gather under autograd, so one shard gives
    the unsharded function's bits; the backward is softmax minus one-hot
    on each shard."""

    @staticmethod
    def forward(ctx, logits, labels, start, group):
        vloc = logits.shape[-1]
        m = shd.all_reduce_(torch.amax(logits, dim=-1, keepdim=True), group,
                            op="max")
        lse = torch.log(shd.all_reduce_(
            torch.sum(torch.exp(logits - m), dim=-1), group)) + m[..., 0]
        rel = labels - start
        ok = (rel >= 0) & (rel < vloc)
        rel = torch.clamp(rel, 0, vloc - 1)
        picked = torch.gather(logits, -1, rel[..., None])[..., 0]
        picked = shd.all_reduce_(torch.where(ok, picked, 0.0), group)
        ctx.save_for_backward(logits, lse, rel, ok)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, lse, rel, ok = ctx.saved_tensors
        grad = g[..., None] * torch.exp(logits - lse[..., None])
        grad.scatter_add_(-1, rel[..., None],
                          torch.where(ok, -g, 0.0)[..., None])
        return grad, None, None, None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mesh=None
                 ) -> torch.Tensor:
    """Mean cross-entropy in f32 over all positions. The JAX package picks
    the label logit with an iota-compare sum (shardable over the vocab);
    a gather picks the same value. With ``mesh`` the logits are this
    rank's vocab shard (``unembed(mesh=)``) and the softmax runs across
    the shards."""
    logits = logits.to(torch.float32)
    if mesh is not None:
        group, rank = _vocab_shard(mesh)
        return torch.mean(_VocabParallelXent.apply(
            logits, labels.long(), rank * logits.shape[-1], group))
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - picked)
