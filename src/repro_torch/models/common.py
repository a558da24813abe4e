"""Shared model pieces: seeded init, norms, RoPE, embeddings, dense MLP,
cross-entropy.

Parameters are plain nested dicts of tensors on an explicit device, laid
out as in the JAX package (``x @ w`` with w of shape (in, out)).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


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


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style: (1 + scale), in f32, cast back."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
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


def embed(params, tokens: torch.Tensor, scale: Optional[float] = None
          ) -> torch.Tensor:
    h = params["table"][tokens]
    if scale is not None:
        # The scale is cast to the activation dtype before the multiply.
        h = h * torch.tensor(scale, dtype=h.dtype, device=h.device)
    return h


def unembed(params, h: torch.Tensor, *, tied: bool,
            softcap: Optional[float] = None,
            valid_vocab: Optional[int] = None) -> torch.Tensor:
    """Unembedding in the activation dtype: through the embedding table
    when ``tied``, else through ``params["head"]`` (d_model, padded
    vocab); then f32 softcap, then -1e30 on the padded vocab."""
    if tied:
        logits = h @ params["embed"]["table"].T
    else:
        logits = h @ params["head"]
    logits = logits.to(torch.float32)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        logits[..., valid_vocab:] = -1e30
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


def mlp(params, x: torch.Tensor, act: str, glu: bool) -> torch.Tensor:
    h = x @ params["w_in"]
    a = activation(act)(h.to(torch.float32)).to(x.dtype)
    if glu:
        a = a * (x @ params["w_gate"])
    return a @ params["w_out"]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in f32 over all positions. The JAX package picks
    the label logit with an iota-compare sum (shardable over the vocab);
    a gather picks the same value."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - picked)
