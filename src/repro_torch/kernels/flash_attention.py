"""Flash attention forward and backward: CUDA kernel wrappers and their
plain versions.

The forward replaces the TPU kernel ``src/repro/kernels/flash_attention.py:
flash_attention``. Its kernel is ``csrc/flash_attention.cu``: one CTA per
(batch*head, 64-row query tile), 64-key tiles in shared memory, f32
online softmax, and optionally each row's log-sum-exp. The backward,
``csrc/flash_attention_bwd.cu``, is the gradient of that function, which
the JAX package trains through its dense oracle (JAX cannot differentiate
the Pallas call): FA2-style recompute from the log-sum-exp, one pass for
dK/dV per key tile and one for dQ per query tile. Both are bound by
operations on the H100. GQA callers fold the query head group into the
rows (``q_rep``), as ``ops.attention`` does.

``flash_attention`` is differentiable: when autograd needs its gradient
it runs the forward kernel with the log-sum-exp and the backward kernel
in a ``torch.autograd.Function``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref

HEAD_DIMS = (64, 128, 192, 256, 288)  # head widths the kernels are built for


def plain(q, k, v, *, causal: bool = True, window: Optional[int] = None,
          softcap: Optional[float] = None, q_rep: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dense f32 attention with
    the folded-row causal position r // q_rep."""
    return ref.attention(q, k, v, causal=causal, window=window,
                         softcap=softcap, q_rep=q_rep)


def plain_bwd(q, k, v, do, *, causal: bool = True,
              window: Optional[int] = None, softcap: Optional[float] = None,
              q_rep: int = 1):
    """The backward kernel's function in plain PyTorch: (dq, dk, dv) by
    autograd through ``plain``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = plain(*leaves, causal=causal, window=window, softcap=softcap,
                  q_rep=q_rep)
        return torch.autograd.grad(o, leaves, do)


def _check(q, k, v, q_rep: int, **more):
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"bf16 CUDA tensor, got {t.dtype} on {t.device}")
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    for name, t in more.items():
        if t.shape != q.shape:
            raise ValueError(f"flash_attention: {name} {tuple(t.shape)} does "
                             f"not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if Sq % q_rep:
        raise ValueError(f"flash_attention: {Sq} rows not a multiple of "
                         f"q_rep={q_rep}")


def _scalars(causal, window, softcap, D):
    return (int(causal), -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), 1.0 / (D ** 0.5))


def _forward(q, k, v, causal, window, softcap, q_rep, with_lse: bool):
    lib = _lib.load()
    _check(q, k, v, q_rep)
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, k.shape[1], H, D,
        q_rep, *_scalars(causal, window, softcap, D), _lib.stream_ptr(q))
    _lib.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


class _FlashAttentionFn(torch.autograd.Function):
    """The forward kernel (saving q, k, v, o and the log-sum-exp) tied to
    the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_rep):
        out, lse = _forward(q, k, v, causal, window, softcap, q_rep,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      q_rep=q_rep)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.contiguous(), lse,
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_rep: int = 1) -> torch.Tensor:
    """Attention over q (B, Sq, H, D) and k/v (B, Sk, H, D) with the same
    head count; returns (B, Sq, H, D) in q's dtype. A CPU tensor takes the
    plain version (differentiable by autograd); any other tensor launches
    the kernel or raises, through the autograd Function when a gradient is
    needed."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, softcap=softcap,
                     q_rep=q_rep)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttentionFn.apply(q, k, v, causal, window, softcap,
                                       q_rep)
    return _forward(q, k, v, causal, window, softcap, q_rep,
                    with_lse=False)[0]


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None, q_rep: int = 1):
    """(dq, dk, dv) of ``flash_attention`` from its inputs, its output
    ``o``, the output gradient ``do`` and the forward's (B*H, Sq) f32
    log-sum-exp. A CPU tensor takes the plain version (``o`` and ``lse``
    unused); any other tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return plain_bwd(q, k, v, do, causal=causal, window=window,
                         softcap=softcap, q_rep=q_rep)
    lib = _lib.load()
    _check(q, k, v, q_rep, o=o, do=do)
    B, Sq, H, D = q.shape
    if (not lse.is_cuda or lse.dtype != torch.float32
            or lse.shape != (B * H, Sq) or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"f32 CUDA tensor of shape {(B * H, Sq)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, k.shape[1], H, D, q_rep,
        *_scalars(causal, window, softcap, D), _lib.stream_ptr(q))
    _lib.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0
