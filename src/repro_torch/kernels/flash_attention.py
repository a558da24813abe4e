"""Flash attention forward: CUDA kernel wrapper and its plain version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:
flash_attention``. The kernel is ``csrc/flash_attention.cu``: one CTA per
(batch*head, 64-row query tile), 64-key tiles in shared memory, f32
online softmax; it is bound by operations on the H100. GQA callers fold
the query head group into the rows (``q_rep``), as ``ops.attention`` does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref

HEAD_DIMS = (64, 128, 192, 256, 288)  # head widths the kernel is built for


def plain(q, k, v, *, causal: bool = True, window: Optional[int] = None,
          softcap: Optional[float] = None, q_rep: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dense f32 attention with
    the folded-row causal position r // q_rep."""
    return ref.attention(q, k, v, causal=causal, window=window,
                         softcap=softcap, q_rep=q_rep)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_rep: int = 1) -> torch.Tensor:
    """Attention over q (B, Sq, H, D) and k/v (B, Sk, H, D) with the same
    head count; returns (B, Sq, H, D) in q's dtype. A CPU tensor takes the
    plain version; any other tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, softcap=softcap,
                     q_rep=q_rep)
    lib = _lib.load()
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"bf16 CUDA tensor, got {t.dtype} on {t.device}")
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if Sq % q_rep:
        raise ValueError(f"flash_attention: {Sq} rows not a multiple of "
                         f"q_rep={q_rep}")
    out = torch.empty_like(q)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, D, q_rep, int(causal), -1 if window is None else int(window),
        0.0 if softcap is None else float(softcap), 1.0 / (D ** 0.5),
        _lib.stream_ptr(q))
    _lib.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
