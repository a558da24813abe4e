"""Serving engine, batch mode: one prefill, then a greedy decode loop.

The JAX package's jitted ``lax.scan`` decode loop becomes a Python loop
over one preallocated cache that every step updates in place (JAX donates
it). The paged continuous-batching engine is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.models.model import DecoderModel


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor          # (B, max_new) greedy tokens
    steps: int
    prefill_logits: torch.Tensor  # (B, V) f32 logits after the prompt
    margins: torch.Tensor         # (B, max_new) top-1 minus top-2 logit


def _greedy(logits: torch.Tensor):
    """(B, 1, V) logits -> (first argmax (B, 1), top-2 margin (B,))."""
    last = logits[:, -1, :]
    top2 = torch.topk(last, 2, dim=-1).values
    return torch.argmax(last, dim=-1, keepdim=True), top2[:, 0] - top2[:, 1]


@torch.inference_mode()
def generate(model: DecoderModel, params, prompt: torch.Tensor, max_new: int,
             max_len: Optional[int] = None) -> GenerationResult:
    """Greedy batched generation of ``max_new`` tokens after ``prompt``
    (B, S), on the model's device (CUDA unless the model was built with
    ``device="cpu"``)."""
    dev = resolve_device(model.device)
    prompt = prompt.to(dev)
    B, S = prompt.shape
    max_len = max_len or (S + max_new)
    prefill_logits, cache = model.prefill(params, prompt, max_len)
    tok, margin = _greedy(prefill_logits)
    toks, margins = [tok], [margin]
    for i in range(max_new - 1):
        logits, cache = model.decode_step(params, cache, tok, S + i)
        tok, margin = _greedy(logits)
        toks.append(tok)
        margins.append(margin)
    return GenerationResult(tokens=torch.cat(toks, dim=1), steps=max_new,
                            prefill_logits=prefill_logits[:, -1, :],
                            margins=torch.stack(margins, dim=1))
