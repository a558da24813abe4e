"""Shared argparse types and inputs of the launchers."""
from __future__ import annotations

import argparse


def container_name(value: str) -> str:
    """argparse ``type=`` for container-codec flags."""
    from repro_torch import codecs
    try:
        codecs.validate_name(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))
    return value


def policy_name(value: str) -> str:
    """argparse ``type=`` for precision-policy flags."""
    from repro_torch import policies
    try:
        policies.validate_name(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))
    return value


def prefix_zeros(cfg, batch: int, device):
    """A prefix-LM's ``cond_embeddings`` as both launchers feed them:
    zeros of (batch, prefix_tokens, d_model) in the compute dtype, as the
    JAX launchers do (the frontends are stubs); None for other archs.
    (Zeros stay zero through every layer, so with them the prefix's mask
    changes no output: checks of the mask draw random embeddings.)"""
    if not cfg.prefix_tokens:
        return None
    import torch
    return torch.zeros((batch, cfg.prefix_tokens, cfg.d_model),
                       dtype=cfg.compute_dtype, device=device)
