"""Shared argparse types for the launchers."""
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
