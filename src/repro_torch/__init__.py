"""PyTorch/CUDA port of Schrodinger's FP for NVIDIA Hopper: training with
adaptive floating-point containers (one device or sharded over a
``torch.distributed`` mesh) and serving from packed, paged KV caches.

Layout mirrors ``src/repro``: ``configs``, ``core``, ``kernels`` (plain
PyTorch versions beside hand-written CUDA kernels under ``csrc/``),
``codecs``, ``models``, ``train``, ``optim``, ``checkpoint``,
``distributed``, ``data``, ``serve``, ``obs`` and ``launch``. Importing
the package never builds or loads a kernel; the CUDA library is built on
first launch.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


class NotYetPorted(NotImplementedError):
    """A container, policy or feature the JAX package has and this port
    does not yet."""


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise. Without a usable GPU and without an explicit device this
    raises instead of quietly falling back to the CPU."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
