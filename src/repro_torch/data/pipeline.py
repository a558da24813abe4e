"""Host-side input pipeline: device placement + background prefetch (the
port of ``repro.data.pipeline``).

Batches are produced on the host (``data/synthetic.py`` or any iterator of
numpy dicts), placed with the training step's batch shardings, and
prefetched on a background thread so host data generation overlaps device
compute. With shardings (``distributed.sharding.batch_specs``) each rank
keeps only its shard of a batch, as a DTensor; on the card the host rows
go through pinned memory with non-blocking copies.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed import sharding as shd


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def place(batch: Dict[str, np.ndarray], shardings: Optional[Dict[str, Any]]
          = None, device=None) -> Dict[str, torch.Tensor]:
    """numpy arrays -> tensors: integer arrays as int64 (the models'
    index dtype), floats as they are. A key with a ``Sharding`` in
    ``shardings`` becomes a DTensor holding this rank's shard on the
    mesh's device; any other goes whole to ``device`` (CUDA by
    default)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        sh = shardings.get(k) if shardings else None
        if sh is None:
            out[k] = _to_device(t, resolve_device(device))
            continue
        loc = _to_device(shd.local_chunk(t, sh).contiguous(),
                         resolve_device(sh.mesh.device_type))
        out[k] = shd.DTensor.from_local(loc, sh.mesh, list(sh.placements),
                                        run_check=False)
    return out


def prefetch(it: Iterator[Dict[str, np.ndarray]],
             shardings: Optional[Dict[str, Any]] = None,
             depth: int = 2, device=None
             ) -> Iterator[Dict[str, torch.Tensor]]:
    """Background-thread prefetch of ``depth`` placed batches, in order;
    an error in ``it`` or in the placement re-raises here. Closing the
    generator stops the worker before its next batch."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for b in it:
                if stop.is_set():
                    return
                q.put(place(b, shardings, device))
        except Exception as e:  # noqa: BLE001 - handed to the consumer
            q.put(e)
        finally:
            q.put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
