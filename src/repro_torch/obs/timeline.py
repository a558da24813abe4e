"""Precision-timeline recorder: the paper's bitlength trajectories, live.

Two entry kinds share one JSONL stream, discriminated by ``kind``:

``train`` — one entry per recorded train step, the per-layer
``PrecisionDecision`` (man/exp bits) the policy holds at that step::

    {"kind": "train", "step": 40,
     "layers": [{"layer": 0, "man_bits": 3, "exp_bits": 5}, ...]}

``serve`` — one entry per scheduler step: which dense geometry holds how
many pool blocks/bytes right now, plus occupancy and the pressure
controller's state. The byte figures are computed from the same per-slot
rates `BlockPool` charges, so ``sum(geometry_bytes.values()) ==
used_bytes`` holds exactly (the acceptance criterion's byte-agreement)::

    {"kind": "serve", "step": 12, "geometry_blocks": {"sfp-m3e5": 6},
     "geometry_bytes": {"sfp-m3e5": 98304}, "used_bytes": 98304,
     "free_bytes": ..., "capacity_bytes": ..., "occupancy": 0.43,
     "pressure": "degraded", "quarantined": 0, "running": 2}

This replaces the post-hoc reconstruction in ``fig_qm_bitlengths.py``
for live runs: the figure script can consume this stream directly.
"""
from __future__ import annotations

import json
import time
from typing import IO, Any, Iterable


class PrecisionTimeline:
    def __init__(self, path: str | None = None,
                 truncate: bool = True) -> None:
        self.path = path
        self.entries: list[dict[str, Any]] = []
        self._fh: IO[str] | None = None
        if path:
            self._fh = open(path, "w" if truncate else "a")

    def _push(self, entry: dict[str, Any]) -> None:
        self.entries.append(entry)
        if self._fh is not None:
            self._fh.write(json.dumps(entry) + "\n")
            self._fh.flush()

    def record_train(self, step: int,
                     decisions: Iterable[tuple[int, int]]) -> None:
        """``decisions``: per-layer (man_bits, exp_bits), policy order."""
        self._push({
            "kind": "train", "ts": time.time(), "step": int(step),
            "layers": [{"layer": i, "man_bits": int(m), "exp_bits": int(e)}
                       for i, (m, e) in enumerate(decisions)]})

    def record_serve(self, step: int, *,
                     geometry_blocks: dict[str, int],
                     geometry_bytes: dict[str, int],
                     used_bytes: int, free_bytes: int, capacity_bytes: int,
                     occupancy: float, pressure: str,
                     quarantined: int, running: int) -> None:
        self._push({
            "kind": "serve", "ts": time.time(), "step": int(step),
            "geometry_blocks": {k: int(v)
                                for k, v in geometry_blocks.items()},
            "geometry_bytes": {k: int(v)
                               for k, v in geometry_bytes.items()},
            "used_bytes": int(used_bytes), "free_bytes": int(free_bytes),
            "capacity_bytes": int(capacity_bytes),
            "occupancy": float(occupancy), "pressure": str(pressure),
            "quarantined": int(quarantined), "running": int(running)})

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
