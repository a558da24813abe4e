"""Policy-aware serving precision: learned bitlengths -> pool geometry,
and the pressure controller of graceful degradation.

The paper's deployment round-up (section IV-A4): bitlengths learned in
training carry over to inference. Training stamps the policy's current
``PrecisionDecision`` summary into every checkpoint manifest
(``CheckpointManager.save(extra=...)`` through the train loop); this
module reads it back with ``read_extra`` and derives the serving KV
pool's container from it: a *dense* ``sfp-m{K}e{E}`` geometry holding
1 + exponent + mantissa bits per value (``container_for_decision``). No
state is restored, so a serving host can size its pool before it loads
any weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch import codecs
from repro_torch.checkpoint.manager import CheckpointManager


def container_for_decision(man_bits: float, exp_bits: float) -> str:
    """Map a (possibly fractional) learned decision to a container name.

    Delegates to ``codecs.dense_name``: bitlengths round up, the
    delta-exponent field clamps to [2, 7], and the payload is the dense
    1 + dexp + man bit-plane geometry (realized as a fixed-lane word only
    when it lands exactly on 8/16 bits).
    """
    return codecs.dense_name(man_bits, exp_bits)


def decision_from_extra(extra: Dict[str, Any]) -> Optional[Dict[str, float]]:
    """The stamped decision of a manifest's ``extra``, or None."""
    d = extra.get("decision")
    if not isinstance(d, dict):
        return None
    try:
        return {"man_bits": float(d["man_bits"]),
                "exp_bits": float(d["exp_bits"])}
    except (KeyError, TypeError, ValueError):
        return None


@dataclasses.dataclass
class PressureController:
    """Hysteresis watermark controller for precision-downshift degradation.

    The paper's runtime-adaptable container width gives serving a
    degradation axis beyond "reject or preempt": when free pool *bytes*
    drop below the ``low`` watermark, new admissions downshift to the
    engine's narrower ``degraded_container`` geometry (priced at its
    smaller per-block byte rate by the pool's dense byte accounting), and
    restore the configured geometry once the free fraction recovers above
    ``high``. The low/high gap is hysteresis — without it the controller
    chatters on the watermark as admissions/frees cross it every step.

    Already-running slots are never touched: the downshift applies to new
    prompt KV only (requantized at prefill), so degradation is gradual and
    reversible by attrition.
    """

    low: float = 0.25    # degrade when free_bytes/capacity < low
    high: float = 0.50   # restore once free_bytes/capacity >= high
    degraded: bool = False

    def __post_init__(self):
        if not (0.0 <= self.low < self.high <= 1.0):
            raise ValueError(f"watermarks need 0 <= low < high <= 1, "
                             f"got low={self.low} high={self.high}")

    def update(self, free_bytes: float, capacity_bytes: float) -> bool:
        """Advance the controller; returns True while degraded."""
        frac = free_bytes / capacity_bytes if capacity_bytes > 0 else 1.0
        if self.degraded:
            if frac >= self.high:
                self.degraded = False
        elif frac < self.low:
            self.degraded = True
        return self.degraded


def container_from_checkpoint(ckpt_dir: str,
                              step: Optional[int] = None) -> str:
    """Serving container for a trained run's checkpoint directory.

    Prefers the stamped decision (the policy-learned geometry); falls back
    to the container the run trained with, then to the registry default.
    Raises if the directory holds no checkpoint.
    """
    mgr = CheckpointManager(ckpt_dir)
    if step is None:
        step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    extra = mgr.read_extra(step)
    decision = decision_from_extra(extra)
    if decision is not None:
        return container_for_decision(**decision)
    return extra.get("container") or codecs.DEFAULT_CONTAINER
