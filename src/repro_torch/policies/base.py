"""Precision-policy registry (the port of ``repro.policies.base``).

A ``Policy`` is one strategy for adapting floating-point containers: it
owns a ``PolicyState(learn, ctrl)`` (``learn``: f32 leaf tensors with
``requires_grad``, updated by the policy's own SGD step; ``ctrl``:
controller registers), decides a per-scope ``PrecisionDecision`` for the
activation stash, fake-quantizes weights differentiably, and estimates
bitlength gradients from the realized stash. Policies register under a
name and every consumer resolves them through ``get()``.

Random draws come from an explicit ``torch.Generator`` and are taken
before a period runs (``act_decision``, ``weight_draws``), so the stash's
recompute in the backward pass replays them, as the JAX package replays
its keys. Ported: every policy of the JAX package (``none``, ``static``,
``qm``, ``qe``, ``afloat``, ``bitchop``, ``bitwave``) and '+'-compositions
of them (``"qm+qe"``, ``"qm+afloat"``, ``"qm+bitchop"``:
``policies/composite.py``).
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import NotYetPorted
from repro_torch.core import containers

# Registered in the JAX package, still to be ported here (validate_name
# and get raise NotYetPorted for these): none left.
NOT_YET_PORTED: Tuple[str, ...] = ()


class PrecisionDecision(NamedTuple):
    """Integer bitlengths for one tensor scope this step."""

    man_bits: torch.Tensor  # () int32, mantissa bits to keep
    exp_bits: torch.Tensor  # () int32, exponent bits to keep


class PolicyState(NamedTuple):
    """``learn``: dict of f32 leaf tensors (bitlength parameters);
    ``ctrl``: controller registers. Either may be empty."""

    learn: Any
    ctrl: Any


@dataclasses.dataclass(frozen=True)
class ScopeDims:
    """Scope geometry and container limits a policy sizes itself to."""

    n_periods: int
    n_rem: int
    man_bits: int  # source container mantissa bits (7 bf16, 23 fp32)
    exp_bits: int  # source container exponent bits (8 bf16/fp32)

    @classmethod
    def for_dtype(cls, dtype, n_periods: int = 0, n_rem: int = 0
                  ) -> "ScopeDims":
        spec = containers.spec_for(dtype)
        return cls(n_periods=n_periods, n_rem=n_rem,
                   man_bits=spec.man_bits, exp_bits=spec.exp_bits)


def full_decision(dims: ScopeDims) -> PrecisionDecision:
    return PrecisionDecision(
        man_bits=torch.tensor(dims.man_bits, dtype=torch.int32),
        exp_bits=torch.tensor(dims.exp_bits, dtype=torch.int32))


def jclip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: maximum then minimum, so a value on a bound gets half
    the gradient, as in JAX (``torch.clamp`` would pass all of it)."""
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(hi_t, torch.maximum(lo_t, x))


class _SteTruncate(torch.autograd.Function):
    """Q(M, n) forward, identity gradient in x (the straight-through
    estimator, §IV-A1)."""

    @staticmethod
    def forward(ctx, x, n):
        return containers.truncate_mantissa(x, n)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SteTruncateExp(torch.autograd.Function):
    """Exponent truncation forward, identity gradient in x."""

    @staticmethod
    def forward(ctx, x, e):
        return containers.truncate_exponent(x, e)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste_truncate(x: torch.Tensor, n) -> torch.Tensor:
    """Mantissa truncation with a straight-through gradient (§IV-A1)."""
    return _SteTruncate.apply(x, n)


def apply_decision_ste(x: torch.Tensor, d: PrecisionDecision,
                       dims: ScopeDims, *, adapts_exponent: bool
                       ) -> torch.Tensor:
    """Realize a decision on a tensor, straight-through in x; the exponent
    truncation only for policies that adapt the exponent, so a
    mantissa-only policy's values are Q(M, n) alone."""
    x = _SteTruncate.apply(x, d.man_bits)
    if adapts_exponent:
        x = _SteTruncateExp.apply(x, d.exp_bits)
    return x


@dataclasses.dataclass(frozen=True)
class Policy:
    """One precision-adaptation strategy; hyper-parameters ride on the
    frozen instance."""

    container: str = "sfp8"        # realized stash container (codec name)
    quantize_weights: bool = True  # weight-side fake-quant at use sites

    # Class attributes, not dataclass fields.
    name = "?"
    enabled = True            # False -> the model skips all hooks
    adapts_exponent = False   # True -> the stash truncates exponents first
    has_stash_grad = False    # stash-side bitlength estimator
    requires_act_bits = False  # CNN path: skip when no bits are provided

    @property
    def quantizes_weights(self) -> bool:
        """Whether the model fake-quantizes (and draws bits for) weights;
        the controller policies quantize activations only."""
        return self.enabled and self.quantize_weights

    # -- state ----------------------------------------------------------

    def init_state(self, dims: ScopeDims, device=None) -> PolicyState:
        return PolicyState(learn={}, ctrl={})

    # -- views handed to the model --------------------------------------

    def control_view(self, ctrl: Any, dims: ScopeDims) -> Any:
        return {}

    def forward_view(self, learn: Any, cview: Any, dims: ScopeDims) -> Any:
        """The per-forward view the model threads (``RunState.pol``)."""
        return {}

    def scan_slices(self, view: Any, dims: ScopeDims) -> Any:
        """Per-period views: a dict of tensors with leading n_periods."""
        return {}

    def rem_slice(self, view: Any, i: int, dims: ScopeDims) -> Any:
        """The scope view of remainder layer ``i``."""
        return {}

    # -- draws and quantizers --------------------------------------------

    def act_decision(self, pslice: Any, generator: torch.Generator,
                     dims: ScopeDims) -> PrecisionDecision:
        """The stash decision of one scope (may draw once)."""
        return full_decision(dims)

    def quantize_act(self, x: torch.Tensor, pslice: Any,
                     generator: torch.Generator, dims: ScopeDims
                     ) -> torch.Tensor:
        """Differentiable activation quantization at a use site (the CNN
        path; the decoder's stash goes through ``act_decision``)."""
        return x

    def weight_draws(self, pslice: Any, generator: torch.Generator,
                     count: int, dims: ScopeDims) -> Optional[torch.Tensor]:
        """Integer bitlengths of ``count`` weight tensors of one scope."""
        return None

    def quantize_weight(self, w: torch.Tensor, pslice: Any,
                        n_int: Optional[torch.Tensor],
                        dims: ScopeDims) -> torch.Tensor:
        """Differentiable weight fake-quant at the use site."""
        return w

    def stash_grad(self, dh: torch.Tensor, h_q: torch.Tensor, pslice: Any,
                   dims: ScopeDims) -> Any:
        """Bitlength cotangents estimated from the realized stash (a dict
        matching ``pslice``). Only called when ``has_stash_grad``."""
        return {k: torch.zeros((), dtype=torch.float32, device=dh.device)
                for k in pslice}

    # -- loss and per-step updates ---------------------------------------

    def penalty(self, learn: Any, lam: Dict[str, torch.Tensor],
                dims: ScopeDims) -> torch.Tensor:
        """Footprint-regularizer term added to the loss (eq. 7)."""
        return torch.zeros((), dtype=torch.float32)

    def update_learn(self, learn: Any, grads: Any, dims: ScopeDims) -> Any:
        return learn

    def observe(self, ctrl: Any, loss: torch.Tensor, lr_changed: bool,
                dims: ScopeDims) -> Any:
        return ctrl

    # -- reporting --------------------------------------------------------

    def metrics(self, state: PolicyState, dims: ScopeDims
                ) -> Dict[str, torch.Tensor]:
        return {}

    def snapshot(self, state: PolicyState) -> Dict[str, Any]:
        """Host-side trajectory record (tensors allowed)."""
        return {}

    def decision_summary(self, state: PolicyState, dims: ScopeDims
                         ) -> Dict[str, float]:
        """Mean (man_bits, exp_bits) the policy currently decides, rounded
        up for learned fractional bitlengths (deployment, §IV-A4)."""
        return {"man_bits": float(dims.man_bits),
                "exp_bits": float(dims.exp_bits)}

    def layer_decisions(self, state: PolicyState, dims: ScopeDims):
        """Per-period deployment decisions ``[(man_bits, exp_bits), ...]``
        (length ``dims.n_periods``); policies with per-scope parameters
        override, the others repeat their summary."""
        d = self.decision_summary(state, dims)
        return [(d["man_bits"], d["exp_bits"])] * dims.n_periods


def modeled_footprint(policy: Policy, state: PolicyState, dims: ScopeDims
                      ) -> Dict[str, float]:
    """Modeled stash bits/value under the policy's current decisions:
    sign + mantissa + exponent (group metadata is negligible)."""
    d = policy.decision_summary(state, dims)
    bits = 1.0 + d["man_bits"] + d["exp_bits"]
    return {"man_bits": d["man_bits"], "exp_bits": d["exp_bits"],
            "bits_per_value": bits, "vs_bf16": bits / 16.0,
            "vs_fp32": bits / 32.0}


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------

_REGISTRY: Dict[str, type] = {}


def register(cls: type) -> type:
    _REGISTRY[cls.name] = cls
    return cls


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def validate_name(name: str) -> Tuple[str, ...]:
    """Parse a policy name or '+'-composition without constructing it;
    raise ValueError with a did-you-mean hint, on a duplicate part, or
    with a "not yet ported" message for the JAX package's other
    policies."""
    parts = tuple(p.strip() for p in name.split("+") if p.strip())
    if not parts:
        raise ValueError(f"empty precision-policy name {name!r}")
    for p in parts:
        if p in NOT_YET_PORTED:
            raise ValueError(f"precision policy {p!r} is not yet ported to "
                             f"repro_torch; ported: {list(names())}")
        if p not in _REGISTRY:
            hint = difflib.get_close_matches(p, names(), n=1, cutoff=0.5)
            msg = f"unknown precision policy {p!r}"
            if hint:
                msg += f"; did you mean {hint[0]!r}?"
            raise ValueError(msg + f" (registered: {list(names())}, "
                             f"composable with '+', e.g. qm+qe)")
    if len(set(parts)) != len(parts):
        raise ValueError(f"duplicate sub-policy in {name!r}")
    return parts


def get(name: str, **kwargs) -> Policy:
    """Resolve a policy by name; ``"a+b"`` composes. Keyword overrides are
    routed to the sub-policies that declare the field (``container``
    reaches all of them, and the composite stashes in it too); an override
    no policy takes raises."""
    try:
        parts = validate_name(name)
    except ValueError as e:
        if "not yet ported" in str(e):
            raise NotYetPorted(str(e)) from e
        raise KeyError(str(e)) from e
    built, consumed = [], set()
    for part in parts:
        cls = _REGISTRY[part]
        fields = {f.name for f in dataclasses.fields(cls)}
        built.append(cls(**{k: v for k, v in kwargs.items() if k in fields}))
        consumed |= fields
    extra = set(kwargs) - consumed
    if extra:
        raise TypeError(f"policy {name!r} accepts no option(s) "
                        f"{sorted(extra)}")
    if len(built) == 1:
        return built[0]
    from repro_torch.policies.composite import CompositePolicy
    return CompositePolicy(policies=tuple(built),
                           container=built[0].container)


def coerce(policy) -> Policy:
    """Accept a Policy, a registry name, or None (full precision)."""
    if policy is None:
        return get("none")
    if isinstance(policy, Policy):
        return policy
    if isinstance(policy, str):
        return get(policy)
    raise TypeError(f"cannot interpret {policy!r} as a precision policy")
