"""Precision policies of the port (see base.py for the contract).

    policy = policies.get("qm", container="sfp8", gamma=0.05)
    state  = policy.init_state(dims, device)   # PolicyState(learn, ctrl)

Registered: ``none`` (full precision), ``qm`` (Quantum Mantissa) and
``qe`` (Quantum Exponent); ``policies.get("qm+qe")`` composes them
(``CompositePolicy``), learning mantissa and exponent bits at once.
"""
from repro_torch.policies.base import (NotYetPorted, Policy, PolicyState,
                                       PrecisionDecision, ScopeDims, coerce,
                                       full_decision, get, modeled_footprint,
                                       names, register, validate_name)
from repro_torch.policies.composite import CompositePolicy
from repro_torch.policies.quantum import QEPolicy, QMPolicy
from repro_torch.policies.static import NonePolicy

register(NonePolicy)
register(QMPolicy)
register(QEPolicy)

__all__ = [
    "NotYetPorted", "Policy", "PolicyState", "PrecisionDecision",
    "ScopeDims", "coerce", "full_decision", "get", "modeled_footprint",
    "names", "register", "validate_name", "CompositePolicy", "NonePolicy",
    "QEPolicy", "QMPolicy",
]
