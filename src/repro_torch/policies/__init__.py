"""Precision policies of the port (see base.py for the contract).

    policy = policies.get("qm", container="sfp8", gamma=0.05)
    state  = policy.init_state(dims, device)   # PolicyState(learn, ctrl)

Registered: ``none`` (full precision), ``static`` (fixed Gist-style
bitlengths), ``qm`` (Quantum Mantissa), ``qe`` (Quantum Exponent),
``afloat`` (QE plus AdaptivFloat's learned per-scope exponent bias),
``bitchop`` (loss-EMA controlled network-wide mantissa bits, §IV-B) and
``bitwave`` (the same controller on mantissa and exponent bits);
``policies.get("qm+qe")`` composes (``CompositePolicy``), e.g. learning
mantissa and exponent bits at once, or ``"qm+afloat"``.
"""
from repro_torch.policies.base import (NotYetPorted, Policy, PolicyState,
                                       PrecisionDecision, ScopeDims,
                                       apply_decision_ste, coerce,
                                       full_decision, get, modeled_footprint,
                                       names, register, ste_truncate,
                                       validate_name)
from repro_torch.policies.afloat import AFloatPolicy
from repro_torch.policies.bitwave import BitChopPolicy, BitWavePolicy
from repro_torch.policies.composite import CompositePolicy
from repro_torch.policies.quantum import QEPolicy, QMPolicy
from repro_torch.policies.static import NonePolicy, StaticPolicy

register(NonePolicy)
register(StaticPolicy)
register(QMPolicy)
register(QEPolicy)
register(AFloatPolicy)
register(BitChopPolicy)
register(BitWavePolicy)

__all__ = [
    "NotYetPorted", "Policy", "PolicyState", "PrecisionDecision",
    "ScopeDims", "apply_decision_ste", "coerce", "full_decision", "get",
    "modeled_footprint", "names", "register", "ste_truncate",
    "validate_name", "AFloatPolicy", "BitChopPolicy", "BitWavePolicy",
    "CompositePolicy", "NonePolicy", "QEPolicy", "QMPolicy", "StaticPolicy",
]
