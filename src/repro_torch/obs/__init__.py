"""Observability substrate: spans and the decision audit (pure stdlib).

``critical_path`` and the Chrome-trace ``export`` of the reference are not
part of this package yet.
"""

from repro_torch.obs.audit import (
    AuditEntry,
    DecisionAuditLog,
    bound_app,
    get_audit_log,
    set_audit_log,
)
from repro_torch.obs.tracer import Span, Tracer, get_tracer, set_tracer

__all__ = [
    "AuditEntry",
    "DecisionAuditLog",
    "Span",
    "Tracer",
    "bound_app",
    "get_audit_log",
    "get_tracer",
    "set_audit_log",
    "set_tracer",
]
