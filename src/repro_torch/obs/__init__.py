"""Observability substrate (pure stdlib): spans, the decision audit, the
critical path and the Chrome-trace export, as in ``repro/obs``.

The global ``Tracer`` (``get_tracer``) records a parent/child span DAG per
query (trace id == app name) into a bounded ring buffer; the global
``DecisionAuditLog`` (``get_audit_log``) records every ``DecisionNode``
binding with the context snapshot it saw. On top: ``critical_path`` walks
the span DAG to the chain bounding a query's makespan, and
``to_chrome_trace``/``write_chrome_trace`` emit a Perfetto-loadable
timeline.
"""

from repro_torch.obs.audit import (
    AuditEntry,
    DecisionAuditLog,
    bound_app,
    get_audit_log,
    set_audit_log,
)
from repro_torch.obs.critical_path import CriticalPath, PathStep, critical_path
from repro_torch.obs.export import (
    to_chrome_trace,
    validate_chrome_trace,
    write_bench_artifacts,
    write_chrome_trace,
)
from repro_torch.obs.tracer import Span, Tracer, get_tracer, set_tracer

__all__ = [
    "AuditEntry",
    "CriticalPath",
    "DecisionAuditLog",
    "PathStep",
    "Span",
    "Tracer",
    "bound_app",
    "critical_path",
    "get_audit_log",
    "get_tracer",
    "set_audit_log",
    "set_tracer",
    "to_chrome_trace",
    "validate_chrome_trace",
    "write_bench_artifacts",
    "write_chrome_trace",
]
