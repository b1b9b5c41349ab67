"""Decision audit log: every ``DecisionNode`` binding, with what it saw.

The paper's Fig. 5 loop (system knowledge in, decision tuple out) is only
inspectable if each binding records its inputs: the profile/feedback
snapshot, the observed data distributions, the free-slot view, the
candidate implementations, and the decisions already bound upstream.
``DecisionNode.decide`` reports every binding here; the log is bounded and
thread-safe, and ``sequence(app)`` reproduces exactly the ``(stage, func)``
decision sequence the differential tests diff against the simulator.

Decision nodes don't know which query they are deciding for — the caller
does. ``bound_app(app)`` sets a thread-local attribution scope around the
``decide`` call: ``WorkflowRun.decide`` binds its run's app, the executor's
recovery policy binds the failing app, the speculation policy binds the
straggling invocation's app.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field


_tls = threading.local()


@contextmanager
def bound_app(app: str | None):
    """Attribute decisions made inside this scope (same thread) to ``app``."""
    stack = getattr(_tls, "apps", None)
    if stack is None:
        stack = _tls.apps = []
    stack.append(app)
    try:
        yield
    finally:
        stack.pop()


def current_app() -> str | None:
    stack = getattr(_tls, "apps", None)
    return stack[-1] if stack else None


def _dist_summary(data_dist) -> dict:
    out = {}
    for name, d in (data_dist or {}).items():
        out[name] = {"bytes": int(getattr(d, "size", 0)),
                     "rows": int(getattr(d, "rows", 0)),
                     "skew": float(getattr(d, "skew", 0.0))}
    return out


@dataclass
class AuditEntry:
    """One decision binding: the chosen tuple plus the context snapshot."""

    seq: int                       # global binding order
    ts: float                      # perf_counter at binding
    app: str | None                # query the binding was attributed to
    node: str                      # decision node name
    func: str                      # chosen implementation variant
    scale: int
    schedule: str                  # placement policy name
    nodes: tuple[int, ...] = ()    # placement candidate node set
    extras: tuple = ()
    candidates: tuple[str, ...] = ()   # the variants the node chooses among
    profile: dict = field(default_factory=dict)
    data_dist: dict = field(default_factory=dict)  # name -> bytes/rows/skew
    prior: tuple[tuple[str, str], ...] = ()  # (stage, func) bound upstream
    free_slots: dict = field(default_factory=dict)

    def format(self) -> str:
        dists = ", ".join(f"{k}={v['bytes']}B/{v['rows']}r"
                          f"(skew {v['skew']:.2f})"
                          for k, v in sorted(self.data_dist.items()))
        return (f"#{self.seq} [{self.app or '-'}] {self.node}: "
                f"{self.func} x{self.scale} via {self.schedule}"
                f"{list(self.nodes)}"
                f" | candidates {list(self.candidates) or '[]'}"
                f" | prior {list(self.prior) or '[]'}"
                f" | dist {{{dists}}}")


class DecisionAuditLog:
    """Bounded, thread-safe log of decision bindings."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self._lock = threading.Lock()
        self.enabled = enabled
        self.capacity = int(capacity)
        self._entries: deque[AuditEntry] = deque(maxlen=self.capacity)
        self._seq = itertools.count(1)

    def record(self, node, ctx, decision, app: str | None = None,
               ) -> AuditEntry | None:
        """Called by ``DecisionNode.decide``; ``app`` defaults to the
        thread's ``bound_app`` scope."""
        if not self.enabled:
            return None
        entry = AuditEntry(
            next(self._seq), time.perf_counter(),
            app if app is not None else current_app(), node.name,
            decision.func, int(decision.scale),
            decision.schedule.policy, tuple(decision.schedule.nodes),
            tuple(decision.extras),
            tuple(getattr(node, "candidates", ()) or ()),
            dict(ctx.profile or {}), _dist_summary(ctx.data_dist),
            tuple((k, d.func) for k, d in (ctx.decisions or {}).items()),
            dict(getattr(ctx.node_status, "free_slots", {}) or {}))
        with self._lock:
            self._entries.append(entry)
        return entry

    def entries(self, app: str | None = None, node: str | None = None,
                ) -> list[AuditEntry]:
        with self._lock:
            snap = list(self._entries)
        return [e for e in snap
                if (app is None or e.app == app)
                and (node is None or e.node == node)]

    def sequence(self, app: str | None = None,
                 nodes=None) -> list[tuple[str, str]]:
        """The ``(node, func)`` binding sequence — directly diffable against
        ``WorkflowRun.sequence``'s ``(stage, decision.func)`` pairs.
        ``nodes`` restricts to a node-name subset (e.g. a workflow's stages,
        excluding interleaved speculation/recovery bindings)."""
        keep = set(nodes) if nodes is not None else None
        return [(e.node, e.func) for e in self.entries(app)
                if keep is None or e.node in keep]

    def format(self, app: str | None = None) -> str:
        return "\n".join(e.format() for e in self.entries(app))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_default = DecisionAuditLog()


def get_audit_log() -> DecisionAuditLog:
    return _default


def set_audit_log(log: DecisionAuditLog) -> DecisionAuditLog:
    global _default
    prev, _default = _default, log
    return prev
