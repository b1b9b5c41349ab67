"""Thread-safe span tracer with a bounded ring buffer.

A ``Span`` is one timed region of runtime work, tagged with a *trace id*
(the application/query name — every span of one query shares it), a
category (``scheduler`` | ``executor`` | ``invoker`` | ``store`` |
``kernel`` | ``wait``) and free-form attributes. Spans form a DAG:

* within a thread, ``tracer.span(...)`` nests — the innermost open span is
  the default parent (a store read inside a function body parents to the
  invocation span automatically);
* across threads, layers publish *anchors*: the executor anchors each
  stage span under ``("stage", app, stage)`` and the invoker — running in
  a worker thread with an empty stack — parents its invocation spans to
  the anchored stage span. The scheduler likewise anchors the query root
  under ``("query", app)``.

The tracer is on by default and cheap enough to stay on: a finished span
is one dataclass plus one lock-guarded ``deque.append`` into a ring buffer
(``capacity`` spans — old spans fall off, the tracer never grows without
bound), and with ``enabled=False`` every entry point is an early-out no-op
(the CI smoke benchmark asserts the enabled-vs-disabled overhead stays
under 5%). Timestamps are ``time.perf_counter()`` — the same clock as
``InvocationRecord`` — so spans and metrics line up.

``count(track, value)`` records counter samples (e.g. live store bytes per
app, slots in use per node) that the Chrome-trace exporter renders as
counter tracks; ``delta=True`` samples are integrated at export time.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field


_CURRENT = object()     # sentinel: parent = the calling thread's open span


@dataclass
class Span:
    """One finished (or in-flight) timed region of runtime work."""

    span_id: int
    trace: str                     # trace id: the app/query name
    name: str                      # e.g. "stage/join", "query/scan_fact/3"
    cat: str                       # scheduler|executor|invoker|store|kernel|wait
    start: float                   # perf_counter seconds
    end: float = 0.0
    parent_id: int | None = None
    node: int | None = None        # placement, when the work has one
    attrs: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return max(0.0, self.end - self.start)


class Tracer:
    """Bounded, thread-safe collector of spans and counter samples."""

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        self._lock = threading.Lock()
        self.enabled = enabled
        self.capacity = int(capacity)
        self._spans: deque[Span] = deque(maxlen=self.capacity)
        # (ts, track, value, is_delta)
        self._counters: deque[tuple[float, str, float, bool]] = \
            deque(maxlen=self.capacity)
        self._anchors: dict[object, Span] = {}
        self._ids = itertools.count(1)
        self._tls = threading.local()

    # -- per-thread span stack (intra-thread parenting) -----------------------

    def _stack(self) -> list[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Span | None:
        """The calling thread's innermost open span, if any."""
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    # -- span lifecycle -------------------------------------------------------

    def start(self, name: str, cat: str, trace: str | None = None,
              node: int | None = None, parent=_CURRENT, **attrs,
              ) -> Span | None:
        """Open a span (not pushed on the thread stack — pair with ``end``).

        ``parent`` defaults to the calling thread's innermost open span;
        pass an explicit ``Span`` (e.g. an anchor) or ``None`` for a root.
        ``trace`` inherits from the parent when omitted.
        """
        if not self.enabled:
            return None
        if parent is _CURRENT:
            parent = self.current()
        if trace is None:
            trace = parent.trace if parent is not None else "global"
        return Span(next(self._ids), trace, name, cat, time.perf_counter(),
                    parent_id=parent.span_id if parent is not None else None,
                    node=node, attrs=attrs)

    def end(self, span: Span | None, **attrs) -> None:
        """Close a span and commit it to the ring buffer."""
        if span is None:
            return
        span.end = time.perf_counter()
        if attrs:
            span.attrs.update(attrs)
        with self._lock:
            self._spans.append(span)

    @contextmanager
    def span(self, name: str, cat: str, trace: str | None = None,
             node: int | None = None, parent=_CURRENT, **attrs):
        """Context-managed span, pushed on the thread stack so spans opened
        inside (same thread) parent to it automatically."""
        if not self.enabled:
            yield None
            return
        sp = self.start(name, cat, trace=trace, node=node, parent=parent,
                        **attrs)
        self._stack().append(sp)
        try:
            yield sp
        finally:
            self._stack().pop()
            self.end(sp)

    @contextmanager
    def adopt(self, span: Span | None):
        """Adopt another thread's open span as this thread's innermost
        parent — the cross-thread hand-off for helper threads (prefetch,
        speculation backups) whose own stack is empty: spans they open
        while the adoption is active parent to ``span`` instead of landing
        orphaned. Purely a stack push; the adopted span's timing is not
        touched."""
        if not self.enabled or span is None:
            yield span
            return
        self._stack().append(span)
        try:
            yield span
        finally:
            self._stack().pop()

    def record(self, name: str, cat: str, start: float,
               end: float | None = None, trace: str | None = None,
               node: int | None = None, parent=_CURRENT, **attrs,
               ) -> Span | None:
        """Commit an already-elapsed region retroactively — used for waits
        recorded only when blocking actually occurred (a slot-gate wait, a
        failed-claim release wait, admission queueing)."""
        if not self.enabled:
            return None
        if parent is _CURRENT:
            parent = self.current()
        if trace is None:
            trace = parent.trace if parent is not None else "global"
        sp = Span(next(self._ids), trace, name, cat, start,
                  end=time.perf_counter() if end is None else end,
                  parent_id=parent.span_id if parent is not None else None,
                  node=node, attrs=attrs)
        with self._lock:
            self._spans.append(sp)
        return sp

    # -- anchors (cross-thread parenting) -------------------------------------

    def anchor(self, key, span: Span | None) -> None:
        """Publish an open span under ``key`` so work in *other* threads can
        parent to it (``("query", app)``, ``("stage", app, stage)``)."""
        if span is None:
            return
        with self._lock:
            self._anchors[key] = span

    def anchored(self, key) -> Span | None:
        if not self.enabled:
            return None
        with self._lock:
            return self._anchors.get(key)

    def release_anchor(self, key) -> None:
        with self._lock:
            self._anchors.pop(key, None)

    # -- counter tracks -------------------------------------------------------

    def count(self, track: str, value: float, delta: bool = False) -> None:
        """Record a counter sample (absolute, or a ``delta`` to integrate at
        export time) — e.g. ``store_bytes/<app>`` or ``slots/node<N>``."""
        if not self.enabled:
            return
        ts = time.perf_counter()
        with self._lock:
            self._counters.append((ts, str(track), float(value), bool(delta)))

    # -- snapshots ------------------------------------------------------------

    def spans(self, trace: str | None = None) -> list[Span]:
        """Finished spans (ring-buffer order ≈ end time), optionally for one
        trace id."""
        with self._lock:
            snap = list(self._spans)
        if trace is None:
            return snap
        return [s for s in snap if s.trace == trace]

    def counters(self) -> list[tuple[float, str, float, bool]]:
        with self._lock:
            return list(self._counters)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self._anchors.clear()


_default = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer every runtime layer reports into."""
    return _default


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the global tracer (tests, a disabled tracer for overhead runs);
    returns the previous one."""
    global _default
    prev, _default = _default, tracer
    return prev
