"""Critical-path analysis over a query's span DAG (the port of
``repro/obs/critical_path.py``, pure Python over the port's tracer).

Walks the stage dependency edges (recorded on the executor's ``stage/*``
spans) backwards from the invocation that finishes last, at each stage
picking the *bounding* invocation — the one whose completion gated the
downstream stage. For every step the invocation's wall time is split:

* ``store``     — time inside direct child ``store`` spans (put/get,
                  including emulated transfer),
* ``slot_wait`` — time inside child ``wait`` spans (fair-share gate waits,
                  failed-claim release waits; a batched member also charges
                  its enclosing batch's waits),
* ``compute``   — the remainder of the span,
* ``queue``     — the gap between the predecessor step's end and this
                  step's start (scheduling/driver latency, admission).

The totals answer the operator's question directly: *is this query bound
by compute, data movement, slot contention, or queueing?* Pipelined
(partition-granularity) execution makes producer and consumer spans
overlap; the path then follows the earliest-released producer with a zero
queue gap, and the breakdown attributes each wall-clock instant to exactly
one step (chronological frontier walk), so the phase totals sum to the
makespan whether stages barrier or pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.obs.tracer import Span

PHASES = ("compute", "store", "slot_wait", "queue")


@dataclass
class PathStep:
    """One invocation on the critical path, with its time split."""

    name: str
    stage: str
    node: int | None
    start: float
    end: float
    compute: float
    store: float
    slot_wait: float
    queue: float                   # gap behind the predecessor on the path

    @property
    def seconds(self) -> float:
        return max(0.0, self.end - self.start)

    def to_dict(self) -> dict:
        return {"name": self.name, "stage": self.stage, "node": self.node,
                "seconds": round(self.seconds, 6),
                "compute": round(self.compute, 6),
                "store": round(self.store, 6),
                "slot_wait": round(self.slot_wait, 6),
                "queue": round(self.queue, 6)}


@dataclass
class CriticalPath:
    """The chain bounding one query's makespan, plus its time breakdown."""

    app: str
    makespan: float                # trace start -> last invocation end
    steps: list[PathStep] = field(default_factory=list)
    breakdown: dict = field(default_factory=dict)

    @property
    def dominant(self) -> str:
        """The phase that bounds the path (largest breakdown share)."""
        if not self.breakdown:
            return "unknown"
        return max(self.breakdown, key=self.breakdown.get)

    def to_dict(self) -> dict:
        return {"app": self.app, "makespan_s": round(self.makespan, 6),
                "dominant": self.dominant,
                "breakdown": {k: round(v, 6)
                              for k, v in self.breakdown.items()},
                "steps": [s.to_dict() for s in self.steps]}

    def format(self) -> str:
        lines = [f"critical path [{self.app}]: makespan "
                 f"{self.makespan * 1e3:.2f} ms, dominant phase "
                 f"{self.dominant}",
                 "  breakdown: " + "  ".join(
                     f"{k} {self.breakdown.get(k, 0.0) * 1e3:.2f}ms"
                     for k in PHASES)]
        for s in self.steps:
            lines.append(
                f"  {s.stage:14s} {s.name:28s} node={s.node} "
                f"total {s.seconds * 1e3:7.2f}ms  "
                f"compute {s.compute * 1e3:7.2f}  store {s.store * 1e3:7.2f}"
                f"  slot_wait {s.slot_wait * 1e3:7.2f}"
                f"  queue {s.queue * 1e3:7.2f}")
        return "\n".join(lines)


def _split(span: Span, children: dict, by_id: dict,
           ) -> tuple[float, float, float]:
    """(compute, store, slot_wait) seconds for one invocation span."""
    store = sum(c.seconds for c in children.get(span.span_id, ())
                if c.cat == "store")
    wait = sum(c.seconds for c in children.get(span.span_id, ())
               if c.cat == "wait")
    parent = by_id.get(span.parent_id)
    if parent is not None and parent.cat == "invoker" and \
            parent.attrs.get("kind") == "batch":
        # a batched member: the claim/gate waits were paid by the batch
        wait += sum(c.seconds for c in children.get(parent.span_id, ())
                    if c.cat == "wait")
    compute = max(0.0, span.seconds - store - wait)
    return compute, store, wait


def critical_path(spans, app: str | None = None) -> CriticalPath | None:
    """Compute the critical path from a span list (e.g. ``tracer.spans()``).

    Returns ``None`` when the trace holds no invocation spans for ``app``.
    """
    if app is not None:
        spans = [s for s in spans if s.trace == app]
    spans = list(spans)
    if not spans:
        return None

    by_id = {s.span_id: s for s in spans}
    children: dict[int, list[Span]] = {}
    for s in spans:
        if s.parent_id is not None:
            children.setdefault(s.parent_id, []).append(s)

    stage_deps: dict[str, tuple[str, ...]] = {}
    for s in spans:
        if s.cat == "executor" and "stage" in s.attrs:
            deps = tuple(s.attrs.get("deps", ()) or ())
            prev = stage_deps.get(s.attrs["stage"], ())
            stage_deps[s.attrs["stage"]] = tuple(dict.fromkeys(prev + deps))

    by_stage: dict[str, list[Span]] = {}
    invs = [s for s in spans
            if s.cat == "invoker" and s.attrs.get("kind") == "invocation"]
    for s in invs:
        by_stage.setdefault(s.attrs.get("stage", s.name), []).append(s)
    if not invs:
        return None

    trace_start = min(s.start for s in spans)
    terminal = max(invs, key=lambda s: s.end)

    chain: list[tuple[Span, float]] = []    # (span, queue gap behind it)
    cur = terminal
    visited = {cur.attrs.get("stage", cur.name)}
    while True:
        preds = [p for d in stage_deps.get(cur.attrs.get("stage", ""), ())
                 for p in by_stage.get(d, ())
                 if p.attrs.get("stage") not in visited]
        if not preds:
            chain.append((cur, max(0.0, cur.start - trace_start)))
            break
        # A predecessor only *gated* this invocation if it finished before
        # the invocation started; among those the latest finisher is the
        # binding one. Under a pipelined (partition-granularity) launch the
        # consumer may start before any producer ends — producer and
        # consumer spans genuinely overlap — so when no predecessor
        # finished in time, follow the one released first (earliest end):
        # it bounds how early the overlap could begin, and the queue gap
        # is zero because nothing idled between the two.
        gating = [p for p in preds if p.end <= cur.start]
        if gating:
            pred = max(gating, key=lambda s: s.end)
            gap = max(0.0, cur.start - pred.end)
        else:
            pred = min(preds, key=lambda s: s.end)
            gap = 0.0
        chain.append((cur, gap))
        visited.add(pred.attrs.get("stage", pred.name))
        cur = pred

    steps = []
    for span, gap in reversed(chain):
        compute, store, wait = _split(span, children, by_id)
        steps.append(PathStep(span.name, span.attrs.get("stage", span.name),
                              span.node, span.start, span.end, compute,
                              store, wait, gap))
    # Aggregate via a chronological frontier walk so overlapped path steps
    # are only counted once: each step contributes the wall-clock window it
    # *extends* beyond everything already attributed (w), with its
    # compute/store/wait split scaled into that window, plus any idle gap
    # before it. The totals therefore sum to the makespan even when
    # pipelined steps overlap; on non-overlapping chains w equals the
    # step's full duration and the numbers are unchanged.
    breakdown = {k: 0.0 for k in PHASES}
    frontier = trace_start
    for s in sorted(steps, key=lambda s: s.start):
        breakdown["queue"] += max(0.0, s.start - frontier)
        w = max(0.0, s.end - max(s.start, frontier))
        scale = (w / s.seconds) if s.seconds > 0 else 0.0
        breakdown["compute"] += s.compute * scale
        breakdown["store"] += s.store * scale
        breakdown["slot_wait"] += s.slot_wait * scale
        frontier = max(frontier, s.end)
    return CriticalPath(app if app is not None else terminal.trace,
                        max(0.0, terminal.end - trace_start), steps,
                        breakdown)
