"""Chrome-trace (Perfetto-loadable) JSON export of the span buffer (the
port of ``repro/obs/export.py``, pure Python over the port's tracer).

Layout: each cluster node becomes one *process* (``pid = 10 + node``) whose
threads are slot lanes — concurrent invocations on a node are packed into
as few lanes as they genuinely overlap, so the lane count *is* the node's
observed slot occupancy. Control-plane spans (scheduler roots, stage
lifecycle, recovery — no node) live in a ``control-plane`` process with
one lane set per query. Counter samples (``store_bytes/<app>``, live store
footprint; ``slots/node<N>``, slots in use) become ``ph:"C"`` counter
tracks; delta samples are integrated here.

Open the artifact at https://ui.perfetto.dev (or chrome://tracing).
"""

from __future__ import annotations

import json

CONTROL_PID = 1
NODE_PID_BASE = 10


def _assign_lanes(tops) -> dict[int, int]:
    """Interval-pack top-level spans into the fewest lanes (span_id->lane)."""
    lanes: list[float] = []        # last end per lane
    out: dict[int, int] = {}
    for s in sorted(tops, key=lambda s: (s.start, s.end)):
        for i, last_end in enumerate(lanes):
            if s.start >= last_end - 1e-9:
                lanes[i] = s.end
                out[s.span_id] = i
                break
        else:
            out[s.span_id] = len(lanes)
            lanes.append(s.end)
    return out


def to_chrome_trace(tracer, app: str | None = None) -> dict:
    """Render the tracer's buffer as a Chrome-trace dict (one query when
    ``app`` is given, the whole buffer otherwise)."""
    spans = tracer.spans(app)
    counters = tracer.counters()
    if app is not None:
        counters = [c for c in counters
                    if c[1].endswith(f"/{app}") or c[1].startswith("slots")]
    if not spans and not counters:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    t0 = min([s.start for s in spans] + [c[0] for c in counters])
    by_id = {s.span_id: s for s in spans}

    def pid(s) -> int:
        return CONTROL_PID if s.node is None else NODE_PID_BASE + int(s.node)

    # lane packing per process: tops are spans whose parent lives in a
    # different process (or outside the exported set); descendants inherit
    # their top ancestor's lane
    groups: dict[int, list] = {}
    for s in spans:
        groups.setdefault(pid(s), []).append(s)
    lane_of: dict[int, tuple[int, int]] = {}   # span_id -> (pid, tid)
    events: list[dict] = []
    for p, members in sorted(groups.items()):
        tops = [s for s in members
                if s.parent_id not in by_id or pid(by_id[s.parent_id]) != p]
        lanes = _assign_lanes(tops)
        for s in tops:
            lane_of[s.span_id] = (p, lanes[s.span_id])
        pname = "control-plane" if p == CONTROL_PID \
            else f"node {p - NODE_PID_BASE}"
        events.append({"ph": "M", "name": "process_name", "pid": p, "tid": 0,
                       "args": {"name": pname}})
        for tid in sorted(set(lanes.values())):
            tname = f"lane {tid}" if p == CONTROL_PID else f"slot {tid}"
            events.append({"ph": "M", "name": "thread_name", "pid": p,
                           "tid": tid, "args": {"name": tname}})

    def resolve_lane(s) -> tuple[int, int]:
        cur = s
        hops = 0
        while cur.span_id not in lane_of and hops < 64:
            parent = by_id.get(cur.parent_id)
            if parent is None or pid(parent) != pid(s):
                return (pid(s), 0)
            cur = parent
            hops += 1
        return lane_of.get(cur.span_id, (pid(s), 0))

    for s in spans:
        p, tid = resolve_lane(s)
        events.append({
            "name": s.name, "cat": s.cat, "ph": "X",
            "ts": round((s.start - t0) * 1e6, 3),
            "dur": max(round(s.seconds * 1e6, 3), 0.001),
            "pid": p, "tid": tid,
            "args": dict(s.attrs, trace=s.trace),
        })

    # counter tracks: integrate delta samples per track, clamp at zero
    by_track: dict[str, list] = {}
    for ts, track, value, is_delta in counters:
        by_track.setdefault(track, []).append((ts, value, is_delta))
    for track, samples in sorted(by_track.items()):
        running = 0.0
        for ts, value, is_delta in sorted(samples):
            running = max(0.0, running + value) if is_delta else value
            events.append({"name": track, "cat": "counter", "ph": "C",
                           "pid": CONTROL_PID, "tid": 0,
                           "ts": round((ts - t0) * 1e6, 3),
                           "args": {"value": running}})

    events.sort(key=lambda e: (e.get("ts", -1), e["pid"], e["tid"]))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracer, app: str | None = None) -> dict:
    """Export the buffer to ``path``; returns the trace dict."""
    trace = to_chrome_trace(tracer, app=app)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def write_bench_artifacts(bench_path, apps=(), tracer=None) -> dict:
    """Benchmark exit hook: write ``TRACE_<name>.json`` next to a
    ``BENCH_<name>.json`` artifact and compute each listed app's critical
    path. Returns ``{"trace": path, "critical_path": {app: cp_dict}}`` —
    the ``observability`` block the benchmarks embed in their reports.
    """
    import os

    from repro_torch.obs.critical_path import critical_path
    from repro_torch.obs.tracer import get_tracer

    tr = tracer if tracer is not None else get_tracer()
    bench_path = os.fspath(bench_path)
    d, name = os.path.split(bench_path)
    if name.startswith("BENCH_"):
        name = name[len("BENCH_"):]
    trace_path = os.path.join(d, "TRACE_" + name)
    write_chrome_trace(trace_path, tr)
    spans = tr.spans()
    cps = {}
    for app in apps:
        cp = critical_path(spans, app=app)
        if cp is not None:
            cps[app] = cp.to_dict()
    return {"trace": trace_path, "critical_path": cps}


def validate_chrome_trace(trace) -> dict:
    """Structural validation of a Chrome-trace dict (or JSON string).

    Raises ``ValueError`` on malformed input; returns summary stats —
    ``{"events", "cats", "counter_tracks", "pids"}`` — the integrity tests
    and the CI smoke step assert against.
    """
    if isinstance(trace, (str, bytes)):
        trace = json.loads(trace)
    if not isinstance(trace, dict) or \
            not isinstance(trace.get("traceEvents"), list):
        raise ValueError("not a Chrome-trace object: missing traceEvents")
    cats: set[str] = set()
    tracks: set[str] = set()
    pids: set[int] = set()
    n = 0
    for ev in trace["traceEvents"]:
        if not isinstance(ev, dict) or "ph" not in ev or "pid" not in ev:
            raise ValueError(f"malformed event: {ev!r}")
        pids.add(int(ev["pid"]))
        if ev["ph"] == "X":
            if not (isinstance(ev.get("ts"), (int, float))
                    and isinstance(ev.get("dur"), (int, float))
                    and ev["ts"] >= 0 and ev["dur"] > 0 and "name" in ev):
                raise ValueError(f"malformed duration event: {ev!r}")
            cats.add(ev.get("cat", ""))
            n += 1
        elif ev["ph"] == "C":
            if "value" not in ev.get("args", {}):
                raise ValueError(f"malformed counter event: {ev!r}")
            tracks.add(ev["name"])
    return {"events": n, "cats": sorted(cats),
            "counter_tracks": sorted(tracks), "pids": sorted(pids)}
