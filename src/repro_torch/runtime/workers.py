"""The process-backed worker plane: real parallelism, cold-start economics.

Both in-process invokers (``InlineInvoker``, ``ThreadPoolInvoker``) run
function bodies under one GIL, so their "parallelism" is a concurrency
simulation for CPU-bound work. ``ProcessPoolInvoker`` executes bodies in
long-lived **worker subprocesses** — the lithops invoker/worker split, with
Lambada-style burst fan-out economics modeled explicitly:

* **Protocol.** Host and worker speak a pickle task protocol over a duplex
  pipe: the host sends ``("run", task)`` (function name + params + writer
  label), the worker answers with store RPCs (``get``/``partitions`` —
  serviced by the host *inside the invocation span*, so store reads are
  accounted and traced exactly like in-process execution), then
  ``("done", writes, metrics)``. ``Table``/``TableSlice`` payloads are
  serialized to plain numpy column dicts — device tensors and zero-copy
  views do not cross process boundaries. The worker rebuilds each table it
  reads as tensors on its own device, and ships what it writes back as
  numpy (the host stores those columns as they arrive, like the bucket
  views of the threads backend).
* **Buffered writes.** A worker never touches the shuffle store directly:
  its ``put``/``put_many`` calls are buffered worker-side and committed by
  the host only after the body completes — so a worker SIGKILLed
  mid-invocation leaves **no partial store writes**, and quota admission
  (with eviction/retry) stays a host-side concern. Commit happens before
  the injector's ``after_body`` hook, preserving crash-after-write retry
  semantics.
* **Cold starts.** ``WorkerPool`` provisions workers on demand: a cold
  start pays the real subprocess spawn + registry import plus a modeled
  ``provision_s`` floor (the serverless platform's container start). Warm
  idle workers are reused (LIFO — warmest first) and reaped after
  ``idle_reap_s``. The pool bills **function-seconds** (busy wall +
  provision charges) — the cost proxy the elastic benchmark reports.
* **Elasticity.** ``resize(n)`` pre-warms or shrinks the pool; the planner
  drives it from the ``elasticity_node`` decision
  (``repro_torch.core.decisions``), whose twin lives in the cluster
  simulator so decision sequences stay plane-identical.
* **Faults.** A worker that dies mid-invocation (``WorkerKillFault``
  SIGKILL, OOM, a real crash) surfaces as ``WorkerKilledError`` — an
  ``InjectedCrashError`` subclass — so the invoker's existing machinery
  records a crashed attempt, releases the slot claim, and retries on a
  freshly provisioned worker.
* **The card.** Each worker opens its own CUDA context on the pool's
  device (the card unless the caller passes ``device="cpu"``) at its cold
  start. Workers are always spawned: the host holds a live CUDA context, so
  ``fork`` is refused on the card. The host builds the kernel libraries
  before its first spawn, so a worker only loads them. A worker that
  cannot open the card reports it and the host raises ``InvocationError``;
  nothing falls back to the CPU. Each task's metrics carry the kernel
  launches it made (``kernels.partition.LAUNCHES`` deltas), which the
  invoker sums into ``worker_launches``.
"""

from __future__ import annotations

import os
import pickle
import signal
import threading
import time
from typing import Any, Callable, Mapping, Sequence

import multiprocessing as mp

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.tracer import get_tracer
from repro_torch.runtime.faults import WorkerKilledError
from repro_torch.runtime.invoker import (FnContext, Invocation,
                                         InvocationError, ThreadPoolInvoker)
from repro_torch.runtime.store import StageLostError


# ---------------------------------------------------------------------------
# Table serialization (host <-> worker)
# ---------------------------------------------------------------------------


def serialize_table(table) -> dict:
    """A ``Table`` / ``TableSlice`` as a plain numpy column dict — the only
    form that crosses the process boundary. Slices materialize first (the
    zero-copy view's parent buffer does not travel); device columns are
    copied to the host."""
    from repro_torch.analytics.table import to_numpy
    if hasattr(table, "materialize"):
        table = table.materialize()
    return {k: to_numpy(v) for k, v in table.columns.items()}


def deserialize_table(cols: dict, device=None):
    """A ``Table`` from a numpy column dict: the arrays as they are (the
    host keeps what workers wrote as numpy), or, given ``device``, tensors
    on it (a worker computes on what it reads)."""
    from repro_torch.analytics.table import Table
    if device is None:
        return Table(dict(cols))
    return Table({k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, non_blocking=False) for k, v in cols.items()})


# ---------------------------------------------------------------------------
# Worker side (runs in the subprocess)
# ---------------------------------------------------------------------------


class _TaskAborted(BaseException):
    """Host-initiated abort of the running body (e.g. a store read hit a
    lost-stage tombstone host-side); unwinds the worker's function body
    without being catchable as a normal error."""


class _WorkerSideContext:
    """The ``FnContext`` the function body sees inside a worker: store reads
    are RPCs to the host, writes are buffered locally until the body
    completes. Mirrors the in-process context's interface exactly, ``device``
    included: the worker's own."""

    def __init__(self, conn, task: dict, device: torch.device):
        self._conn = conn
        self.device = device
        self.app = task["app"]
        self.node = task["node"]
        self.index = task["index"]
        self.params = dict(task["params"])
        self.writer = task["writer"]
        self.honor_plan = task["honor_plan"]
        self._kill = task.get("kill")
        self.rpc_seconds = 0.0
        self.writes: list = []           # buffered, committed host-side
        self.rows_actual = 0
        self.rows_padded = 0
        self.stats: dict = {}            # marshaled home with the metrics

    @property
    def plan(self) -> str:
        if not self.honor_plan:
            return "barrier"
        return str(self.params.get("plan", "barrier"))

    def _rpc(self, *msg):
        if self._kill == "body":
            # deterministic mid-invocation death: the claim is live, the
            # body has started, nothing has been written
            os.kill(os.getpid(), signal.SIGKILL)
        t0 = time.perf_counter()
        self._conn.send(msg)
        reply = self._conn.recv()
        self.rpc_seconds += time.perf_counter() - t0
        if reply[0] == "abort":
            raise _TaskAborted(reply[1])
        return reply[1]

    def get(self, stage: str, partition: int, writers=None):
        cols = self._rpc("get", str(stage), int(partition),
                         None if writers is None else tuple(writers))
        return None if cols is None else deserialize_table(cols, self.device)

    def get_all(self, stage: str):
        from repro_torch.analytics.table import Table
        got = [t for t in (self.get(stage, p)
                           for p in self.partitions(stage))
               if t is not None and t.num_rows]
        return Table.concat_all(got) if got else None

    def partitions(self, stage: str) -> list[int]:
        return list(self._rpc("partitions", str(stage)))

    def prefetch(self, stage: str, partition: int) -> None:
        # double-buffering is a host-side-threads optimization; inside a
        # worker the read order (and thus fault-hook match counts) is
        # preserved by simply reading on demand
        return None

    def put(self, stage: str, partition: int, table) -> None:
        self.writes.append(("put", str(stage), int(partition),
                            serialize_table(table)))

    def put_many(self, stage: str, tables: Mapping[int, Any]) -> None:
        if not tables:
            return
        self.writes.append(("put_many", str(stage),
                            {int(p): serialize_table(t)
                             for p, t in tables.items()}))


def _safe_exc(exc: BaseException):
    """An exception in a pipe-safe form: pickled bytes when possible, else
    ``(type_name, repr)``."""
    try:
        return pickle.dumps(exc)
    except Exception:
        return (type(exc).__name__, repr(exc))


def _describe(payload) -> str:
    """A ``_safe_exc`` payload as text, for an error raised host-side."""
    if isinstance(payload, bytes):
        try:
            return repr(pickle.loads(payload))
        except Exception:
            return "an unpicklable error"
    return f"{payload[0]}: {payload[1]}"


def worker_main(conn, modules: Sequence[str] = (), device=None) -> None:
    """Subprocess entry point: open ``device`` (the card, with a CUDA
    context of its own, unless the caller passes ``"cpu"``) and import the
    function registry (the cold start), handshake, then serve tasks until
    told to stop. A worker that cannot open its device or import the
    registry reports the error instead of ``ready`` and exits."""
    try:
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.zeros((1,), device=dev)    # the context opens here
        for name in modules:
            __import__(name)
        from repro_torch.kernels import partition as kpart
        from repro_torch.kernels.ops import padding_counters
        from repro_torch.runtime.functions import FUNCTIONS
    except BaseException as exc:
        conn.send(("error", _safe_exc(exc)))
        conn.close()
        return
    conn.send(("ready", os.getpid()))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg[0] == "stop":
            conn.send(("bye",))
            conn.close()
            return
        task = msg[1]
        ctx = _WorkerSideContext(conn, task, dev)
        t0 = time.perf_counter()
        pad0 = padding_counters()
        launches0 = dict(kpart.LAUNCHES)
        try:
            fn = FUNCTIONS[task["func"]]
            fn(ctx)
        except _TaskAborted:
            # the host aborted the body (it already has the real error);
            # ack so the pipe is clean for the next task
            conn.send(("aborted",))
            continue
        except BaseException as exc:
            conn.send(("error", _safe_exc(exc),
                       _worker_metrics(ctx, t0, pad0, padding_counters(),
                                       launches0, kpart.LAUNCHES)))
            continue
        if ctx._kill:
            # "late": deterministic post-body death — every write sits in
            # the worker-side buffer and dies with the process (the
            # no-partial-writes invariant's strongest test point). Also the
            # backstop for a "body" kill whose function made no store RPC.
            os.kill(os.getpid(), signal.SIGKILL)
        conn.send(("done", ctx.writes,
                   _worker_metrics(ctx, t0, pad0, padding_counters(),
                                   launches0, kpart.LAUNCHES)))


def _worker_metrics(ctx, t0: float, pad0, pad1, launches0,
                    launches1) -> dict:
    return {"busy_s": time.perf_counter() - t0,
            "rpc_s": ctx.rpc_seconds,
            "rows_actual": pad1[0] - pad0[0],
            "rows_padded": pad1[1] - pad0[1],
            "launches": {k: launches1[k] - launches0.get(k, 0)
                         for k in launches1},
            "stats": dict(ctx.stats),
            "pid": os.getpid()}


# ---------------------------------------------------------------------------
# Host side: the pool and its economics
# ---------------------------------------------------------------------------


class WorkerHandle:
    """One live worker subprocess plus its host-side pipe end."""

    def __init__(self, wid: int, proc, conn, provision_s: float):
        self.id = wid
        self.proc = proc
        self.conn = conn
        self.provision_s = provision_s     # billed cold-start seconds
        self.invocations = 0

    @property
    def pid(self) -> int | None:
        return self.proc.pid

    def stop(self, timeout: float = 2.0) -> None:
        """Graceful stop; escalates to SIGKILL."""
        try:
            self.conn.send(("stop",))
            if self.conn.poll(timeout):
                self.conn.recv()
        except (OSError, EOFError):
            pass
        self.proc.join(timeout)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout)
        try:
            self.conn.close()
        except OSError:
            pass

    def kill(self) -> None:
        self.proc.kill()
        self.proc.join(2.0)
        try:
            self.conn.close()
        except OSError:
            pass


class WorkerPool:
    """Long-lived worker subprocesses with modeled cold-start economics.

    * ``provision_s`` — modeled cold-start floor: a provision that finishes
      faster than this sleeps the remainder (a real platform's container
      start dominates a local ``spawn``); the *measured* provision time is
      what gets billed.
    * ``idle_reap_s`` — workers idle longer than this are reaped (lazily,
      at the next pool interaction, plus explicitly via ``reap_idle``);
      ``None`` disables reaping. ``min_workers`` is the warm floor the
      reaper leaves.
    * ``resize(n)`` — pre-warm up to ``n`` workers (the elasticity
      decision's grow path) or retire idle ones down to ``n``.
    * Cost proxy: ``cost_function_seconds()`` = Σ busy wall + Σ provision
      charges, the figure the elastic benchmark compares warm-pool reuse
      against cold-start-every-time.

    Workers are started with the "spawn" method. ``fork`` is refused on
    the card (``device`` is the card unless ``"cpu"`` is passed): a forked
    child of a process with a live CUDA context cannot use the card, and
    fork is unsafe once the host runs threads. On the card the host builds
    the kernel libraries before the first spawn, so no worker compiles.
    ``stats()["peak_size"]`` is the most workers the pool has held at once.
    """

    def __init__(self, max_workers: int = 4, provision_s: float = 0.0,
                 idle_reap_s: float | None = None, min_workers: int = 0,
                 modules: Sequence[str] = (), start_method: str = "spawn",
                 device=None):
        if start_method == "fork" and \
                torch.device("cuda" if device is None else device).type \
                == "cuda":
            raise ValueError("workers on the card must be spawned: a "
                             "forked child cannot use the host's CUDA "
                             "context")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # name the host's current card, so every worker opens the same
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._built = self.device.type != "cuda"
        self.max_workers = max(1, int(max_workers))
        self.provision_s = float(provision_s)
        self.idle_reap_s = idle_reap_s
        self.min_workers = int(min_workers)
        self.modules = tuple(modules)
        self._mp = mp.get_context(start_method)
        self._cond = threading.Condition()
        self._idle: list[tuple[WorkerHandle, float]] = []   # LIFO, (w, since)
        self._busy: set[WorkerHandle] = set()
        self._spawning = 0
        self._target = 0            # shrink marker set by resize()
        self._ids = 0
        self._closed = False
        # economics
        self.cold_starts = 0
        self.warm_hits = 0
        self.reaped = 0
        self.provision_seconds = 0.0
        self.busy_seconds = 0.0
        self.peak_size = 0

    # -- provisioning ---------------------------------------------------------

    def _spawn_one(self) -> WorkerHandle:
        if not self._built:
            # the first spawn on the card: compile the kernel libraries in
            # the host (once, not in every worker's cold start)
            from repro_torch.kernels import build
            build.build_all()
            self._built = True
        t0 = time.perf_counter()
        host, child = self._mp.Pipe()
        with self._cond:
            self._ids += 1
            wid = self._ids
        proc = self._mp.Process(target=worker_main,
                                args=(child, self.modules, str(self.device)),
                                daemon=True, name=f"repro-worker-{wid}")
        proc.start()
        child.close()
        if not host.poll(120):
            proc.kill()
            raise InvocationError(f"worker {wid} failed to start")
        try:
            ready = host.recv()
        except (EOFError, OSError) as e:
            proc.kill()
            raise InvocationError(
                f"worker {wid} died during startup (is the parent main "
                f"module spawn-safe?)") from e
        if ready[0] == "error":
            proc.join(5.0)
            if proc.is_alive():
                proc.kill()
            raise InvocationError(
                f"worker {wid} could not start on {self.device}: "
                f"{_describe(ready[1])}")
        if ready[0] != "ready":   # pragma: no cover - handshake is fixed
            proc.kill()
            raise InvocationError(f"worker {wid}: bad handshake {ready[0]!r}")
        elapsed = time.perf_counter() - t0
        if elapsed < self.provision_s:
            # the modeled cold start is a floor on top of the real spawn
            time.sleep(self.provision_s - elapsed)
            elapsed = self.provision_s
        w = WorkerHandle(wid, proc, host, elapsed)
        with self._cond:
            self.cold_starts += 1
            self.provision_seconds += elapsed
        return w

    # -- lease/release --------------------------------------------------------

    def lease(self) -> tuple[WorkerHandle, bool]:
        """A worker to run one invocation on: the warmest idle worker
        (``(worker, cold=False)``), or a freshly provisioned one
        (``cold=True``). Blocks while the pool is at ``max_workers`` with
        nothing idle."""
        while True:
            with self._cond:
                if self._closed:
                    raise InvocationError("worker pool is shut down")
                self._reap_locked()
                if self._idle:
                    w, _ = self._idle.pop()
                    self._busy.add(w)
                    self.warm_hits += 1
                    return w, False
                if (len(self._busy) + len(self._idle) + self._spawning
                        < self.max_workers):
                    self._spawning += 1
                    break
                self._cond.wait(0.1)
        try:
            w = self._spawn_one()
        finally:
            with self._cond:
                self._spawning -= 1
                self._cond.notify_all()
        with self._cond:
            self._busy.add(w)
            self.peak_size = max(self.peak_size, self.size())
        return w, True

    def release(self, w: WorkerHandle, busy_s: float) -> None:
        """Return a worker after an invocation; it joins the warm pool
        unless a shrink target says retire it."""
        retire = False
        with self._cond:
            self._busy.discard(w)
            self.busy_seconds += busy_s
            w.invocations += 1
            if self._target and self.size() >= self._target:
                retire = True    # re-admitting would exceed the shrink target
            else:
                self._idle.append((w, time.monotonic()))
            self._reap_locked()
            self._cond.notify_all()
        if retire:
            w.stop()

    def retire(self, w: WorkerHandle, busy_s: float = 0.0) -> None:
        """Remove a dead/poisoned worker (killed mid-invocation: its pipe
        state is undefined, it can never be reused)."""
        with self._cond:
            self._busy.discard(w)
            self.busy_seconds += busy_s
            self._cond.notify_all()
        w.kill()

    # -- elasticity -----------------------------------------------------------

    def size(self) -> int:
        return len(self._busy) + len(self._idle) + self._spawning

    def resize(self, target: int) -> int:
        """Grow (pre-warm) or shrink the pool toward ``target`` workers;
        returns the resulting size. Growth provisions synchronously — the
        elasticity decision pays cold starts *before* the fan-out arrives,
        which is exactly the provision-latency-hiding it exists for.
        Shrinking retires idle workers now and busy ones as they release.
        """
        target = max(0, min(int(target), self.max_workers))
        with self._cond:
            self._target = target
            to_stop = []
            while self._idle and self.size() > target:
                to_stop.append(self._idle.pop(0)[0])   # oldest first
            need = target - self.size()
        for w in to_stop:
            w.stop()
        for _ in range(max(0, need)):
            with self._cond:
                if self._closed or self.size() >= target:
                    break
                self._spawning += 1
            try:
                w = self._spawn_one()
            finally:
                with self._cond:
                    self._spawning -= 1
            with self._cond:
                self._idle.append((w, time.monotonic()))
                self.peak_size = max(self.peak_size, self.size())
                self._cond.notify_all()
        return self.size()

    def _reap_locked(self) -> None:
        if self.idle_reap_s is None:
            return
        now = time.monotonic()
        keep_floor = max(self.min_workers, self._target)
        doomed = []
        # oldest idle first; never reap below the warm floor
        while self._idle and now - self._idle[0][1] > self.idle_reap_s \
                and self.size() > keep_floor:
            doomed.append(self._idle.pop(0)[0])
        for w in doomed:
            self.reaped += 1
            threading.Thread(target=w.stop, daemon=True).start()

    def reap_idle(self) -> None:
        with self._cond:
            self._reap_locked()

    # -- economics ------------------------------------------------------------

    def cost_function_seconds(self) -> float:
        """The serverless bill: busy function-seconds plus provision
        charges (a cold container's start time is billed, Lambada-style)."""
        with self._cond:
            return self.busy_seconds + self.provision_seconds

    def stats(self) -> dict:
        with self._cond:
            return {"size": self.size(), "peak_size": self.peak_size,
                    "cold_starts": self.cold_starts,
                    "warm_hits": self.warm_hits, "reaped": self.reaped,
                    "provision_seconds": round(self.provision_seconds, 6),
                    "busy_seconds": round(self.busy_seconds, 6),
                    "cost_function_seconds":
                        round(self.busy_seconds + self.provision_seconds, 6)}

    def shutdown(self) -> None:
        with self._cond:
            self._closed = True
            idle = [w for w, _ in self._idle]
            busy = list(self._busy)
            self._idle.clear()
            self._busy.clear()
            self._cond.notify_all()
        for w in idle:
            w.stop()
        for w in busy:
            w.kill()


# ---------------------------------------------------------------------------
# The invoker backend
# ---------------------------------------------------------------------------


class ProcessPoolInvoker(ThreadPoolInvoker):
    """Function bodies run in worker subprocesses; everything else — slot
    claims, retries, batching, speculation, metrics, tracing — is the
    shared invoker machinery (only ``_invoke_body`` is overridden).

    ``max_workers`` bounds both the host-side dispatch threads and the
    worker-process pool. ``prewarm`` provisions that many workers up
    front; ``provision_s``/``idle_reap_s``/``min_workers`` are the
    cold-start model (see ``WorkerPool``). ``modules`` are extra module
    names each worker imports at startup so their ``@register``-ed
    functions exist in the worker's registry. The workers compute on the
    invoker's ``device``. ``worker_launches`` sums the kernel launches the
    workers report per task (``kernels.partition.LAUNCHES`` keys); the
    host's own ``LAUNCHES`` keep counting only this process's calls.
    """

    parallel = True

    def __init__(self, gc, store, metrics=None, max_workers: int = 2,
                 provision_s: float = 0.0, idle_reap_s: float | None = None,
                 min_workers: int = 0, prewarm: int = 0,
                 modules: Sequence[str] = (), **kwargs):
        super().__init__(gc, store, metrics, max_workers=max_workers,
                         **kwargs)
        self.pool = WorkerPool(max_workers=max_workers,
                               provision_s=provision_s,
                               idle_reap_s=idle_reap_s,
                               min_workers=min_workers, modules=modules,
                               device=self.device)
        self.worker_launches: dict[str, int] = {}
        self._launch_lock = threading.Lock()
        if prewarm:
            self.pool.resize(prewarm)

    # -- elasticity surface ---------------------------------------------------

    def pool_size(self) -> int:
        return self.pool.size()

    def resize(self, target: int) -> int:
        return self.pool.resize(target)

    # -- the overridden body hook ---------------------------------------------

    def _invoke_body(self, fn: Callable, inv: Invocation,
                     attempt: int) -> FnContext:
        kill = None
        matcher = getattr(self.injector, "match_worker_kill", None)
        if matcher is not None:
            kill = matcher(inv, attempt)
        ctx = FnContext(self.store, inv, honor_plan=self.honor_plan,
                        device=self.device)
        worker, cold = self.pool.lease()
        tr = get_tracer()
        t0 = time.perf_counter()
        ok = False
        try:
            task = {"func": inv.func, "app": inv.app, "node": inv.node,
                    "index": inv.index, "params": dict(inv.params),
                    "writer": inv.name, "honor_plan": self.honor_plan,
                    "kill": kill.when if kill is not None else None}
            try:
                worker.conn.send(("run", task))
                metrics = self._serve(worker, ctx, inv)
                ok = True
            except WorkerKilledError:
                raise
            except (EOFError, BrokenPipeError, ConnectionResetError,
                    OSError) as e:
                raise WorkerKilledError(
                    f"{inv.name}: worker {worker.id} (pid {worker.pid}) "
                    f"died mid-invocation") from e
            except BaseException:
                # the error arrived over a clean pipe (a worker-reported
                # function error, or a host-side store error after a clean
                # abort/commit) — the worker itself is healthy and reusable
                ok = True
                raise
        finally:
            busy = time.perf_counter() - t0
            if ok:
                self.pool.release(worker, busy)
            else:
                # a worker that died (or whose pipe is in an undefined
                # state) never returns to the warm pool
                self.pool.retire(worker, busy)
        ctx.rows_actual = int(metrics.get("rows_actual", 0))
        ctx.rows_padded = int(metrics.get("rows_padded", 0))
        ctx.stats = dict(metrics.get("stats") or {})
        if tr.enabled:
            # merge the worker's own timing into the host trace: a child
            # span of the invocation bracketing the remote body, with the
            # worker-measured breakdown in its attrs
            tr.record(f"worker/{worker.id}", "invoker", t0, trace=inv.app,
                      node=inv.node, kind="worker_body", worker=worker.id,
                      pid=metrics.get("pid"), cold=cold,
                      busy_s=round(metrics.get("busy_s", 0.0), 6),
                      rpc_s=round(metrics.get("rpc_s", 0.0), 6))
        return ctx

    def _serve(self, worker: WorkerHandle, ctx: FnContext,
               inv: Invocation) -> dict:
        """Service the worker's store RPCs until the body finishes; commit
        its buffered writes; return its metrics. Store access runs in the
        host thread, inside the invocation span — reads are accounted,
        traced, and fault-hooked exactly like in-process execution."""
        conn = worker.conn
        while True:
            msg = conn.recv()                    # EOF => worker died
            kind = msg[0]
            if kind == "get":
                try:
                    t = ctx.get(msg[1], msg[2], writers=msg[3])
                except StageLostError as e:
                    # abort the remote body and surface the typed error
                    # from the host (tombstones must reach lineage
                    # recovery, and exceptions do not pickle reliably)
                    conn.send(("abort", repr(e)))
                    ack = conn.recv()
                    if ack[0] != "aborted":   # pragma: no cover
                        raise WorkerKilledError(
                            f"{inv.name}: worker {worker.id} broke protocol "
                            f"during abort") from e
                    raise
                conn.send(("ok", None if t is None else serialize_table(t)))
            elif kind == "partitions":
                conn.send(("ok", ctx.partitions(msg[1])))
            elif kind == "done":
                self._count_launches(msg[2])
                for w in msg[1]:
                    if w[0] == "put":
                        ctx.put(w[1], w[2], deserialize_table(w[3]))
                    else:
                        ctx.put_many(w[1], {p: deserialize_table(c)
                                            for p, c in w[2].items()})
                return msg[2]
            elif kind == "error":
                self._count_launches(msg[2])
                payload = msg[1]
                if isinstance(payload, bytes):
                    try:
                        exc = pickle.loads(payload)
                    except Exception:
                        exc = None
                    if isinstance(exc, BaseException):
                        raise exc
                    raise InvocationError(
                        f"{inv.name}: worker raised an unpicklable error")
                raise InvocationError(
                    f"{inv.name}: worker raised {payload[0]}: {payload[1]}")
            else:   # pragma: no cover - protocol is fixed
                raise WorkerKilledError(
                    f"{inv.name}: unexpected worker message {kind!r}")

    def _count_launches(self, metrics: dict) -> None:
        with self._launch_lock:
            for k, n in (metrics.get("launches") or {}).items():
                self.worker_launches[k] = self.worker_launches.get(k, 0) + n

    def shutdown(self) -> None:
        self.drain()
        self.pool.shutdown()
