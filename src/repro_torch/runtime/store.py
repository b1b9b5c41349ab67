"""Ephemeral object store for externalized intermediate state.

Serverless functions are stateless; every byte exchanged between stages goes
through an external store (the Lambada/Pocket model adopted by the paper's
substrate). Blobs are keyed ``(app, stage, partition)``; multiple writers may
append slices to the same partition (that *is* the shuffle), each under its
own writer label so a retried (preempted) invocation overwrites its previous
slice instead of duplicating it.

The store keeps per-node byte accounting — bytes resident per home node,
bytes served cross-node per source, bytes read per reader — so shuffle
volumes feed straight back into ``DataDist`` for the decision workflows
(paper Fig. 5 step 4: runtime knowledge flows back into decision nodes).

Storage is tiered (``repro_torch.runtime.storage``): a *primary* backend holds
hot writes (memory by default — zero-copy, today's behavior; disk or the
emulated object store can serve as primary for cold-path testing), and
optional colder *spill* backends hold demoted stages. Under quota pressure
a sealed stage with a spill policy is demoted — serialized into the colder
tier, hot bytes freed, still readable — instead of tombstoned; reads of
demoted blobs go through the backend (latency/bandwidth emulated outside
the lock, dollar cost billed per app) and transparently promote back into
memory when quota headroom allows.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Mapping, Sequence

from repro_torch.core.decisions import DataDist, partition_skew
from repro_torch.obs.tracer import get_tracer
from repro_torch.runtime.storage import make_backend


@dataclass
class Blob:
    """One written slice of a partition: payload (or backend key) plus its
    home node. Hot zero-copy blobs hold ``table``; spilled / keyed blobs
    hold ``key`` into ``tier``'s backend and ``table is None``."""

    table: object            # repro_torch.analytics.table.Table (duck-typed)
    node: int
    nbytes: int
    rows: int
    tier: str = "memory"
    key: str | None = None


class QuotaExceededError(RuntimeError):
    """A write could not be admitted under the application's store quota."""


class PrefetchHandle:
    """A fetch running on a background thread (double-buffered reads).

    ``join`` blocks until the thunk finishes and returns its result,
    re-raising whatever it raised — so a lost-stage tombstone surfaces to
    the consumer at join time exactly as a direct read would. The worker is
    a daemon: a handle abandoned by a crashed invocation never blocks
    shutdown, and its store accounting already happened in the worker (a
    retry's own reads come on top, same as a retried direct read).
    """

    def __init__(self, fn):
        self._result = None
        self._exc: BaseException | None = None
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        daemon=True)
        self._thread.start()

    def _run(self, fn) -> None:
        try:
            self._result = fn()
        except BaseException as e:   # re-raised at join()
            self._exc = e

    def done(self) -> bool:
        return not self._thread.is_alive()

    def join(self):
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        return self._result


class StageLostError(RuntimeError):
    """A read hit shuffle data that *was* written but has since been lost.

    Ephemeral storage may evict consumed stages (quota pressure), the
    executor reclaims ephemeral inputs, and a fault plan may kill stage data
    outright — in all three cases the store leaves a *lost tombstone* per
    evicted partition, so a later reader sees a typed error instead of a
    silent ``None`` (which would corrupt the query). The executor catches
    this error and triggers lineage-based recompute of the lost partitions'
    producer invocations (``repro_torch.runtime.lineage``).
    """

    def __init__(self, app: str, stage: str, partitions=None):
        self.app = app
        self.stage = stage
        self.partitions = tuple(partitions) if partitions is not None \
            else None
        which = "all partitions" if self.partitions is None \
            else f"partitions {list(self.partitions)}"
        super().__init__(
            f"stage {app!r}/{stage!r}: {which} lost (evicted or failed) "
            f"after being written")


class ShuffleStore:
    """Thread-safe ephemeral blob store with per-node byte accounting.

    Lifecycle is per-(app, stage): ``delete_stage`` reclaims a stage as soon
    as its consumers finish, ``clear_app`` tears down a whole query's state.

    Multi-tenant sharing: ``quotas`` caps each application's live footprint
    in the *primary* tier. An over-quota write first reclaims the app's own
    *sealed* stages (consumed-ephemeral state the executor hands back via
    ``reclaim_stage``) — demoting them to a colder backend when a spill
    policy names one, tombstoning them otherwise — then blocks awaiting
    concurrent frees, and finally raises ``QuotaExceededError`` after
    ``quota_timeout`` seconds. ``app_bytes``/``peak_bytes`` expose per-app
    hot live/high-water footprints; ``tier_bytes`` the demoted footprint
    per cold tier; ``storage_cost`` the per-app dollars billed by priced
    backends (the emulated object store).

    ``net_bw`` (bytes/s) optionally emulates the transfer cost: cross-node
    reads block for ``bytes / net_bw`` seconds *outside* the store lock, so
    under a parallel invoker transfers overlap with other stages' compute —
    the first-order cost the discrete-event simulator prices with its NIC
    contention model. With ``disaggregated=True`` the store behaves like the
    fully external storage tier of Lambada/Pocket: *every* read and write is
    charged at ``net_bw``, node-locality earns no discount. ``None``
    (default) keeps all store traffic instantaneous.
    """

    def __init__(self, net_bw: float | None = None,
                 disaggregated: bool = False,
                 quotas: Mapping[str, int] | None = None,
                 quota_timeout: float = 10.0,
                 backend="memory",
                 spill_backends: Sequence | None = None):
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self.net_bw = net_bw
        self.disaggregated = disaggregated
        # (app, stage) -> partition -> writer -> Blob
        self._stages: dict[tuple[str, str], dict[int, dict[str, Blob]]] = {}
        self.resident_bytes: dict[int, int] = {}   # node -> hot blob bytes
        self.written_bytes: dict[int, int] = {}    # node -> cumulative writes
        self.read_bytes: dict[int, int] = {}       # reader node -> bytes read
        self.sent_bytes: dict[int, int] = {}       # source node -> remote reads
        self.cross_node_bytes = 0                  # total shuffle traffic
        # -- storage tiers ---------------------------------------------------
        self._hot = make_backend(backend)
        self._backends = {self._hot.tier: self._hot}
        for b in (spill_backends or ()):
            cold = make_backend(b)
            self._backends[cold.tier] = cold
        self.tier_bytes: dict[str, dict[str, int]] = {}  # tier -> app -> bytes
        self.storage_cost: dict[str, float] = {}         # app -> dollars
        self.demotions: list[tuple[str, str, str, int]] = []
        self.promotions: list[tuple[str, str, int, str, int]] = []
        # app -> {data_stage: cold tier} — the tiering decision's output;
        # reclaim/evict demote these stages instead of tombstoning them
        self._spill: dict[str, dict[str, str]] = {}
        # -- per-application memory quotas (multi-tenant sharing) ------------
        self._quotas: dict[str, int] = dict(quotas or {})
        self.quota_timeout = quota_timeout
        self.app_bytes: dict[str, int] = {}        # app -> hot live bytes
        self.peak_bytes: dict[str, int] = {}       # app -> high-water mark
        # sealed stages: consumed-ephemeral state, readable until quota
        # pressure reclaims it (insertion order == LRU eviction order)
        self._sealed: dict[tuple[str, str], bool] = {}
        self.evictions: list[tuple[str, str, int]] = []
        # lost tombstones: (app, stage) -> {partition id: writer labels
        # still owed}. The owed set is snapshotted at loss time so a
        # partition only heals once EVERY writer that had contributed a
        # slice has re-written it — healing on the first re-write would let
        # a concurrent reader see a partial (subset-of-writers) concat
        # mid-recovery. Reads raise StageLostError until the partition
        # heals or recovery clears the marker.
        self._lost: dict[tuple[str, str], dict[int, set[str]]] = {}
        # fault-injection hook: consulted at the top of every ``get`` so a
        # FaultPlan can lose a stage deterministically on its k-th read
        self.injector = None

    # -- tiers ----------------------------------------------------------------

    @staticmethod
    def _key(app: str, stage: str, partition: int, writer: str) -> str:
        return f"{app}/{stage}/{partition}/{writer}"

    def storage_spec(self) -> dict[str, dict]:
        """Spec of every tier colder than the primary — the cost model the
        tiering decision node prices (on runtime and simulator alike)."""
        return {name: b.spec() for name, b in self._backends.items()
                if b.order > self._hot.order}

    def set_spill_policy(self, app: str,
                         plan: Mapping[str, str] | None) -> None:
        """Install the tiering decision's per-stage plan: entries naming a
        colder backend make ``reclaim_stage``/eviction demote that stage;
        ``"evict"``/``"keep"``/unknown tiers fall back to today's
        tombstone behavior."""
        with self._lock:
            tiers = {s: t for s, t in dict(plan or {}).items()
                     if t in self._backends
                     and self._backends[t].order > self._hot.order}
            if tiers:
                self._spill[app] = tiers
            else:
                self._spill.pop(app, None)

    def spill_policy(self, app: str) -> dict[str, str]:
        with self._lock:
            return dict(self._spill.get(app, {}))

    def app_tier_bytes(self, app: str) -> dict[str, int]:
        """Live bytes per tier for one app (primary tier under its own
        name), for benchmarks and tests."""
        with self._lock:
            out = {self._hot.tier: self.app_bytes.get(app, 0)}
            for tier, per_app in self.tier_bytes.items():
                out[tier] = out.get(tier, 0) + per_app.get(app, 0)
            return out

    def close(self) -> None:
        """Release backend resources (spill tempdirs, emulated buffers)."""
        for b in self._backends.values():
            b.close()

    # -- quotas ---------------------------------------------------------------

    def set_quota(self, app: str, limit: int | None) -> None:
        """Cap an application's hot live footprint at ``limit`` bytes
        (``None`` removes the cap). Writes over the cap first reclaim the
        app's own sealed stages, then block awaiting concurrent frees, then
        raise ``QuotaExceededError`` after ``quota_timeout`` seconds."""
        with self._cond:
            if limit is None:
                self._quotas.pop(app, None)
            else:
                self._quotas[app] = int(limit)
            self._cond.notify_all()

    def quota(self, app: str) -> int | None:
        with self._lock:
            return self._quotas.get(app)

    def _evict_one(self, app: str,
                   exclude: str | None = None) -> tuple[int, float]:
        """Reclaim the app's least-recently-sealed stage; caller holds the
        lock. ``exclude`` names the in-flight write's destination stage,
        which must never evict itself (it would tombstone peer writers'
        committed partitions just to admit one more slice). Stages with a
        spill policy demote to their cold tier; others leave lost
        tombstones (recoverable via lineage), never silently-empty data.
        Returns (bytes freed, emulated backend seconds to pay outside the
        lock)."""
        for key in list(self._sealed):
            if key[0] != app:
                continue
            if exclude is not None and key[1] == exclude:
                continue
            tier = self._spill.get(app, {}).get(key[1])
            if tier is not None and tier in self._backends \
                    and self._backends[tier].order > self._hot.order:
                freed, pending = self._demote_stage_locked(key[0], key[1],
                                                           tier)
                if freed == 0:
                    continue     # already cold: no hot progress, next stage
                self.demotions.append((key[0], key[1], tier, freed))
                return freed, pending
            freed = self.lose_stage(*key)
            self.evictions.append((key[0], key[1], freed))
            return freed, 0.0
        return 0, 0.0

    def _admit(self, app: str, stage: str,
               items: Sequence[tuple[int, str, int]]) -> float:
        """Block (under the lock, via the condition) until the whole batch
        of ``(partition, writer, nbytes)`` slices fits the app's quota,
        reclaiming sealed stages first. Admission is all-or-nothing: a
        refused batch leaves accounting untouched (no partial commits).
        Caller holds the lock. Returns emulated backend seconds incurred
        by admission-path demotions, to pay outside the lock."""
        pending = 0.0
        deadline = None
        while True:
            limit = self._quotas.get(app)
            if limit is None:
                return pending
            parts = self._stages.get((app, stage), {})
            delta = 0
            total = 0
            for partition, writer, nbytes in items:
                old = parts.get(partition, {}).get(writer)
                # only a replaced *hot* slice returns quota headroom; a
                # demoted old slice holds no hot bytes to retract
                if old is not None and old.tier == self._hot.tier:
                    delta += nbytes - old.nbytes
                else:
                    delta += nbytes
                total += nbytes
            if delta <= 0:
                # replacing with a smaller footprint always shrinks hot
                # pressure — admit even if the app is already over quota
                # (e.g. the cap was lowered after the original write)
                return pending
            if self.app_bytes.get(app, 0) + delta <= limit:
                return pending
            if delta > limit:
                # permanently unsatisfiable: even with every other byte of
                # the app freed this batch cannot fit — fail fast instead
                # of pinning the slot for quota_timeout. Report the raw
                # write size AND the net delta: on the replace path the
                # delta (after retracting the replaced slices) is what the
                # quota actually refused.
                raise QuotaExceededError(
                    f"app {app!r}: write of {total} bytes "
                    f"({len(items)} slice(s), net delta {delta} after "
                    f"retracting replaced slices) to stage {stage!r} "
                    f"can never fit quota {limit}")
            freed, sleep = self._evict_one(app, exclude=stage)
            pending += sleep
            if freed:
                continue
            now = time.monotonic()
            if deadline is None:
                deadline = now + self.quota_timeout
            if now >= deadline:
                raise QuotaExceededError(
                    f"app {app!r}: write of {total} bytes "
                    f"(net delta {delta}) to stage {stage!r} exceeds "
                    f"quota {limit} "
                    f"(live {self.app_bytes.get(app, 0)} bytes, nothing "
                    f"sealed to evict, no free within "
                    f"{self.quota_timeout}s)")
            self._cond.wait(deadline - now)

    # -- writes ---------------------------------------------------------------

    def _retract_locked(self, app: str, old: Blob) -> tuple[int, int]:
        """Remove one blob's accounting and backend payload; caller holds
        the lock. Returns ``(hot_bytes, cold_bytes)`` freed."""
        hot = old.tier == self._hot.tier
        if hot:
            self.resident_bytes[old.node] = \
                self.resident_bytes.get(old.node, 0) - old.nbytes
            self.app_bytes[app] = \
                self.app_bytes.get(app, 0) - old.nbytes
        else:
            tb = self.tier_bytes.setdefault(old.tier, {})
            tb[app] = tb.get(app, 0) - old.nbytes
        if old.key is not None:
            self._backends[old.tier].delete(old.key)
        return (old.nbytes, 0) if hot else (0, old.nbytes)

    def _insert_locked(self, app: str, stage: str, partition: int, table,
                       node: int, writer: str, nbytes: int, rows: int,
                       tier: str | None = None) -> float:
        """Insert one already-admitted writer slice; caller holds the lock.
        ``tier`` routes the payload to a cold backend directly (seeded
        cold data, never counted against the hot quota); ``None`` writes
        to the primary. Returns emulated backend seconds to pay outside
        the lock."""
        lost = self._lost.get((app, stage))
        if lost is not None and partition in lost:
            # a producer (retry, speculation backup, lineage recompute)
            # rewriting a lost partition heals it — but only once every
            # writer whose slice was lost has re-written, else a reader
            # racing the recovery sees a partial concat
            owed = lost[partition]
            owed.discard(writer)
            if not owed:
                del lost[partition]
                if not lost:
                    del self._lost[(app, stage)]
        parts = self._stages.setdefault((app, stage), {})
        blobs = parts.setdefault(partition, {})
        old = blobs.get(writer)
        if old is not None:   # preempted attempt being re-done: retract it
            self._retract_locked(app, old)
        target = self._hot if tier is None or tier == self._hot.tier \
            else self._backends[tier]
        pending = 0.0
        blob = Blob(None, node, nbytes, rows, tier=target.tier)
        if target.zero_copy and target is self._hot:
            blob.table = table
        else:
            blob.key = self._key(app, stage, partition, writer)
            target.put_table(blob.key, table)
            if writer != "seed":   # seeded data pre-exists: no write bill
                cost = target.request_cost(nbytes)
                if cost:
                    self.storage_cost[app] = \
                        self.storage_cost.get(app, 0.0) + cost
                pending += target.io_seconds(nbytes, "put")
        blobs[writer] = blob
        self.written_bytes[node] = self.written_bytes.get(node, 0) + nbytes
        if target is self._hot:
            self.resident_bytes[node] = \
                self.resident_bytes.get(node, 0) + nbytes
            self.app_bytes[app] = self.app_bytes.get(app, 0) + nbytes
            self.peak_bytes[app] = max(self.peak_bytes.get(app, 0),
                                       self.app_bytes[app])
            get_tracer().count(f"store_bytes/{app}", self.app_bytes[app])
        else:
            tb = self.tier_bytes.setdefault(target.tier, {})
            tb[app] = tb.get(app, 0) + nbytes
        return pending

    def _put_locked(self, app: str, stage: str, partition: int, table,
                    node: int, writer: str, nbytes: int, rows: int,
                    tier: str | None = None) -> float:
        """Admission + insert of one writer slice; caller holds the lock
        (``_admit`` may block on the condition, releasing it while waiting).
        Returns emulated backend seconds to pay outside the lock."""
        pending = 0.0
        if tier is None or tier == self._hot.tier:
            pending += self._admit(app, stage, [(partition, writer, nbytes)])
            tier = None
        return pending + self._insert_locked(app, stage, partition, table,
                                             node, writer, nbytes, rows,
                                             tier=tier)

    def put(self, app: str, stage: str, partition: int, table, node: int,
            writer: str = "", tier: str | None = None) -> int:
        """Write (or, on retry, replace) one writer's slice of a partition.
        ``tier`` names a cold backend to seed directly (bypasses the hot
        quota — the data never occupies memory). Returns the bytes written.
        """
        tr = get_tracer()
        t0 = time.perf_counter() if tr.enabled else 0.0
        nbytes, rows = int(table.nbytes), int(table.num_rows)
        with self._cond:
            pending = self._put_locked(app, stage, partition, table, node,
                                       writer, nbytes, rows, tier=tier)
        if pending:
            time.sleep(pending)
        # the emulated disaggregated transfer is charged only AFTER quota
        # admission succeeds: a write rejected by the quota (or blocked on
        # eviction) must not pay the transfer once per failed attempt, which
        # would inflate store_seconds and the critical-path store split
        if self.disaggregated and self.net_bw and writer != "seed":
            time.sleep(nbytes / self.net_bw)
        if tr.enabled:
            tr.record(f"put/{stage}", "store", t0, trace=app, node=node,
                      partition=partition, bytes=nbytes)
        return nbytes

    def put_many(self, app: str, stage: str, tables: Mapping[int, object],
                 node: int, writer: str = "") -> int:
        """Write one writer's slices of *many* partitions in a single store
        round trip — the columnar-slice shuffle path: the producer computes
        every bucket in one device pass and publishes them all at once
        (typically ``TableSlice`` views sharing one parent buffer).

        Quota admission covers the batch *total* up front, so a refused
        batch leaves no partial commits behind (accounting, tombstones, and
        the skipped transfer charge all stay untouched). Per-partition byte
        accounting and lost-tombstone healing are identical to
        ``partition``-at-a-time ``put``; the disaggregated transfer charge
        is one sleep for the total bytes (one flow, not P serialized ones).
        Returns total bytes written.
        """
        tr = get_tracer()
        t0 = time.perf_counter() if tr.enabled else 0.0
        sized = [(int(p), t, int(t.nbytes), int(t.num_rows))
                 for p, t in sorted(tables.items())]
        total = sum(nb for _, _, nb, _ in sized)
        with self._cond:
            pending = self._admit(app, stage,
                                  [(p, writer, nb) for p, _, nb, _ in sized])
            for partition, table, nbytes, rows in sized:
                pending += self._insert_locked(app, stage, partition, table,
                                               node, writer, nbytes, rows)
        if pending:
            time.sleep(pending)
        # transfer charged after admission (see ``put``): a quota rejection
        # mid-batch pays nothing for the flow it never completed
        if self.disaggregated and self.net_bw and writer != "seed" and total:
            time.sleep(total / self.net_bw)
        if tr.enabled:
            tr.record(f"put_many/{stage}", "store", t0, trace=app, node=node,
                      partitions=len(sized), bytes=total)
        return total

    def ingest(self, app: str, stage: str, partitions,
               tier: str | None = None) -> list[tuple[int, int]]:
        """Seed base data: a ``{node: table}`` mapping (one partition per
        home node, the classic layout) or a ``[(node, table), ...]``
        sequence (several partitions per node — the fine-grained layout the
        batched map path coalesces). ``tier`` seeds straight into a cold
        backend — the Lambada cold-data scenario: inputs start in the
        object store, first-touch scans read (and promote) through it.

        Returns ``[(partition_index, home_node), ...]`` in index order — the
        planner's view of where the input lives.
        """
        pairs = sorted(partitions.items()) if hasattr(partitions, "items") \
            else list(partitions)
        layout = []
        for idx, (node, table) in enumerate(pairs):
            self.put(app, stage, idx, table, node, writer="seed", tier=tier)
            layout.append((idx, node))
        return layout

    def stage_layout(self, app: str, stage: str) -> list[tuple[int, int]]:
        """``[(partition, home_node), ...]`` of a stage already in the
        store — lets a re-query reuse seeded inputs instead of
        re-ingesting them (the warm half of the cold-data scenario)."""
        with self._lock:
            parts = self._stages.get((app, stage), {})
            return [(p, next(iter(parts[p].values())).node)
                    for p in sorted(parts)]

    # -- reads ----------------------------------------------------------------

    def get(self, app: str, stage: str, partition: int, node: int,
            account: bool = True, writers: Sequence[str] | None = None):
        """Concatenate every writer's slice of a partition (writer-sorted, so
        content is deterministic under concurrent invokers). Remote reads are
        charged to the blob's home node — this is the shuffle/broadcast
        traffic the simulator's NIC model prices. Demoted slices read
        through their backend (emulated latency/bandwidth outside the lock,
        dollar cost billed) and transparently promote back into memory when
        quota headroom allows. ``writers`` restricts the read to that subset
        of writer labels (the skew node's writer-sharded sub-joins each pull
        only their share of a heavy bucket); only the fetched slices are
        accounted and charged. Returns None if absent; raises
        ``StageLostError`` if the partition was written and then
        evicted/killed (the reader must never see silently-missing data)."""
        tr = get_tracer()
        if not tr.enabled:
            return self._get_impl(app, stage, partition, node, account,
                                  writers)
        t0 = time.perf_counter()
        try:
            t = self._get_impl(app, stage, partition, node, account, writers)
        except StageLostError:
            tr.record(f"get/{stage}", "store", t0, trace=app, node=node,
                      partition=partition, status="lost")
            raise
        tr.record(f"get/{stage}", "store", t0, trace=app, node=node,
                  partition=partition,
                  bytes=int(t.nbytes) if t is not None else 0,
                  status="ok" if t is not None else "miss")
        return t

    def get_async(self, app: str, stage: str, partition: int, node: int,
                  account: bool = True,
                  writers: Sequence[str] | None = None) -> PrefetchHandle:
        """``get`` on a background thread — the double-buffered read used by
        the pipelined data plane (fetch bucket k+1 while probing bucket k).
        Accounting and fault hooks run in the worker, once."""
        return PrefetchHandle(
            lambda: self.get(app, stage, partition, node, account, writers))

    def _get_impl(self, app: str, stage: str, partition: int, node: int,
                  account: bool = True,
                  writers: Sequence[str] | None = None):
        remote = 0
        hot_tier = self._hot.tier
        with self._lock:
            if self.injector is not None:
                # fault-injection: a plan may lose this stage right now (the
                # k-th read) — the lost check below then raises
                self.injector.on_get(app, stage, partition, node)
            # the tombstone check must come *before* the presence check: a
            # recovering partition repopulates writer-by-writer, so blobs can
            # be non-empty (a partial subset) while still owed — reading it
            # would concat a subset of the writers' slices
            lost = self._lost.get((app, stage))
            if lost and partition in lost:
                raise StageLostError(app, stage, (partition,))
            blobs = self._stages.get((app, stage), {}).get(partition)
            if not blobs:
                return None
            names = sorted(blobs) if writers is None else \
                [w for w in sorted(blobs) if w in writers]
            if not names:
                return None
            # snapshot under the lock; backend fetches happen outside it
            snap = [(w, blobs[w], blobs[w].table, blobs[w].tier,
                     blobs[w].key, blobs[w].nbytes, blobs[w].node)
                    for w in names]
            if account:
                for _, _, _, tier, _, nb, home in snap:
                    self.read_bytes[node] = \
                        self.read_bytes.get(node, 0) + nb
                    # cold reads are backend traffic, not node-to-node
                    # shuffle: they pay the backend's cost model instead
                    if tier == hot_tier and home != node:
                        remote += nb
                        self.sent_bytes[home] = \
                            self.sent_bytes.get(home, 0) + nb
                        self.cross_node_bytes += nb
        backend_sleep = 0.0
        tables = []
        candidates = []      # cold blobs eligible for promotion
        for w, b, tbl, tier, key, nb, _ in snap:
            if tbl is not None:
                tables.append(tbl)
                continue
            backend = self._backends[tier]
            try:
                t = backend.get_table(key)
            except KeyError:
                # the payload vanished between snapshot and fetch
                # (concurrent loss/teardown): surface as a lost stage, the
                # same contract the chaos suites already hold reads to
                raise StageLostError(app, stage, (partition,)) from None
            if account:
                cost = backend.request_cost(nb)
                if cost:
                    with self._lock:
                        self.storage_cost[app] = \
                            self.storage_cost.get(app, 0.0) + cost
                backend_sleep += backend.io_seconds(nb, "get")
            tables.append(t)
            if account and tier != hot_tier and self._hot.zero_copy:
                candidates.append((w, b, t, tier, key, nb))
        promoted = 0
        for w, b, t, tier, key, nb in candidates:
            promoted += self._promote_one(app, stage, partition, w, b, t,
                                          tier, key, nb)
        if promoted:
            tr = get_tracer()
            if tr.enabled:
                tr.record(f"promote/{stage}", "store", time.perf_counter(),
                          trace=app, partition=partition, bytes=promoted)
        hot_bytes = sum(nb for _, _, _, tier, _, nb, _ in snap
                        if tier == hot_tier)
        charged = hot_bytes if self.disaggregated else remote
        delay = backend_sleep
        if account and charged and self.net_bw:
            delay += charged / self.net_bw
        if delay:
            time.sleep(delay)
        from repro_torch.analytics.table import Table
        return Table.concat_all(tables)

    def _promote_one(self, app: str, stage: str, partition: int, writer: str,
                     blob: Blob, table, tier: str, key: str,
                     nbytes: int) -> int:
        """Best-effort promotion of one fetched cold blob back into the
        hot tier — only when it fits the quota without evicting anything
        (promotion must never steal headroom from live writes). Returns
        bytes promoted (0 if skipped)."""
        with self._cond:
            cur = self._stages.get((app, stage), {}) \
                .get(partition, {}).get(writer)
            if cur is not blob or cur.tier != tier:
                return 0       # replaced or already moved by a peer reader
            limit = self._quotas.get(app)
            if limit is not None \
                    and self.app_bytes.get(app, 0) + nbytes > limit:
                return 0
            self._backends[tier].delete(key)
            blob.table = table
            blob.key = None
            blob.tier = self._hot.tier
            tb = self.tier_bytes.setdefault(tier, {})
            tb[app] = tb.get(app, 0) - nbytes
            self.resident_bytes[blob.node] = \
                self.resident_bytes.get(blob.node, 0) + nbytes
            self.app_bytes[app] = self.app_bytes.get(app, 0) + nbytes
            self.peak_bytes[app] = max(self.peak_bytes.get(app, 0),
                                       self.app_bytes[app])
            self.promotions.append((app, stage, partition, tier, nbytes))
            get_tracer().count(f"store_bytes/{app}", self.app_bytes[app])
            return nbytes

    def partitions(self, app: str, stage: str) -> list[int]:
        """Known partition ids: written ∪ lost. Lost ids are included so an
        all-partitions reader (``FnContext.get_all``) hits the tombstone and
        raises instead of silently skipping evicted data."""
        with self._lock:
            return sorted(set(self._stages.get((app, stage), {})) |
                          set(self._lost.get((app, stage), set())))

    def partition_state(self, app: str, stage: str,
                        ) -> tuple[set[int], set[int]]:
        """``(written, lost)`` partition-id sets — the residency view the
        lineage recovery planner consults. Demoted partitions count as
        written: they are still readable (through their backend)."""
        with self._lock:
            return (set(self._stages.get((app, stage), {})),
                    set(self._lost.get((app, stage), set())))

    # -- accounting views ------------------------------------------------------

    def stage_bytes(self, app: str, stage: str) -> int:
        with self._lock:
            return sum(b.nbytes
                       for part in self._stages.get((app, stage), {}).values()
                       for b in part.values())

    def read_sources(self, app: str, stage: str, partition: int,
                     reader: int,
                     writers: Sequence[str] | None = None) -> dict[int, int]:
        """Bytes this partition would pull per remote source node (for trace
        replay into the simulator's transfer model). Demoted blobs are
        excluded — their reads are backend traffic, not node-to-node
        transfers. ``writers`` restricts to that subset of writer labels,
        mirroring a writer-sharded ``get``. Does not account."""
        with self._lock:
            blobs = self._stages.get((app, stage), {}).get(partition, {})
            out: dict[int, int] = {}
            for w, b in blobs.items():
                if writers is not None and w not in writers:
                    continue
                if b.tier != self._hot.tier or b.node == reader:
                    continue
                out[b.node] = out.get(b.node, 0) + b.nbytes
            return out

    def data_dist(self, app: str, stage: str, name: str | None = None,
                  ) -> DataDist:
        """The stage's output distribution, ready for a DecisionContext."""
        with self._lock:
            parts = self._stages.get((app, stage), {})
            per_node: dict[int, int] = {}
            rows_per_part = []
            total_rows = 0
            for blobs in parts.values():
                rows_per_part.append(sum(b.rows for b in blobs.values()))
                for b in blobs.values():
                    per_node[b.node] = per_node.get(b.node, 0) + b.nbytes
                    total_rows += b.rows
        return DataDist(name or f"{app}/{stage}", per_node,
                        rows=total_rows, skew=partition_skew(rows_per_part))

    # -- lifecycle -------------------------------------------------------------

    def seal(self, app: str, stage: str) -> None:
        """Mark a stage reclaimable: its consumers are done, reads still
        work, and quota pressure may evict it (LRU by seal order)."""
        with self._cond:
            if (app, stage) in self._stages:
                self._sealed[(app, stage)] = True
                self._cond.notify_all()     # blocked writers can now evict

    def drop_sealed(self, app: str) -> int:
        """Drop every sealed stage of an app — end-of-query GC parity with
        the quota-less eager-delete path. Returns bytes freed."""
        with self._cond:
            freed = 0
            for key in [k for k in self._sealed if k[0] == app]:
                freed += self.delete_stage(*key)
            return freed

    def _demote_stage_locked(self, app: str, stage: str,
                             tier: str) -> tuple[int, float]:
        """Move a stage's hot blobs into a colder backend: hot bytes are
        freed, the data stays readable (read-through + promote). Caller
        holds the lock; serialization happens under it (demotion runs on
        the reclaim/eviction path, never a hot read). Returns (hot bytes
        freed, emulated backend seconds to pay outside the lock)."""
        backend = self._backends[tier]
        t0 = time.perf_counter()
        freed = 0
        pending = 0.0
        moved = 0
        for partition, blobs in self._stages.get((app, stage), {}).items():
            for writer, b in blobs.items():
                if b.tier != self._hot.tier:
                    continue
                key = self._key(app, stage, partition, writer)
                payload = b.table if b.table is not None \
                    else self._hot.get_table(b.key)
                backend.put_table(key, payload)
                if b.key is not None:
                    self._hot.delete(b.key)
                b.table = None
                b.key = key
                b.tier = tier
                self.resident_bytes[b.node] = \
                    self.resident_bytes.get(b.node, 0) - b.nbytes
                self.app_bytes[app] = \
                    self.app_bytes.get(app, 0) - b.nbytes
                tb = self.tier_bytes.setdefault(tier, {})
                tb[app] = tb.get(app, 0) + b.nbytes
                cost = backend.request_cost(b.nbytes)
                if cost:
                    self.storage_cost[app] = \
                        self.storage_cost.get(app, 0.0) + cost
                pending += backend.io_seconds(b.nbytes, "put")
                freed += b.nbytes
                moved += 1
        if freed:
            tr = get_tracer()
            tr.count(f"store_bytes/{app}", self.app_bytes.get(app, 0))
            if tr.enabled:
                tr.record(f"spill/{stage}", "store", t0, trace=app,
                          tier=tier, bytes=freed, partitions=moved)
            self._cond.notify_all()     # wake quota-blocked writers
        return freed, pending

    def demote_stage(self, app: str, stage: str, tier: str) -> int:
        """Spill a stage's hot blobs to ``tier`` (see
        ``_demote_stage_locked``). Returns hot bytes freed."""
        with self._cond:
            freed, pending = self._demote_stage_locked(app, stage, tier)
            if freed:
                self.demotions.append((app, stage, tier, freed))
        if pending:
            time.sleep(pending)
        return freed

    def reclaim_stage(self, app: str, stage: str) -> int:
        """Ephemeral-input GC entry point for the executor. With a spill
        policy for this stage, its blobs demote to the chosen cold tier
        (readable, recoverable, zero hot bytes) and the stage is sealed
        for end-of-query GC. Otherwise: under a quota the stage is sealed
        (lazily evicted when the app needs headroom); without one it is
        dropped immediately — leaving a lost tombstone, so a late reader
        (speculation loser, recovery replay) gets a typed
        ``StageLostError`` rather than silently-empty data. Returns hot
        bytes freed now."""
        pending = 0.0
        with self._cond:
            choice = self._spill.get(app, {}).get(stage)
            if choice is not None and choice in self._backends \
                    and self._backends[choice].order > self._hot.order:
                freed, pending = self._demote_stage_locked(app, stage,
                                                           choice)
                if freed:
                    self.demotions.append((app, stage, choice, freed))
                self.seal(app, stage)
            elif self._quotas.get(app) is not None:
                self.seal(app, stage)
                freed = 0
            else:
                freed = self.lose_stage(app, stage)
        if pending:
            time.sleep(pending)
        return freed

    def lose_stage(self, app: str, stage: str,
                   partitions: Sequence[int] | None = None) -> int:
        """Evict written shuffle data (all partitions, or just
        ``partitions``) and leave lost tombstones: later reads of the
        evicted partitions raise ``StageLostError`` until a producer
        rewrites them. This is the store half of the fault model — stage
        loss of disaggregated ephemeral storage (ServerMix's core tension)
        — and of ephemeral-input GC. Demoted blobs lose their backend
        payload too (a lost spilled stage recovers via lineage like any
        other). Returns bytes freed."""
        with self._cond:
            key = (app, stage)
            parts = self._stages.get(key)
            if not parts:
                return 0
            targets = sorted(parts) if partitions is None else \
                [p for p in partitions if p in parts]
            lost = self._lost.setdefault(key, {})
            hot_freed = cold_freed = 0
            for p in targets:
                blobs = parts.pop(p)
                for b in blobs.values():
                    h, c = self._retract_locked(app, b)
                    hot_freed += h
                    cold_freed += c
                # remember which writers' slices vanished: the partition
                # only heals once all of them have re-written
                lost.setdefault(p, set()).update(blobs)
            if not lost:
                del self._lost[key]
            if not parts:
                del self._stages[key]
                self._sealed.pop(key, None)
            if hot_freed:
                get_tracer().count(f"store_bytes/{app}",
                                   self.app_bytes.get(app, 0))
            if hot_freed or cold_freed:
                self._cond.notify_all()     # wake quota-blocked writers
            return hot_freed + cold_freed

    def clear_lost(self, app: str, stage: str,
                   partitions: Sequence[int] | None = None) -> None:
        """Drop lost tombstones after recovery re-executed the producers:
        any partition still absent is now *genuinely* empty (its producers
        wrote nothing), not missing."""
        with self._lock:
            key = (app, stage)
            lost = self._lost.get(key)
            if lost is None:
                return
            if partitions is None:
                del self._lost[key]
                return
            for p in partitions:
                lost.pop(p, None)
            if not lost:
                del self._lost[key]

    def lost_partitions(self, app: str, stage: str) -> set[int]:
        with self._lock:
            return set(self._lost.get((app, stage), set()))

    def delete_stage(self, app: str, stage: str) -> int:
        """Drop a stage's blobs *and* its lost tombstones — intentional
        teardown, not failure; returns bytes reclaimed across all tiers
        (ephemerality is the point: shuffle state outlives only its
        consumers)."""
        with self._cond:
            parts = self._stages.pop((app, stage), {})
            self._sealed.pop((app, stage), None)
            self._lost.pop((app, stage), None)
            hot_freed = cold_freed = 0
            for blobs in parts.values():
                for b in blobs.values():
                    h, c = self._retract_locked(app, b)
                    hot_freed += h
                    cold_freed += c
            if hot_freed:
                get_tracer().count(f"store_bytes/{app}",
                                   self.app_bytes.get(app, 0))
            if hot_freed or cold_freed:
                self._cond.notify_all()     # wake quota-blocked writers
            return hot_freed + cold_freed

    def clear_app(self, app: str) -> int:
        freed = 0
        with self._cond:
            for key in [k for k in self._stages if k[0] == app]:
                freed += self.delete_stage(*key)
            for key in [k for k in self._lost if k[0] == app]:
                del self._lost[key]    # fully-lost stages have no blobs left
            self._spill.pop(app, None)
        return freed
