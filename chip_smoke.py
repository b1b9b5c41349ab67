#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a) and prints the build seconds and the card's name and power limit.
2. Runs the sub-query through ``execute_query_runtime`` at 2^17 fact rows
   (the workflow binds the ``fused`` plan, so K3 runs) and at 2^25 fact rows
   (403 MB, the paper's smallest table; the ``pipelined`` plan, K1 and K2
   under every shuffle write), checking each result against a vectorized
   numpy oracle and that the main path launched the kernels (the launch
   counters are set to 0 just before each query and read just after).
3. Holds each kernel (K1 histogram, K2 stable scatter, K3 fused probe)
   bit-exact against its plain PyTorch version on the card, at the shapes
   the main path launched it at and on edge cases, and times kernel, plain
   version and the one PyTorch call computing the same function at the
   largest main-path shape (CUDA events, median of 20, L2 warm).
4. Prints the ``kernels`` JSON line.
5. Re-runs the large query under ``torch.profiler`` (outside the counted
   run) and prints its device-busy share and its costliest device ops.
6. Prints the card line and, as its last line,
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line is printed. Needs a CUDA
device and the repository's ``src/`` beside this file; imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM peak outside the tensor cores
# each group sum is a float32 sum of ~10^4-10^5 products, accumulated in
# another order than the float64 oracle
QUERY_RTOL, QUERY_ATOL = 1e-4, 1e-2
NUM_GROUPS = 64
REPS = 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def median_ms(fn, reps: int = REPS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def bits_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def held_exact(got, want, what: str) -> float:
    """Require kernel outputs ``got`` to be bit-equal to the plain version's
    ``want`` (pairwise) and return the largest |got - want|, in float64."""
    err = 0.0
    for a, b in zip(got, want):
        if a.shape == b.shape and a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
        require(bits_equal(a, b), f"{what} (max |err| {err})")
    return err


# -- kernel checks --------------------------------------------------------------


def _largest(shapes) -> tuple:
    return max(shapes, key=lambda sh: (sh[0], sh[1:]))


def _refuses_bad_ids(dev, launch) -> None:
    """Ids outside [0, P) raise before any launch (the kernels would skip
    them where the plain versions order or reject them)."""
    import torch
    from repro_torch.kernels import partition as K
    for bad in (-1, 15):
        ids = torch.zeros((5000,), dtype=torch.int32, device=dev)
        ids[4321] = bad
        before = dict(K.LAUNCHES)
        try:
            launch(ids)
        except ValueError:
            require(K.LAUNCHES == before, "a refused call launched a kernel")
            continue
        raise AssertionError(f"partition id {bad} with P=15 was accepted")


def check_k1(dev, gen, main_shapes) -> dict:
    """K1 bit-exact at N = 2^23 (P = 512 and 15), on edges and at every
    shape the main path launched it at; timed at the largest of those."""
    import torch
    from repro_torch.kernels import partition as K, ref
    # edges: a ragged last tile, all rows in one bucket, fewer rows than a
    # tile, a two-bucket space
    cases = [(1 << 23, 512, None), (1 << 23, 15, None),
             ((1 << 23) + 777, 65, None), (1 << 23, 65, 64),
             (100, 512, None), (5000, 2, None)]
    cases += [(n, p, None) for n, p in sorted(main_shapes)]
    err = 0.0
    for n, p, fill in cases:
        ids = torch.full((n,), fill, dtype=torch.int32, device=dev) \
            if fill is not None else \
            torch.randint(0, p, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        err = max(err, held_exact(
            [K.partition_histogram(ids, p)],
            [ref.partition_histogram_ref(ids, p)],
            f"K1 differs from its plain version at N={n}, P={p}"))
    _refuses_bad_ids(dev, lambda ids: K.partition_histogram(ids, 15))
    n, p = _largest(main_shapes)
    ids = torch.randint(0, p, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    err = max(err, held_exact([K.partition_histogram(ids, p)],
                              [ref.partition_histogram_ref(ids, p)],
                              "K1 differs from its plain version (timed)"))
    b, by = bound_ms(n * 4 + p * 4)
    return {"name": "partition_histogram", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/partition.cu",
            "replaces": "src/repro/kernels/partition.py:35",
            "max_abs_err": err,
            # timed as the sketch launches it, without the range check
            "ms": median_ms(lambda: K.partition_histogram(ids, p, False)),
            "plain_ms": median_ms(
                lambda: ref.partition_histogram_ref(ids, p)),
            "bound_ms": b, "bound_by": by,
            "library_ms": median_ms(
                lambda: torch.bincount(ids, minlength=p)),
            "shape": f"N={n} P={p}"}


def _grouping_input(dev, gen, n_real: int, n_pad: int, buckets: int):
    import torch
    ids = torch.randint(0, buckets - 1, (n_pad,), generator=gen,
                        device=dev, dtype=torch.int32)
    ids[n_real:] = buckets - 1            # the padding sentinel
    rows = torch.arange(n_pad, dtype=torch.int32, device=dev)[:, None]
    return rows, ids


def check_k2(dev, gen, main_shapes) -> dict:
    """K2 bit-exact at n_pad = 2^23 with P+1 = 15, on edges and at every
    main-path shape; timed at the largest main-path shape."""
    import torch
    from repro_torch.kernels import partition as K, ref

    errs = [0.0]

    def same(rows, ids, p, what):
        errs.append(held_exact(K.partition_scatter(rows, ids, p),
                               ref.partition_scatter_ref(rows, ids, p),
                               f"K2 differs from its plain version: {what}"))

    for n, p in [(1 << 23, 15)] + sorted(main_shapes):
        same(*_grouping_input(dev, gen, n - n // 97, n, p), p,
             f"n_pad={n}, P+1={p}")
    # edges: a ragged last tile, all rows in one bucket, 3-wide float rows,
    # one bucket in all
    r2, i2 = _grouping_input(dev, gen, 3000, 3333, 65)
    same(r2, i2, 65, "ragged last tile")
    same(r2, torch.full_like(i2, 7), 65, "all rows in one bucket")
    wide = torch.randn((2053, 3), generator=gen, device=dev)
    same(wide, torch.randint(0, 9, (2053,), generator=gen, device=dev,
                             dtype=torch.int32), 9, "3-wide float rows")
    same(r2, torch.zeros_like(i2), 1, "one bucket")
    _refuses_bad_ids(dev, lambda ids: K.partition_scatter(ids[:, None], ids,
                                                          15))
    n, p = _largest(main_shapes)
    rows, ids = _grouping_input(dev, gen, n - n // 97, n, p)
    same(rows, ids, p, f"timed input n_pad={n}, P+1={p}")
    b, by = bound_ms(n * 4 + n * 4 + n * 4 + p * 4)
    return {"name": "partition_scatter", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/partition.cu",
            "replaces": "src/repro/kernels/partition.py:136",
            "max_abs_err": max(errs),
            # the kernel alone: the range check's reduction and host sync
            # run once per shuffle write before it (not timed here)
            "ms": median_ms(lambda: K.partition_scatter(rows, ids, p, False)),
            "plain_ms": median_ms(
                lambda: ref.partition_scatter_ref(rows, ids, p)),
            "bound_ms": b, "bound_by": by,
            "library_ms": median_ms(
                lambda: torch.argsort(ids, stable=True)),
            "shape": f"n_pad={n} P+1={p}"}


def _probe_input(dev, gen, n: int, m: int, m_valid: int, zero_key: bool):
    import torch
    keys = torch.randperm(4 * m, generator=gen, device=dev)[:m_valid] + 1
    if zero_key:
        keys[0] = 0                       # a real build row with key 0
    bk = torch.zeros((m,), dtype=torch.int32, device=dev)
    bk[:m_valid] = keys.to(torch.int32)   # padding rows keep key 0
    bc = torch.zeros_like(bk)
    bc[:m_valid] = torch.arange(m_valid, device=dev,
                                dtype=torch.int32) * 7 % 1000
    bv = torch.zeros_like(bk)
    bv[:m_valid] = 1
    # probe keys with duplicates, half of them hits, plenty of zeros
    pk = torch.randint(0, 8 * m, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    hit = torch.rand((n,), generator=gen, device=dev) < 0.5
    pick = torch.randint(0, m_valid, (n,), generator=gen, device=dev)
    pk = torch.where(hit, bk[pick], pk)
    pk[: n // 16] = 0
    v0 = torch.randn((n,), generator=gen, device=dev)
    v1 = torch.randn((n,), generator=gen, device=dev)
    return pk, v0, v1, bk, bc, bv


def check_k3(dev, gen, main_shapes) -> dict:
    """K3 bit-exact at N = 2^16, M = 8192, G = 64 (with padding rows whose
    key is 0, with and without a real key 0), at the largest build side
    the gate admits and at every main-path shape; timed at the largest
    main-path shape."""
    from repro_torch.kernels import partition as K, ref
    n0, m0, g0 = 1 << 16, 8192, NUM_GROUPS
    cases = [(n0, m0, m0 - 500, False, g0), (n0, m0, m0 - 500, True, g0),
             (1000, 8, 5, False, g0),
             (4096, K.FUSED_SMEM_ROWS, K.FUSED_SMEM_ROWS - 3, True, g0)]
    cases += [(n, m, m - m // 10, True, g) for n, m, g in sorted(main_shapes)]
    err = 0.0
    for n, m, mv, zero, g in cases:
        args = _probe_input(dev, gen, n, m, mv, zero)
        err = max(err, held_exact(
            K.fused_probe(*args, g), ref.fused_probe_ref(*args, g),
            f"K3 differs from its plain version at N={n}, M={m}, "
            f"zero key {zero}"))
    n, m, g = _largest(main_shapes)
    args = _probe_input(dev, gen, n, m, m - m // 10, False)
    err = max(err, held_exact(K.fused_probe(*args, g),
                              ref.fused_probe_ref(*args, g),
                              "K3 differs from its plain version (timed)"))
    b, by = bound_ms(n * 12 + m * 12 + n * 8, ops=float(n) * m)
    return {"name": "fused_probe", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/partition.cu",
            "replaces": "src/repro/kernels/partition.py:75",
            "max_abs_err": err,
            "ms": median_ms(lambda: K.fused_probe(*args, g)),
            "plain_ms": median_ms(lambda: ref.fused_probe_ref(*args, g)),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "shape": f"N={n} M={m} G={g}"}


# -- query phases ---------------------------------------------------------------


def oracle(fact, dim, num_groups: int = NUM_GROUPS) -> np.ndarray:
    """Vectorized numpy oracle of the sub-query (float64 sums)."""
    from repro_torch.analytics.table import to_numpy
    f, d = fact.gather(), dim.gather()
    fk, v0, v1 = (to_numpy(f[c]) for c in ("key", "v0", "v1"))
    dk, cat = to_numpy(d["key"]), to_numpy(d["cat"])
    order = np.argsort(dk, kind="stable")
    sk = dk[order]
    pos = np.clip(np.searchsorted(sk, fk), 0, len(sk) - 1)
    hit = (sk[pos] == fk) & (v0 > 0)
    grp = cat[order][pos][hit] % num_groups
    w = v0[hit].astype(np.float64) * v1[hit].astype(np.float64)
    return np.bincount(grp, weights=w, minlength=num_groups)


def query_tables(rows: int, dim_rows: int, seed: int, fact_nodes: int,
                 dim_nodes, device):
    """The fact/dim pair of ``synth_query_tables`` (same seeds, same bytes)
    without its per-row Python oracle, which would take minutes here."""
    import torch
    from repro_torch.analytics.table import Table, distribute, synth_table
    ks = 2 * max(rows, dim_rows)
    fact = synth_table("f", rows, ks, seed=seed, device=device)
    d = synth_table("d", dim_rows, ks, seed=seed + 1, unique_keys=True,
                    device=device)
    dim = Table({**d.columns, "cat": torch.arange(
        dim_rows, dtype=torch.int32, device=device) % NUM_GROUPS})
    dim_nodes = range(dim_nodes) if isinstance(dim_nodes, int) else dim_nodes
    return (distribute(fact, range(fact_nodes), "A"),
            distribute(dim, dim_nodes, "B"))


def run_query(app: str, rows: int, dim_rows: int, device, seed: int,
              fact_nodes: int, dim_nodes, invoker: str = "threads") -> dict:
    """One query through the port's entry point with the kernel counters
    set to 0 just before it and read just after."""
    import torch
    from repro_torch.analytics.query import (
        QueryStrategy, execute_query_runtime)
    from repro_torch.kernels import partition as K
    from repro_torch.obs.audit import get_audit_log

    t0 = time.perf_counter()
    fact, dim = query_tables(rows, dim_rows, seed, fact_nodes, dim_nodes,
                             device)
    t1 = time.perf_counter()
    want = oracle(fact, dim)
    setup = {"synth_s": t1 - t0, "oracle_s": time.perf_counter() - t1}
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    got, runtime = execute_query_runtime(
        fact, dim, QueryStrategy("static_merge"), app=app, invoker=invoker,
        pipeline=True, num_groups=NUM_GROUPS, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    require(got.shape == (NUM_GROUPS,) and np.isfinite(got).all(),
            f"{app}: result is not {NUM_GROUPS} finite sums")
    err = float(np.max(np.abs(got - want)))
    require(np.allclose(got, want, rtol=QUERY_RTOL, atol=QUERY_ATOL),
            f"{app}: result differs from the oracle by up to {err}")
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0
    # function-seconds per stage (summed over its invocations) and the
    # share of them spent against the shuffle store
    stages = {name: {"invocations": m.invocations,
                     "fn_s": round(m.seconds, 6),
                     "store_s": round(m.store_seconds, 6),
                     "bytes_in": m.bytes_in, "bytes_out": m.bytes_out}
              for name, m in runtime.metrics.by_stage(app).items()}
    return {"app": app, "fact_rows": rows, "dim_rows": dim_rows,
            "setup": setup, "wall_s": wall, "rows_per_s": rows / wall,
            "peak_bytes": int(peak), "max_abs_err": err,
            "launches": launches, "stages": stages,
            "sequence": get_audit_log().sequence(app), "tables": (fact, dim)}


def check_phase(res: dict, plan: str, kernels) -> None:
    bound = dict(res["sequence"])
    require(bound.get("pipeline") == plan,
            f"{res['app']}: pipeline bound {bound.get('pipeline')!r}, "
            f"expected {plan!r}")
    for k in kernels:
        require(res["launches"][k] > 0,
                f"{res['app']}: the main path never launched {k}")


def small_query(device) -> dict:
    res = run_query("smoke_small", 1 << 17, 1 << 13, device, seed=7,
                    fact_nodes=4, dim_nodes=[0, 1])
    check_phase(res, "fused", ("fused_probe",))
    return res


def large_query(device, rows: int = 1 << 25, dim_rows: int = 1 << 22,
                ) -> dict:
    res = run_query("smoke_large", rows, dim_rows, device, seed=1,
                    fact_nodes=4, dim_nodes=2)
    check_phase(res, "pipelined",
                ("partition_histogram", "partition_scatter"))
    return res


def profile_query(device, fact, dim) -> dict:
    """Re-run a query on its tables under ``torch.profiler`` (outside the
    counted run) and split its wall into device-busy and idle time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analytics.query import (
        QueryStrategy, execute_query_runtime)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        execute_query_runtime(fact, dim, QueryStrategy("static_merge"),
                              app="smoke_profile", invoker="threads",
                              pipeline=True, num_groups=NUM_GROUPS,
                              device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    return {"wall_s": wall, "device_busy_s": device_us / 1e6,
            "idle_share": 1.0 - device_us / 1e6 / wall,
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                              for e in top}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    # the run drives one card; the last line reports the cards it saw
    require(torch.cuda.device_count() == 1,
            f"needs exactly one visible card, sees {torch.cuda.device_count()}"
            " (set CUDA_VISIBLE_DEVICES)")
    dev = torch.device("cuda")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for src, log in build.BUILD_LOGS.items():
        print(f"nvcc {src}:\n{log.strip()}")
    card = card_line()
    print(f"card: {card}")

    from repro_torch.kernels import partition as K
    before = {k: set(v) for k, v in K.SHAPES.items()}
    phases = [small_query(dev), large_query(dev)]
    main_shapes = {k: K.SHAPES[k] - before[k] for k in K.SHAPES}
    for res in phases:
        print(f"query {res['app']}: {res['fact_rows']} fact rows, wall "
              f"{res['wall_s']:.3f} s, {res['rows_per_s']:.0f} rows/s, peak "
              f"{res['peak_bytes']} B, max |err| {res['max_abs_err']:.3g}, "
              f"launches {res['launches']} [{card}]")
        print(f"  setup (not timed): {res['setup']}")
        print(f"  sequence: {res['sequence']}")
        print(f"  stages: {json.dumps(res['stages'])}")
    print(f"main-path kernel shapes: "
          f"{ {k: sorted(v) for k, v in main_shapes.items()} }")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = [check_k1(dev, gen, main_shapes["partition_histogram"]),
            check_k2(dev, gen, main_shapes["partition_scatter"]),
            check_k3(dev, gen, main_shapes["fused_probe"])]
    for r in rows:
        print(f"kernel {r['name']} ({r['shape']}): {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")
    for r in rows:
        r["launches"] = sum(res["launches"][r["name"]] for res in phases)
        del r["shape"]
    print(json.dumps({"kernels": rows}))
    prof = profile_query(dev, *phases[1]["tables"])
    print(f"profile smoke_large (second run, profiler on): "
          f"{json.dumps(prof)} [{card}]")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
