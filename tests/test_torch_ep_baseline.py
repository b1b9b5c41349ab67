"""The MoE layer under the planner's baseline profile (GSPMD's
``all_to_all`` plane: ``expert`` and ``expert_act`` over ``model``) on
spawned ``gloo`` ranks on the CPU, against the JAX reference's ``moe``
under the same rules and its unsharded ``moe``, on the same seeded leaves
and inputs.

GSPMD keeps the unsharded layer's function, so the port's plane routes
and drops as the unsharded ``moe`` does: chunks of ``s_chunk`` global
positions, each with the capacity of a chunk. The reference runs in a
subprocess with forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), as
``tests/test_torch_ep.py`` runs it, on a mesh of ``Auto`` axes: GSPMD's
own placement, which the reference's ``logical_shard`` constraints were
written for (on ``Explicit`` axes, ``jax.make_mesh``'s default, a
constraint is an assertion, and the dispatch buffer's ``expert_act`` one
fails it). Moonshot's and granite's smoke
configs, fp32, ``x`` and the loss's weights ``g`` drawn with numpy from
seeds 11 and 12; the loss is ``sum(y * g) + aux``. Cases, each on
``model=2`` and on ``data=2 x model=2``, at capacity factors 8.0 (no
drop) and 1.25:

- ``whole``: the residual whole on every rank (moonshot's ``head_tp``
  cells);
- ``seq``: the residual sequence-sharded over ``model`` (granite's and
  jamba's ``seq_tp`` cells).

At the default chunk (the whole sequence of 64) two ranks share a chunk;
``-c16`` cases cut chunks of 16, so each rank holds two whole chunks;
``-s7`` cases take the first 7 positions, which do not split over the
two ranks, and the plane falls back to ``gather`` (as a decode step
does), which computes the same.

Held: ``y``, ``x``'s gradient, every leaf's gradient (summed over the axes
the train step sums it over) and the aux within ``TOL`` of each array's
largest magnitude (at least 1), against both reference runs; at 1.25 the
assignments the ranks' dispatches dropped, summed over the ranks, equal
the port's unsharded layer's, and are more than 0.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_dist as D

TOL = 1e-5
ARCHS = ("moonshot-v1-16b-a3b", "granite-moe-1b-a400m")
SEEDS = (11, 12)
B, S = 4, 64
M2, D2M2 = {"data": 1, "model": 2}, {"data": 2, "model": 2}
ACT = {"expert": "model", "expert_act": "model"}
LAYOUTS = {"whole": ACT, "seq": dict(ACT, seq="model", vocab="model")}


def _cases(world):
    """``(id, arch, seed, mesh, rules, capacity factor, s_chunk, positions)``
    of each case on ``world`` ranks."""
    mesh, batch = (M2, {}) if world == 2 else (D2M2, {"batch": "data"})
    out = []
    for arch, seed in zip(ARCHS, SEEDS):
        for name, rules in LAYOUTS.items():
            for cf in (8.0, 1.25):
                out.append((f"{name}-{cf}", arch, seed, mesh,
                            dict(rules, **batch), cf, 1024, S))
            if world == 2:
                out.append((f"{name}-1.25-c16", arch, seed, mesh, rules,
                            1.25, 16, S))
        if world == 2:
            out.append(("whole-8.0-s7", arch, seed, mesh, ACT, 8.0, 1024, 7))
    return out


CASES = {w: _cases(w) for w in (2, 4)}
PARAMS = [(w, c) for w, cases in CASES.items() for c in cases]

REFERENCE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.compat import set_mesh
from repro.models.moe import moe
from repro.parallel.sharding import ShardingRules, use_rules

data = np.load(sys.argv[1])
runs = json.loads(open(sys.argv[2]).read())
out = {}
for key, (arch, seed, cf, chunk, n, mesh_shape, rules) in runs.items():
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    params = {k: jnp.asarray(data[f"{arch}/{k}"])
              for k in ("router", "gate", "up", "down")}
    x = jnp.asarray(data[f"{arch}/{seed}/x"][:, :n])
    g = jnp.asarray(data[f"{arch}/{seed}/g"][:, :n])

    def loss(p, x):
        y, aux = moe(p, x, cfg, s_chunk=chunk)
        return jnp.sum(y * g) + aux, (y, aux)

    fn = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    if rules is None:
        (_, (y, aux)), (gp, gx) = jax.jit(fn)(params, x)
    else:
        mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        base = {"seq": None, "embed": None, "w_embed": None, "cap": None,
                "batch": None, "expert": None, "expert_act": None,
                "mlp": None}
        r = ShardingRules(mesh, {**base, **rules})
        with set_mesh(mesh), use_rules(r):
            (_, (y, aux)), (gp, gx) = jax.jit(fn)(params, x)
    out[f"{key}/y"] = np.asarray(y)
    out[f"{key}/aux"] = np.asarray(aux)
    out[f"{key}/dx"] = np.asarray(gx)
    for k, v in gp.items():
        out[f"{key}/grad/{k}"] = np.asarray(v)
np.savez(sys.argv[3], **out)
print("OK")
"""


def _arrays(path):
    """Each arch's MoE leaves (the port's ``MoE`` from seed 0) and, for its
    seed, ``x`` (with a direction every token shares, which skews the
    routing so that the capacity at 1.25 drops assignments) and ``g``."""
    from repro_torch.models.moe import MoE
    arrays = {}
    for arch, seed in zip(ARCHS, SEEDS):
        cfg = D.smoke(arch)
        layer = MoE(cfg, torch.Generator().manual_seed(0), "cpu")
        for leaf in ("router", "gate", "up", "down"):
            arrays[f"{arch}/{leaf}"] = getattr(layer, leaf).detach().numpy()
        rng = np.random.default_rng(seed)
        shared = 2.0 * rng.standard_normal(cfg.d_model)
        arrays[f"{arch}/{seed}/x"] = (rng.standard_normal(
            (B, S, cfg.d_model)) + shared).astype(np.float32)
        arrays[f"{arch}/{seed}/g"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    np.savez(path, **arrays)
    return arrays


def _unsharded_drops(arrays, arch, seed, cf, s_chunk, n) -> int:
    """The assignments the port's unsharded layer drops on the case's
    whole batch."""
    from repro_torch.models import moe as M
    cfg = D.smoke(arch, cf)
    layer = M.MoE(cfg, torch.Generator().manual_seed(0), "cpu")
    plain, dropped = M.dispatch, []

    def counting(top_i, e, cap, start=None):
        bk = plain(top_i, e, cap, start)
        dropped.append(int((~bk.keep).sum()))
        return bk

    M.dispatch = counting
    try:
        with torch.no_grad():
            M.moe_parts(layer, torch.from_numpy(
                arrays[f"{arch}/{seed}/x"][:, :n]), cfg, s_chunk=s_chunk)
    finally:
        M.dispatch = plain
    return sum(dropped)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("ep_baseline")
    arrays_path = root / "arrays.npz"
    arrays = _arrays(arrays_path)
    runs = {}
    for world, cases in CASES.items():
        for cid, arch, seed, mesh, rules, cf, chunk, n in cases:
            runs[f"{world}/{arch}/{cid}"] = (
                arch, seed, cf, chunk, n, [mesh["data"], mesh["model"]],
                rules)
            runs[f"moe/{arch}/{cf}/{chunk}/{n}"] = (arch, seed, cf, chunk, n,
                                                    None, None)
    (root / "runs.json").write_text(json.dumps(runs))
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    if "JAX_PLATFORMS" in os.environ:
        env["JAX_PLATFORMS"] = os.environ["JAX_PLATFORMS"]
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(arrays_path),
         str(root / "runs.json"), str(root / "ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    ranks = {}
    for world, cases in CASES.items():
        ranks[world] = D.run_ranks(D.ep_rank, world, root, [
            {"id": f"{c[0]}/{c[1]}", "arch": c[1], "mesh": c[3],
             "rules": c[4], "capacity_factor": c[5], "s_chunk": c[6],
             "positions": c[7], "inputs": f"{c[1]}/{c[2]}"}
            for c in cases], str(arrays_path))
    drops = {(arch, cf, chunk, n): _unsharded_drops(arrays, arch, seed, cf,
                                                    chunk, n)
             for _, arch, seed, _, _, cf, chunk, n in
             [c for cases in CASES.values() for c in cases]}
    stdout, stderr = ref.communicate(timeout=600)
    assert ref.returncode == 0 and "OK" in stdout, stderr[-3000:]
    return ranks, dict(np.load(root / "ref.npz")), drops


def _close(got, want, what):
    """Within ``TOL`` of ``want``'s largest magnitude (at least 1)."""
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * max(float(np.abs(want).max()), 1.0), (what, err)


@pytest.mark.parametrize("world,case", PARAMS,
                         ids=[f"{w}ranks-{c[1]}-{c[0]}" for w, c in PARAMS])
def test_all_to_all_plane_matches_reference(results, world, case):
    ranks, ref, drops = results
    cid, arch, _, _, rules, cf, chunk, n = case
    assert all(r[f"{cid}/{arch}"]["rules"]["expert_act"] == "model"
               for r in ranks[world])
    for key in (f"{world}/{arch}/{cid}", f"moe/{arch}/{cf}/{chunk}/{n}"):
        for r in ranks[world]:
            o = r[f"{cid}/{arch}"]
            _close(o["y"], ref[f"{key}/y"], f"{key} y")
            _close(o["dx"], ref[f"{key}/dx"], f"{key} dx")
            for leaf, g in o["grads"].items():
                _close(g, ref[f"{key}/grad/{leaf}"], f"{key} grad {leaf}")
            _close(o["aux"], ref[f"{key}/aux"], f"{key} aux")
    dropped = sum(r[f"{cid}/{arch}"]["dropped"] for r in ranks[world])
    assert dropped == drops[(arch, cf, chunk, n)]
    assert (dropped > 0) == (cf == 1.25)
