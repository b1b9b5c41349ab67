"""Expert parallelism of the port's MoE layer (``repro_torch.models.moe``
under a ``TensorPlan``) on spawned ``gloo`` ranks on the CPU, against the
JAX reference's three data planes on the same seeded leaves and inputs.

The reference runs in a subprocess with forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_shardmap_paths.py`` runs it): its ``moe`` under the rules of
each case, on a ``jax.make_mesh`` of the case's shape. Moonshot's and
granite's smoke configs, fp32, ``x`` and the loss's weights ``g`` drawn
with numpy from seed 7; the loss is ``sum(y * g) + aux``. Cases:

- ``gather`` (experts over ``model``, no ``moe_impl``) against the
  reference's unsharded ``moe``;
- ``shard_map_a2a`` with the residual whole over ``model`` and
  sequence-sharded, against the reference's ``moe_shard_map``, at
  capacity factor 8.0 (no drop) and at the models' own 1.25, where the
  two packages drop the same assignments (the port's ranks drop some:
  the count is held above 0, and the outputs equal);
- ``shard_map_local`` under ``pure_dp`` with ZeRO over the whole mesh,
  against the reference's ``moe_shard_map_local``;
- on ``data=2 x model=2`` the all-to-all is held to the reference's
  unsharded ``moe`` at 8.0, its aux (and so the router's and ``x``'s
  gradients) the whole batch's: the reference's ``moe_shard_map`` takes
  one data shard's there (ROADMAP Queue 3), which differs.

Held: ``y``, ``x``'s gradient, every leaf's gradient (summed over the
axes the train step sums it over) and the aux within ``TOL`` of each
array's largest magnitude (at least 1): the same sums in another order,
in fp32 (the shared direction in ``x`` makes the router's gradients
reach ~100, so an element's own relative error reaches 1e-4).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import _torch_dist as D

TOL = 1e-5
ARCHS = ("moonshot-v1-16b-a3b", "granite-moe-1b-a400m")
B, S = 4, 64
M2, M4, D2M2 = {"data": 1, "model": 2}, {"data": 1, "model": 4}, \
    {"data": 2, "model": 2}
A2A = {"expert": "model", "moe_impl": "shard_map_a2a"}


def _local(mesh):
    axes = tuple(mesh)
    return {"batch": axes, "w_embed": axes, "moe_impl": "shard_map_local"}


def _cases(world):
    """``(id, arch, mesh, rules, capacity factor, reference)`` of each case
    on ``world`` ranks; ``reference`` names the reference's run it is held
    to (its rules and mesh, or ``"moe"`` for the unsharded layer)."""
    out = []
    for arch in ARCHS:
        if world == 2:
            out += [
                ("gather", arch, M2, {"expert": "model"}, 1.25, "moe"),
                ("a2a-8", arch, M2, A2A, 8.0, "same"),
                ("a2a-1.25", arch, M2, A2A, 1.25, "same"),
                ("a2a-seq-8", arch, M2, dict(A2A, seq="model", vocab="model"), 8.0,
                 "same"),
                ("a2a-seq-1.25", arch, M2, dict(A2A, seq="model", vocab="model"), 1.25,
                 "same"),
                ("local", arch, {"data": 2, "model": 1},
                 _local({"data": 2, "model": 1}), 1.25, "same")]
        else:
            out += [
                ("a2a-dp2-8", arch, D2M2, dict(A2A, batch="data"), 8.0,
                 "moe"),
                ("gather-dp2", arch, D2M2,
                 {"expert": "model", "batch": "data"}, 1.25, "moe"),
                ("local-zero4", arch, D2M2, _local(D2M2), 1.25, "same")]
            if arch == ARCHS[0]:
                out.append(("a2a-seq-model4-1.25", arch, M4,
                            dict(A2A, seq="model", vocab="model"), 1.25, "same"))
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
for key, (arch, cf, mesh_shape, rules) in runs.items():
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    params = {k: jnp.asarray(data[f"{arch}/{k}"])
              for k in ("router", "gate", "up", "down")}
    x, g = jnp.asarray(data[f"{arch}/x"]), jnp.asarray(data[f"{arch}/g"])

    def loss(p, x):
        y, aux = moe(p, x, cfg)
        return jnp.sum(y * g) + aux, (y, aux)

    fn = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    if rules is None:
        (_, (y, aux)), (gp, gx) = jax.jit(fn)(params, x)
    else:
        mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"))
        base = {"seq": None, "embed": None, "w_embed": None,
                "batch": None, "expert": None}
        r = ShardingRules(mesh, {**base, **{k: tuple(v) if isinstance(
            v, list) else v for k, v in rules.items()}})
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
    """Each arch's MoE leaves (the port's ``MoE`` from seed 0, so the
    reference's leaf shapes and dtypes) and the seeded ``x`` and ``g``."""
    import torch

    from repro_torch.models.moe import MoE
    rng = np.random.default_rng(7)
    arrays = {}
    for arch in ARCHS:
        cfg = D.smoke(arch)
        layer = MoE(cfg, torch.Generator().manual_seed(0), "cpu")
        for leaf in ("router", "gate", "up", "down"):
            arrays[f"{arch}/{leaf}"] = getattr(layer, leaf).detach().numpy()
        # a direction every token shares skews the routing, so that the
        # capacity at 1.25 drops assignments
        shared = 2.0 * rng.standard_normal(cfg.d_model)
        arrays[f"{arch}/x"] = (rng.standard_normal((B, S, cfg.d_model))
                               + shared).astype(np.float32)
        arrays[f"{arch}/g"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    np.savez(path, **arrays)


def _reference_runs():
    """``{key: (arch, capacity factor, mesh shape, rules or None)}`` of
    every reference run the cases are held to, and each case's key."""
    runs, keys = {}, {}
    for world, cases in CASES.items():
        for case in cases:
            cid, arch, mesh, rules, cf, ref = case
            if ref == "moe":
                run = (arch, cf, None, None)
            else:
                run = (arch, cf, [mesh["data"], mesh["model"]], rules)
            key = f"{world}/{arch}/{cid}"
            runs[key] = run
            keys[(world, arch, cid)] = key
    # the whole batch's aux, unsharded, and the reference's all-to-all
    # on data=2 x model=2
    for arch in ARCHS:
        runs[f"moe/{arch}"] = (arch, 8.0, None, None)
        runs[f"shard_map_dp2/{arch}"] = (arch, 8.0, [2, 2],
                                         dict(A2A, batch="data"))
    return runs, keys


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import json
    root = tmp_path_factory.mktemp("ep")
    arrays = root / "arrays.npz"
    _arrays(arrays)
    runs, keys = _reference_runs()
    (root / "runs.json").write_text(json.dumps(runs))
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    if "JAX_PLATFORMS" in os.environ:
        env["JAX_PLATFORMS"] = os.environ["JAX_PLATFORMS"]
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(arrays),
         str(root / "runs.json"), str(root / "ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    ranks = {}
    for world, cases in CASES.items():
        ranks[world] = D.run_ranks(D.ep_rank, world, root, [
            {"id": c[0] + "/" + c[1], "arch": c[1], "mesh": c[2],
             "rules": c[3], "capacity_factor": c[4]} for c in cases],
            str(arrays))
    stdout, stderr = ref.communicate(timeout=600)
    assert ref.returncode == 0 and "OK" in stdout, stderr[-3000:]
    return ranks, dict(np.load(root / "ref.npz")), keys


def _close(got, want, what):
    """Within ``TOL`` of ``want``'s largest magnitude (at least 1)."""
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * max(float(np.abs(want).max()), 1.0), (what, err)


@pytest.mark.parametrize("world,case", PARAMS,
                         ids=[f"{w}ranks-{c[1]}-{c[0]}" for w, c in PARAMS])
def test_moe_plane_matches_reference(results, world, case):
    ranks, ref, keys = results
    cid, arch = case[0], case[1]
    key = keys[(world, arch, cid)]
    for r in ranks[world]:
        o = r[f"{cid}/{arch}"]
        _close(o["y"], ref[f"{key}/y"], f"{key} y")
        _close(o["dx"], ref[f"{key}/dx"], f"{key} dx")
        for leaf, g in o["grads"].items():
            _close(g, ref[f"{key}/grad/{leaf}"], f"{key} grad {leaf}")
        _close(o["aux"], ref[f"{key}/aux"], f"{key} aux")
    if cid.endswith("1.25") and cid.startswith("a2a"):
        assert sum(r[f"{cid}/{arch}"]["dropped"] for r in ranks[world]) > 0


def test_a2a_aux_is_the_whole_batch_s(results):
    """Under ``data=2, model=2`` the all-to-all's aux is the whole
    batch's (the unsharded layer's); the reference's ``moe_shard_map``
    reports one data shard's, which differs here."""
    ranks, ref, _ = results
    for arch in ARCHS:
        whole = float(ref[f"moe/{arch}/aux"])
        shard = float(ref[f"shard_map_dp2/{arch}/aux"])
        assert abs(shard - whole) > 10 * TOL * abs(whole)
        for r in ranks[4]:
            assert r[f"a2a-dp2-8/{arch}"]["aux"] == pytest.approx(
                whole, rel=TOL)
