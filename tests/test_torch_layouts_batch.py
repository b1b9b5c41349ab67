"""The layouts that split a logical axis over the batch's own mesh axes,
which the JAX reference runs and the port's ``TensorPlan`` lays out as
ZeRO-3 on that dimension: every activation the reference constrains
names ``"batch"`` first, and its ``spec`` drops a mesh axis an earlier
dimension used, so such a split cuts the weights only. The port gathers
the dimension's blocks before it computes (``TensorPlan.gathers_of``,
the gradient reduce-scattered back) and keeps every activation whole on
those axes. On spawned ``gloo`` ranks on the CPU, fp32 smoke configs,
``data=2 x model=2`` (``sharding.LAYOUTS``):

- ``mlp_over_batch``, ``heads_over_batch``, ``vocab_over_batch`` and
  ``seq_over_batch`` on llama (and ``mlp_over_batch`` on ``data=2 x
  model=1``);
- ``heads_mixed_batch`` on qwen1.5-4b: the heads and kv heads over
  ``("data", "model")`` with the batch over ``data``, each rank gathering
  every block and computing ``model``'s block of them; also under
  ``zero2`` with ``regather`` (the gathers made once a step);
- ``experts_over_batch`` on granite (the experts gathered whole: the
  local plane on each rank's rows);
- ``inner_over_batch`` on xlstm and jamba (the inner features, and
  jamba's experts, gathered whole).

Every case, from seeds 0 and 1's weights and batches, is held to the
reference's whole-batch ``make_train_step`` from the same weights under
AdamW without warmup (``_torch_train_parity.shards_held_to_reference``):
loss and grad norm within ``TP_LOSS_RTOL``, each rank's gradient shards
within ``TP_GRAD_TOL`` of the same slice of the reference's, its updated
shards within 1e-5, the leaves held whole bit-equal across the ranks.

xlstm at seed 1 is held at ``ROUNDING_GRAD_TOL`` in place of
``TP_GRAD_TOL``: there the reference's own fp32 gradient rounds further
than ``TP_GRAD_TOL`` from the same step in float64
(``test_torch_fp64_rounding.py``).

The reference's own step under the two layouts that take new code paths
(``heads_mixed_batch`` and ``experts_over_batch``) runs under GSPMD on a
2 x 2 mesh of forced host devices in one subprocess (``_jax_gspmd``)
while the ranks run: its loss and grad norm are its whole-batch step's
within ``GSPMD_RTOL``. The other five are left out to keep the file
under a minute.
"""

import pytest

import _jax_gspmd as G
import _torch_dist as D
import _torch_train_parity as P
from repro_torch.parallel.sharding import LAYOUTS

D2M1, D2M2 = {"data": 2, "model": 1}, {"data": 2, "model": 2}
SEEDS = (0, 1)
LLAMA, QWEN = "llama3.2-3b", "qwen1.5-4b"
GRANITE, XLSTM, JAMBA = "granite-moe-1b-a400m", "xlstm-1.3b", \
    "jamba-v0.1-52b"
LAYOUT_CASES = {
    2: [("mlp_over_batch", LLAMA, D2M1)],
    4: [("mlp_over_batch", LLAMA, D2M2), ("heads_over_batch", LLAMA, D2M2),
        ("vocab_over_batch", LLAMA, D2M2), ("seq_over_batch", LLAMA, D2M2),
        ("heads_mixed_batch", QWEN, D2M2),
        ("experts_over_batch", GRANITE, D2M2),
        ("inner_over_batch", XLSTM, D2M2),
        ("inner_over_batch", JAMBA, D2M2)]}
CASES = {w: [{"id": f"{layout}/{arch}/{w}ranks/seed{seed}", "arch": arch,
              "mesh": mesh, "layout": layout, "seed": seed}
             for layout, arch, mesh in cases for seed in SEEDS]
         for w, cases in LAYOUT_CASES.items()}
# the gathers made once a step (``zero2`` with ``regather``): the kept
# block cut from the copy gathered before the microbatches, the gradient
# reduce-scattered after them
CASES[4] += [{"id": f"heads_mixed_batch/{QWEN}/regather/seed{seed}",
              "arch": QWEN, "mesh": D2M2, "layout": "heads_mixed_batch",
              "seed": seed, "pc": {"zero2": True}, "regather": True}
             for seed in SEEDS]
PARAMS = [(w, c["id"]) for w, cases in CASES.items() for c in cases]
CASE = {c["id"]: c for cases in CASES.values() for c in cases}
GSPMD = [("heads_mixed_batch", QWEN), ("experts_over_batch", GRANITE)]
GSPMD_RTOL = 1e-5


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The ranks' steps, the reference's whole-batch step of each case and
    its GSPMD runs, the three made at once."""
    root = tmp_path_factory.mktemp("layouts_batch")
    gspmd = G.start({f"{layout}/{arch}": [arch, LAYOUTS[layout]]
                     for layout, arch in GSPMD}, root)
    started = {w: D.start_ranks(D.layout_rank, w, root, cases, 0)
               for w, cases in CASES.items()}
    whole = {}
    for arch, seed in sorted({(c["arch"], c["seed"])
                              for c in CASE.values()}):
        cfg = D.smoke(arch)
        whole[arch, seed] = P.reference_moved(
            arch, D.model_of(cfg, seed=seed)["params"],
            D.batch_of(cfg, seed=3 + seed))
    ranks = {w: D.ranks_of(s) for w, s in started.items()}
    return ranks, whole, G.results(gspmd, root)


@pytest.mark.parametrize("world,case", PARAMS)
def test_layout_matches_reference_whole_batch_step(results, world, case):
    c = CASE[case]
    P.shards_held_to_reference(
        results[0][world], case, results[1][c["arch"], c["seed"]],
        P.ROUNDING_GRAD_TOL.get((c["arch"], c["seed"]), P.TP_GRAD_TOL))


@pytest.mark.parametrize("layout,arch", GSPMD)
def test_reference_runs_the_layout_under_gspmd(results, layout, arch):
    """The reference's step under the layout computes its whole-batch
    step's function: the layout is one the JAX package runs."""
    ref = results[2]
    got, whole = ref[f"{layout}/{arch}"], ref[f"whole/{arch}"]
    for k in ("loss", "grad_norm"):
        assert got[k] == pytest.approx(whole[k], rel=GSPMD_RTOL), k
