"""The layouts that split the kv heads over other mesh axes than the query
heads, which the JAX reference runs and the port's ``TensorPlan`` lays
out by gathering the kv projections over the kv split
(``TensorPlan.kv_gather``: ``wk``, ``wv`` and qwen's ``bk``, ``bv``
joined whole, their gradient reduce-scattered back) and cutting the kv
heads the rank's query heads read (``attention._local_kv``). On spawned
``gloo`` ranks on the CPU, fp32 smoke configs, ``data=2 x model=2``
(``sharding.LAYOUTS``):

- ``kv_heads_off_heads`` (the query heads over ``model``, the kv heads
  over ``data``) on llama (the mlp over ``model``) and granite (the
  experts over ``model``);
- ``kv_within_heads`` (the query heads over ``("data", "model")``, the
  kv heads over ``model``) on qwen1.5-4b, with its qkv biases.

Every case, from seeds 0 and 1's weights and batches, is held to the
reference's whole-batch ``make_train_step`` from the same weights under
AdamW without warmup (``_torch_train_parity.shards_held_to_reference``).

In serving (``_torch_dist.tp_serve_rank``), ``forward``, ``prefill_step``
and decode steps from rewound positions under ``kv_heads_off_heads``
(llama, granite) and under ``heads_over_batch`` with ``cache_seq`` over
``data`` (llama: the heads, kv heads and cache whole, their weights
gathered, as the reference's ``spec`` gives them beside the batch), each
logit within ``LOGIT_TOL`` of the reference's unsharded calls. Under
``kv_heads_off_heads`` each rank's decode cache holds only the kv heads
its query heads read (``CACHE_HEADS``).

The reference's own step under each train case's layout runs under GSPMD
on a 2 x 2 mesh of forced host devices in one subprocess (``_jax_gspmd``)
while the ranks run: its loss and grad norm are its whole-batch step's
within ``GSPMD_RTOL``.
"""

import numpy as np
import pytest

import _jax_gspmd as G
import _torch_dist as D
import _torch_train_parity as P
from repro_torch.parallel.sharding import LAYOUTS

D2M2 = {"data": 2, "model": 2}
SEEDS = (0, 1)
LLAMA, QWEN, GRANITE = "llama3.2-3b", "qwen1.5-4b", "granite-moe-1b-a400m"
LAYOUT_CASES = [("kv_heads_off_heads", LLAMA),
                ("kv_heads_off_heads", GRANITE),
                ("kv_within_heads", QWEN)]
CASES = [{"id": f"{layout}/{arch}/seed{seed}", "arch": arch, "mesh": D2M2,
          "layout": layout, "seed": seed}
         for layout, arch in LAYOUT_CASES for seed in SEEDS]
CASE = {c["id"]: c for c in CASES}
CACHE_OVER_BATCH = dict(LAYOUTS["heads_over_batch"], cache_seq="data")
SERVE = [{"id": f"serve/kv_heads_off_heads/{arch}", "arch": arch,
          "mesh": D2M2, "layout": "kv_heads_off_heads",
          "serve_layout": "kv_heads_off_heads"} for arch in (LLAMA, GRANITE)]
SERVE.append({"id": "serve/heads_over_batch/llama", "arch": LLAMA,
              "mesh": D2M2, "layout": CACHE_OVER_BATCH,
              "serve_layout": CACHE_OVER_BATCH})
SERVE_CASE = {c["id"]: c for c in SERVE}
LOGIT_TOL = 1e-4
GSPMD_RTOL = 1e-5


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The ranks' steps and serving calls, each case's whole-batch
    reference step and the reference's GSPMD runs, the three made at
    once."""
    root = tmp_path_factory.mktemp("layouts_kv")
    gspmd = G.start({f"{layout}/{arch}": [arch, LAYOUTS[layout]]
                     for layout, arch in LAYOUT_CASES}, root)
    started = D.start_ranks(D.layout_rank, 4, root, CASES, 0, SERVE)
    whole = {}
    for arch, seed in sorted({(c["arch"], c["seed"]) for c in CASES}):
        cfg = D.smoke(arch)
        whole[arch, seed] = P.reference_moved(
            arch, D.model_of(cfg, seed=seed)["params"],
            D.batch_of(cfg, seed=3 + seed))
    serve = {arch: P.reference_serve(arch)
             for arch in sorted({c["arch"] for c in SERVE})}
    return D.ranks_of(started), whole, serve, G.results(gspmd, root)


@pytest.mark.parametrize("case", list(CASE))
def test_layout_matches_reference_whole_batch_step(results, case):
    c = CASE[case]
    P.shards_held_to_reference(results[0], case,
                               results[1][c["arch"], c["seed"]])


@pytest.mark.parametrize("case", list(SERVE_CASE))
def test_layout_serving_matches_reference(results, case):
    want = results[2][SERVE_CASE[case]["arch"]]
    for o in results[0]:
        res = o[case]
        for name in ("forward", "prefill"):
            np.testing.assert_allclose(res[name], want[name],
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                       err_msg=name)
        assert len(res["decode"]) == len(want["decode"]) == D.DECODE_STEPS
        for i, (got, w) in enumerate(zip(res["decode"], want["decode"])):
            np.testing.assert_allclose(got, w, atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL, err_msg=f"step {i}")


def test_cache_over_the_batch_axis_is_whole(results):
    """``cache_seq`` over the batch's own axis drops out of the cache's
    ``("batch", "cache_seq", ...)`` spec, as in the reference: every rank
    holds all ``MAX_SEQ`` positions."""
    for o in results[0]:
        assert o["serve/heads_over_batch/llama"]["cache_rows"] == D.MAX_SEQ


# the kv heads each rank's decode cache holds: under ``kv_heads_off_heads``
# those its query heads (half of them, over ``model``) read, one of the
# smoke configs' two, the reference's cache split over ``data``; under
# ``heads_over_batch`` all of them, the heads whole beside the batch
CACHE_HEADS = {"serve/kv_heads_off_heads/llama3.2-3b": 1,
               "serve/kv_heads_off_heads/granite-moe-1b-a400m": 1,
               "serve/heads_over_batch/llama": 2}


@pytest.mark.parametrize("case", list(CACHE_HEADS))
def test_cache_holds_the_kv_heads_the_rank_reads(results, case):
    for o in results[0]:
        assert o[case]["cache_heads"] == CACHE_HEADS[case]


@pytest.mark.parametrize("layout,arch", LAYOUT_CASES)
def test_reference_runs_the_layout_under_gspmd(results, layout, arch):
    """The reference's step under the layout computes its whole-batch
    step's function: the layout is one the JAX package runs."""
    ref = results[3]
    got, whole = ref[f"{layout}/{arch}"], ref[f"whole/{arch}"]
    for k in ("loss", "grad_norm"):
        assert got[k] == pytest.approx(whole[k], rel=GSPMD_RTOL), k
