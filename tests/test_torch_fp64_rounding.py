"""Where the port's fp32 train step and the reference's differ by more than
``TP_GRAD_TOL``, rounding or a fault: both packages' unsharded
gradients, from the same weights and batch, in fp32 here and in float64
in a process of its own (``_fp64_grads``), on xlstm's smoke config at
seeds 0, 1 and 2 (``_torch_dist.model_of(cfg, seed=seed)``,
``batch_of(cfg, seed=3 + seed)``; seed 1 is the input where the fp32
steps are 1.33e-5 of ``conv_w``'s largest gradient apart).

- In float64 the two packages compute one function: every leaf within
  ``FP64_TOL`` of its largest magnitude.
- The port's fp32 gradient is no further from the float64 one than
  ``ROUNDING_RATIO`` times the reference's own fp32 gradient is: the port
  rounds about as the reference does.
- Where a sharded step is held to the reference at
  ``_torch_train_parity.ROUNDING_GRAD_TOL``, that bound is below the
  reference's own fp32 distance from float64 there, and the port's
  unsharded step is within it.

Distances are each leaf's largest difference over that leaf's largest
float64 magnitude, the largest over the leaves.
"""

import numpy as np
import pytest

import _fp64_grads as F
import _torch_dist as D
import _torch_train_parity as P
from repro_torch.core.config import OptimizerConfig, ParallelConfig, \
    ShapeConfig
from repro_torch.training import make_train_step

XLSTM = "xlstm-1.3b"
SEEDS = (0, 1, 2)
# float64 against float64: the same sums in another order
FP64_TOL = 1e-12
# measured: the port's distance over the reference's 0.82, 1.32 and 0.39
# at seeds 0, 1 and 2
ROUNDING_RATIO = 2.0


def _distance(a: dict, b: dict) -> float:
    return max(float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
               for k in b)


@pytest.fixture(scope="module")
def grads(tmp_path_factory):
    """``{seed: {"ref32", "port32", "ref64", "port64"}}``, each a
    gradient tree keyed by the port's parameter names."""
    root = tmp_path_factory.mktemp("fp64")
    cfg = D.smoke(XLSTM)
    inputs = {s: (D.model_of(cfg, seed=s)["params"],
                  D.batch_of(cfg, seed=3 + s)) for s in SEEDS}
    proc = F.start({f"seed{s}": (XLSTM, {k: p.detach().numpy() for k, p in
                                         model.named_parameters()}, batch)
                    for s, (model, batch) in inputs.items()}, root)
    step = make_train_step(cfg, ShapeConfig("t", D.SEQ, D.BATCH, "train"),
                           OptimizerConfig(), ParallelConfig(remat="block"),
                           q_chunk=P.Q_CHUNK, ssm_chunk=P.SSM_CHUNK)
    out = {}
    for s, (model, batch) in inputs.items():
        port = step.grad_step(model, batch)[2]
        out[s] = {"port32": {k: g.numpy().astype(np.float64)
                             for k, g in port.items()},
                  "ref32": P.reference_whole_batch_step(
                      XLSTM, model, batch)["grads"]}
    for key, got in F.results(proc, root).items():
        s = int(key.removeprefix("seed"))
        out[s].update(ref64=got["ref"], port64=got["port"])
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_float64_steps_agree(grads, seed):
    g = grads[seed]
    assert set(g["port64"]) == set(g["ref64"])
    assert _distance(g["port64"], g["ref64"]) <= FP64_TOL


@pytest.mark.parametrize("seed", SEEDS)
def test_port_rounds_as_the_reference_does(grads, seed):
    g = grads[seed]
    port, ref = (_distance(g[k], g["ref64"]) for k in ("port32", "ref32"))
    assert port <= ROUNDING_RATIO * ref, (port, ref)


@pytest.mark.parametrize("arch,seed", sorted(P.ROUNDING_GRAD_TOL))
def test_rounding_bound_is_below_the_references_own_rounding(grads, arch,
                                                             seed):
    assert arch == XLSTM
    g, bound = grads[seed], P.ROUNDING_GRAD_TOL[arch, seed]
    assert _distance(g["ref32"], g["ref64"]) >= bound
    assert _distance(g["port32"], g["ref32"]) <= bound
