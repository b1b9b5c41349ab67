"""Rank bodies of ``test_torch_dryrun_parity.py`` (no JAX: the spawned
children import this module): one real train step of the port on its
``gloo`` rank, and what ``collectives.COLLECTIVE_STATS`` recorded in it.
"""

from __future__ import annotations

import _torch_dist as D


def collective_rank(rank, world, cases):
    """Each case's train step on the rank's shards of seed 0's weights
    (``_torch_dist.case_rules``; the GPipe step under ``pp_rules`` where
    the case says ``pipeline``, on the shards of its stage), with the collective counters set to 0
    just before it: ``{case id: COLLECTIVE_STATS}``."""
    from repro_torch.core.config import OptimizerConfig
    from repro_torch.models.convert import shard_params
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.pipeline import (init_pp_train_state,
                                               make_pp_train_step, pp_rules)
    from repro_torch.training import init_train_state, make_train_step
    out = {}
    for case in cases:
        cfg, shape, pc, rules = D.case_rules(case)
        if case.get("pipeline"):
            rules = pp_rules(rules)
            state = init_pp_train_state(cfg, shard_params(
                D.model_of(cfg)["params"], rules), rules.mesh)
            step = make_pp_train_step(cfg, shape, OptimizerConfig(), pc,
                                      rules, ssm_chunk=D.SSM_CHUNK)
        else:
            state = init_train_state(cfg, shard_params(
                D.model_of(cfg)["params"], rules))
            step = make_train_step(cfg, shape, OptimizerConfig(), pc,
                                   ssm_chunk=D.SSM_CHUNK, rules=rules)
        batch = D.batch_of(cfg)
        C.reset_collective_stats()
        step(state, batch)
        out[case["id"]] = {k: dict(v) for k, v in
                           C.COLLECTIVE_STATS.items()}
    return out
