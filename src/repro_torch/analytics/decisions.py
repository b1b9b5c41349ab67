"""The paper's Fig. 6 Join decision node, verbatim logic.

    input  data_dist, node_status
    output decision tuple (func, scale, schedule)

    sizeA, sizeB = data_dist.A.size, data_dist.B.size
    nodeA, nodeB = data_dist.A.loc, data_dist.B.loc
    if sizeA / sizeB < T1 and |nodeA| > T2:
        func  = "merge_join"
        scale = (sizeA + sizeB) / alpha          # proportional to size
        schedule = ("round-robin", nodeA ∪ nodeB)
    else:
        func  = "hash_join"
        scale = num_of_avail_slots(node_status, nodeA)
        schedule = ("packing", nodeA)

plus the scheduling decision node for Fig. 4(e): round-robin under uniform
data, packing under skew.
"""

from __future__ import annotations

from repro_torch.core.decisions import (
    Decision,
    DecisionContext,
    DecisionNode,
    Schedule,
)

# Thresholds measured from Fig. 4: hash join wins while the small table is
# <~30 MB against a 400 MB probe side (ratio ~13) and on small clusters.
T1 = 13.0            # size ratio below which tables are "comparable"
T2 = 8               # cluster size above which broadcast gets expensive
ALPHA = 32 << 20     # bytes of input per function instance


def join_decision(ctx: DecisionContext) -> Decision:
    dist_a, dist_b = ctx.data_dist["A"], ctx.data_dist["B"]
    size_a, size_b = dist_a.size, dist_b.size
    node_a, node_b = dist_a.loc, dist_b.loc

    if size_a / max(size_b, 1) < T1 and len(node_a) > T2:
        func = "merge_join"
        scale = max(1, int((size_a + size_b) / ALPHA))
        schedule = Schedule("round-robin", tuple(sorted(node_a | node_b)))
    else:
        func = "hash_join"
        scale = max(1, ctx.node_status.free(node_a))
        slots = ctx.node_status.total_slots
        schedule = Schedule("packing", tuple(sorted(node_a)),
                            slots_per_node=max(slots.values()) if slots else 8)
    return Decision(func, scale, schedule)


def join_decision_node() -> DecisionNode:
    return DecisionNode("join", join_decision)


def cost_model_join_decision(ctx: DecisionContext) -> Decision:
    """Refined DYN strategy (paper Fig. 5 step 4: developers fold profiling
    feedback into the decision node): choose the join plan by napkin-math
    over calibrated operator rates + link bandwidth instead of fixed T1/T2.
    """
    rates = ctx.profile.get("rates")
    if rates is None:
        from repro_torch.analytics.simulator import calibrated_rates
        rates = calibrated_rates()
    dist_a, dist_b = ctx.data_dist["A"], ctx.data_dist["B"]
    size_a, size_b = dist_a.size, max(dist_b.size, 1)
    node_a = dist_a.loc or frozenset(ctx.node_status.total_slots)
    status = ctx.node_status
    nodes = sorted(status.total_slots)
    slots = max(status.total_slots.values()) if status.total_slots else 8
    bw = ctx.app.get("net_bw", 1.25e9)
    n_nodes = len(nodes)
    scale = max(1, int((size_a + size_b) / ALPHA))   # paper: ∝ data size
    par = max(1, min(scale, status.free()))          # slot-limited waves

    # merge join: all-to-all shuffle of both tables + sort-merge compute
    shuffle_t = (size_a + size_b) / (n_nodes * bw)
    merge_t = shuffle_t + (size_a + size_b) / par / rates["merge_join"]

    # hash join: broadcast B to every node (senders = B's homes, serialized),
    # one build per node, parallel probe
    homes = max(1, len(dist_b.loc))
    bcast_t = size_b * n_nodes / (homes * bw)
    hash_t = bcast_t + size_b / rates["hash_build"] \
        + size_a / par / rates["hash_probe"]

    # consolidation (the paper's 2 GB case): pull everything to one node,
    # no shuffle, limited to `slots` parallel functions
    pull_t = (size_a + size_b) * (n_nodes - 1) / n_nodes / bw
    consol_t = pull_t + size_a / min(par, slots) / rates["hash_probe"] \
        + size_b / rates["hash_build"]

    best = min(merge_t, hash_t, consol_t)
    if best == consol_t:
        target = max(dist_a.bytes_per_node, key=dist_a.bytes_per_node.get)
        return Decision("hash_join", min(scale, slots),
                        Schedule("packing", (target,), slots_per_node=slots),
                        extras=(("consolidate", True),
                                ("est_seconds", consol_t)))
    if best == merge_t:
        return Decision("merge_join", scale,
                        Schedule("round-robin", tuple(nodes)),
                        extras=(("est_seconds", merge_t),))
    return Decision("hash_join", scale,
                    Schedule("round-robin", tuple(sorted(node_a))),
                    extras=(("est_seconds", hash_t),))


def cost_model_join_node() -> DecisionNode:
    return DecisionNode("join_cost_model", cost_model_join_decision,
                        fallback=join_decision)


def scheduling_decision(ctx: DecisionContext) -> Decision:
    """Fig. 4(e): packing beats round-robin under skewed (Pareto) data."""
    dist = next(iter(ctx.data_dist.values()))
    nodes = tuple(sorted(ctx.node_status.total_slots))
    scale = max(1, int(dist.size / ALPHA))
    slots = max(ctx.node_status.total_slots.values())
    if dist.skew > 1.5:
        # skewed: consolidate onto the data-heavy nodes
        heavy = tuple(sorted(dist.bytes_per_node,
                             key=lambda n: -dist.bytes_per_node[n]))
        return Decision("process", scale,
                        Schedule("packing", heavy, slots_per_node=slots))
    return Decision("process", scale, Schedule("round-robin", nodes))


def scheduling_decision_node() -> DecisionNode:
    return DecisionNode("schedule", scheduling_decision)
