"""Serverless data-analytics case study (the paper's §3/§6 workload): the
runtime plane and the simulator plane of the query path, both bound by one
decision workflow."""

from repro_torch.analytics.table import (  # noqa: F401
    DistTable,
    Table,
    TableSlice,
    distribute,
    from_numpy,
    on_device,
    synth_table,
)
from repro_torch.analytics.decisions import (  # noqa: F401
    join_decision_node,
    scheduling_decision_node,
)
from repro_torch.analytics.planner import (  # noqa: F401
    AdaptiveQueryPlan,
    build_query_workflow,
    estimate_scan_output,
    plan_query_with_workflow,
    stages_for_run,
)
from repro_torch.analytics.simulator import (  # noqa: F401
    ClusterSim,
    SimTask,
    calibrated_rates,
    make_cluster,
    sim_fault_models,
)
from repro_torch.analytics.query import (  # noqa: F401
    QueryStrategy,
    execute_query_runtime,
    execute_query_torch,
    plan_query_tasks,
    plan_runtime_stages,
    prepare_query_plan,
    reference_query_numpy,
    resolve_join_decision,
    split_partitions,
    synth_query_tables,
)
