"""Executable serverless function runtime (paper's shared substrate).

The control plane (``repro_torch.core``) decides *func/scale/schedule*;
this package executes those decisions: stateless function instances
(``invoker``) run registered partitioned-analytics functions
(``functions``) over an ephemeral externalized-state store (``store``),
orchestrated as a stage DAG (``executor``), with per-invocation metrics
(``metrics``) folded back into the decision workflows and optionally
replayed into the cluster simulator so both data planes share one plan.
Function bodies run in-process (``invoker``) or in long-lived worker
subprocesses (``workers``); a multi-query scheduler (``scheduler``) shares
one runtime among many queries.
"""

from repro_torch.runtime.storage import (  # noqa: F401
    DiskBackend,
    MemoryBackend,
    ObjectStoreBackend,
    StorageBackend,
    make_backend,
)
from repro_torch.runtime.store import (  # noqa: F401
    Blob,
    QuotaExceededError,
    ShuffleStore,
    StageLostError,
)
from repro_torch.runtime.faults import (  # noqa: F401
    CrashFault,
    FaultInjector,
    FaultPlan,
    InjectedCrashError,
    InjectedFault,
    RecoveryError,
    SpeculationPolicy,
    StageLossFault,
    StragglerFault,
    WorkerKilledError,
    WorkerKillFault,
)
from repro_torch.runtime.lineage import (  # noqa: F401
    LineageLog,
    RecoveryEvent,
    StageLineage,
    expected_recovery,
)
from repro_torch.runtime.metrics import (  # noqa: F401
    InvocationRecord,
    MetricsSink,
    StageMetrics,
)
from repro_torch.runtime.invoker import (  # noqa: F401
    FnContext,
    InlineInvoker,
    Invocation,
    InvocationError,
    Invoker,
    SlotGate,
    ThreadPoolInvoker,
)
from repro_torch.runtime.functions import FUNCTIONS, register  # noqa: F401
from repro_torch.runtime.workers import (  # noqa: F401
    ProcessPoolInvoker,
    WorkerPool,
)
from repro_torch.runtime.executor import (  # noqa: F401
    DAGExecutor,
    Runtime,
    RuntimeStage,
    StagePlanner,
)
from repro_torch.runtime.scheduler import (  # noqa: F401
    FairShareGate,
    GateTimeoutError,
    QueryJob,
    QueryResult,
    QueryScheduler,
)
