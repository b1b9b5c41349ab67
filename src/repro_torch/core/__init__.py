"""Decision workflows + decentralized control plane (pure Python).

The model half of the reference's ``core/config.py`` belongs to the
language-model plane and is not part of this package yet.
"""

from .decisions import (  # noqa: F401
    DataDist,
    Decision,
    DecisionContext,
    DecisionNode,
    DecisionWorkflow,
    LateBindingError,
    NodeStatus,
    Schedule,
    Stage,
    WorkflowRun,
    default_node,
)
from .controllers import (  # noqa: F401
    Claim,
    ConflictError,
    GlobalController,
    PrivateController,
)
