"""Serving substrate: continuous batching engine + batching decision node."""

from repro_torch.serving.engine import (  # noqa: F401
    Request,
    ServingEngine,
    batching_decision_node,
)
