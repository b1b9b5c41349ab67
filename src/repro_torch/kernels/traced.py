"""The kernels' side of a dispatch trace
(``repro_torch.launch.dispatch_analysis``).

A trace runs a step on meta tensors: shapes, dtypes and strides, no
storage. A kernel wrapper given a meta tensor while a trace is active
launches nothing; it hands ``kernel`` its name, the work its function does
(the same formula ``chip_smoke.py`` prices its bound with) and two ways to
make its outputs, and returns what the trace gives back. Outside a trace a
meta tensor is refused as before, and nothing here is read on a real run
but one ``is None`` test.
"""

from __future__ import annotations

from typing import Callable

import torch

# the active ``dispatch_analysis.Tracer``, or None
TRACER = None


def tracing(t: torch.Tensor) -> bool:
    """Whether ``t`` is a tensor of an active trace."""
    return TRACER is not None and t.is_meta


def kernel(name: str, flops: float, nbytes: float, card: Callable,
           plain: Callable | None = None):
    """One call of kernel ``name`` under the trace, doing ``flops`` and
    moving ``nbytes``: its outputs from ``card()`` (the allocations of the
    CUDA route) when the trace follows the card's program, from
    ``plain()`` (the plain route, its own operations not counted) when it
    follows the CPU's and the plain route can run on meta tensors."""
    return TRACER.kernel(name, flops, nbytes, card, plain)


def scratch(name: str, numel: int, dtype: torch.dtype) -> None:
    """A kernel's per-stream scratch of at least ``numel`` elements, kept
    from call to call and replaced by a larger one where a call needs more
    (``streams.StreamScratch``), on the card's program only."""
    TRACER.scratch(name, numel, dtype)
