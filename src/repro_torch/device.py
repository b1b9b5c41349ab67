"""The port's device rule.

Every entry point (``execute_query_runtime``, ``Runtime``, the kernel
wrappers) runs on ``cuda`` unless its caller passes ``device="cpu"``. With
no card and no explicit CPU request it raises: nothing drops silently to
the CPU, so a run that claims the card really ran there.
"""

from __future__ import annotations

import torch


class NoDeviceError(RuntimeError):
    """A CUDA entry point was called on a machine without a card."""


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; ``"cpu"`` (or a CPU ``torch.device``) is an
    explicit request for the CPU. A CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
