"""The port's device rule.

Every entry point (``execute_query_runtime``, ``Runtime``, the kernel
wrappers) runs on ``cuda`` unless its caller passes ``device="cpu"``. With
no card and no explicit CPU request it raises: nothing drops silently to
the CPU, so a run that claims the card really ran there. ``Hardware``
holds the figures the planners price work with; ``H100_SXM`` is the
card's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Hardware:
    """One accelerator's figures, as the cost models read them: dense bf16
    FLOP/s, device-memory bytes/s, bytes/s of one link to a peer (one
    direction) and device-memory bytes; and ``accum_bytes``, the bytes a
    parameter of gradient accumulators the trainer keeps beyond the
    reference's 16 (bf16 weight and gradient, fp32 master, m and v): 0 for
    the reference's trainer, 4 for the port's fp32 accumulators
    (``repro_torch.training.train_step``)."""

    peak_flops: float
    hbm_bw: float
    link_bw: float
    hbm_bytes: float
    accum_bytes: float = 0.0


# NVIDIA's H100 SXM5 data sheet: 989 TFLOP/s dense bf16, HBM3 at 3.35 TB/s,
# NVLink 4 at 900 GB/s a GPU in both directions (450 GB/s each way), 80 GB;
# the port's trainer sums microbatch gradients in fp32
H100_SXM = Hardware(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
                    hbm_bytes=80e9, accum_bytes=4.0)


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
