"""Checkpointing, restart supervision, elastic rescaling (the port of
``repro/ckpt``)."""

from repro_torch.ckpt.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.ckpt.supervisor import StragglerEvent, Supervisor  # noqa: F401
