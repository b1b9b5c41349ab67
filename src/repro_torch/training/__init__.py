"""Training of the port: the AdamW optimizer, the chunked cross-entropy and
the train-step builder (the port of ``repro/training``; the optimizer
state's sharding, ``opt_state_axes``, waits for a mesh)."""

from repro_torch.training.optimizer import (  # noqa: F401
    apply_updates,
    init_opt_state,
    lr_schedule,
)
from repro_torch.training.losses import chunked_cross_entropy  # noqa: F401
from repro_torch.training.train_step import (  # noqa: F401
    init_train_state,
    make_eval_step,
    make_train_step,
)
