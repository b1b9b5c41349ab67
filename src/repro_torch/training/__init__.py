"""Training of the port: the AdamW optimizer (and its state's logical
axes, ``opt_state_axes``), the chunked cross-entropy and the train-step
builder, data-parallel over the batch axes of the sharding rules it is
given and tensor-, sequence-, expert-, inner- and ZeRO-3-parallel over
the rest (the port of ``repro/training``; the GPipe step over ``pod`` is
``repro_torch.parallel.pipeline``'s)."""

from repro_torch.training.optimizer import (  # noqa: F401
    apply_updates,
    init_opt_state,
    lr_schedule,
    opt_state_axes,
)
from repro_torch.training.losses import chunked_cross_entropy  # noqa: F401
from repro_torch.training.train_step import (  # noqa: F401
    init_train_state,
    make_eval_step,
    make_train_step,
)
