"""Model plane of the port: the dense attention LM (``lm``), its layers and
attention, and the carry-across of reference weights (``convert``)."""

from repro_torch.models.lm import (  # noqa: F401
    LM,
    decode_step,
    forward,
    init_decode_state,
    init_lm,
    prefill_step,
)
