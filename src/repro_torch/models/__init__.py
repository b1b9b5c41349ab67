"""Model plane of the port: the attention LM (``lm``) with dense or MoE
FFNs (``moe``), its layers and attention, and the carry-across of reference
weights (``convert``)."""

from repro_torch.models.lm import (  # noqa: F401
    LM,
    decode_step,
    forward,
    init_decode_state,
    init_lm,
    prefill_step,
)
