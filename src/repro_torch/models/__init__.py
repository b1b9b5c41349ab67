"""Model plane of the port: the LM (``lm``) of attention (``attention``),
Mamba (``ssm``), mLSTM and sLSTM (``xlstm``) blocks with dense, MoE
(``moe``) or no FFNs behind a token or stub frontend, its layers, and the
carry-across of reference weights (``convert``)."""

from repro_torch.models.lm import (  # noqa: F401
    AUDIO_FRAME_DIM,
    LM,
    decode_step,
    forward,
    forward_hidden,
    init_decode_state,
    init_lm,
    prefill_step,
)
