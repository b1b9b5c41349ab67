"""Shared helpers for architecture configs: the inputs of each shape cell
(the port of ``repro/configs/common.py``).

``input_specs`` gives each model input of an (arch x shape) cell as a
``(shape, torch dtype)`` pair, where the reference gives a
``ShapeDtypeStruct``; ``concrete_inputs`` draws tensors of those specs from
an explicit generator.
"""

from __future__ import annotations

import torch

from repro_torch.core.config import Frontend, ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.lm import AUDIO_FRAME_DIM


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``{name: (shape, dtype)}`` of the train/prefill inputs or of the
    decode token batch."""
    b = shape.global_batch
    s = shape.seq_len
    i32 = torch.int32
    dtype = getattr(torch, cfg.dtype)

    if shape.mode == "decode":
        return {"tokens": ((b, 1), i32)}

    specs: dict = {}
    if cfg.frontend == Frontend.VISION_STUB.value:
        n_text = s - cfg.stub_patches
        assert n_text > 0
        specs["tokens"] = ((b, n_text), i32)
        specs["patch_embeds"] = ((b, cfg.stub_patches, cfg.d_model), dtype)
    elif cfg.frontend == Frontend.AUDIO_STUB.value:
        specs["tokens"] = ((b, s), i32)
        specs["frame_embeds"] = ((b, s, AUDIO_FRAME_DIM), dtype)
    else:
        specs["tokens"] = ((b, s), i32)

    if shape.mode == "train":
        # labels align with text positions (the VLM stub's patch positions
        # carry no loss)
        specs["labels"] = (specs["tokens"][0], i32)
    return specs


def concrete_inputs(cfg: ModelConfig, shape: ShapeConfig,
                    generator: torch.Generator | None = None,
                    device=None) -> dict:
    """Tensors matching ``input_specs`` on ``device`` (the card unless the
    caller passes ``"cpu"``): token ids uniform in ``[0, vocab - 1)``,
    embeddings standard normal, drawn from ``generator`` (one on that
    device seeded with 0 by default) in the specs' order."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    out = {}
    for name, (dims, dtype) in input_specs(cfg, shape).items():
        if dtype.is_floating_point:
            out[name] = torch.randn(dims, generator=generator, device=dev,
                                    dtype=dtype)
        else:
            out[name] = torch.randint(0, max(2, cfg.vocab_size - 1), dims,
                                      generator=generator, device=dev,
                                      dtype=dtype)
    return out


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Shape cells that apply to this arch (long_500k: sub-quadratic
    only)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names
