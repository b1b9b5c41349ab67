"""One train step of every non-dense family of the PyTorch port against the
JAX reference on the CPU (``_torch_train_parity.check_train_step``): MoE
(granite), hybrid Mamba + attention + MoE (jamba), mLSTM + sLSTM (xlstm),
and the audio and vision stub frontends (musicgen, internvl2). The dense
models are in ``test_torch_training.py``."""

import numpy as np
import pytest

from _torch_train_parity import check_train_step


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b",
                                  "xlstm-1.3b", "musicgen-medium",
                                  "internvl2-1b"])
def test_train_step_matches_reference(arch):
    grads = check_train_step(arch)
    nonzero = {path for path, g in grads.items() if np.any(g)}
    # every leaf learns: the sLSTM's recurrent weights through the step's
    # layout inside the graph, the Mamba scan's inputs through its stacked
    # states, every router through the top-k probabilities
    assert nonzero == set(grads), sorted(set(grads) - nonzero)
    if arch == "xlstm-1.3b":
        assert any("r_gates" in path for path in grads)
    if arch == "jamba-v0.1-52b":
        assert any("a_log" in path for path in grads)
        assert any("router" in path for path in grads)
