"""FLOPs of the port's dry-run (``repro_torch.launch.dispatch_analysis``)
on the Mamba hybrid, jamba-v0.1-52b at full width cut to one 8-layer
period of its pattern (seven Mamba layers and one attention layer, MoE
FFNs on every other layer), against the JAX reference's ``analyze`` of its
compiled step (``repro.launch.hlo_analysis``): equal but the terms
``_torch_flop_terms`` names (attention, the loss's recompute, the causal
conv, the scan's outer product), prefill and a train step. The train step
runs without remat, as ``test_torch_dryrun.py``'s xlstm step does, for the
reason it gives. In a file of its own: the reference's train step takes
about half a minute to lower and compile.
"""

import pytest

import _torch_flop_terms as F


@pytest.mark.parametrize("mode,remat", [("prefill", "none"),
                                        ("train", "none")])
def test_jamba_flops_match_reference_but_the_named_terms(mode, remat):
    jcfg, tcfg = F.configs("jamba-v0.1-52b", 8)
    ref = F.reference_flops(jcfg, mode, 2, 256, remat)
    got = F.port_costs(tcfg, mode, 2, 256, remat)
    named = F.terms(tcfg, mode, 2, 256, remat)
    assert ref - int(got.flops) == sum(named.values()), (named, ref,
                                                         got.flops)
    # the MoE dispatch runs on K2 (bytes, no FLOPs), K4 once a forward
    assert got.kernel_launches["partition_scatter"] > 0
    assert got.kernel_launches["flash_attention"] == 1
