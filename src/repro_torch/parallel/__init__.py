"""Distribution layer of the port (the port of ``repro/parallel``):
logical-axis sharding rules, the strategy decision nodes
(``strategies``), the collectives (``collectives``), how a rank runs the
model under rules that split more than the batch (``tensor``) and the
GPipe pipeline over ``pod`` (``pipeline``). Meshes are
``repro_torch.launch.mesh``'s."""

from repro_torch.parallel.sharding import (  # noqa: F401
    ShardingRules,
    current_rules,
    logical_shard,
    make_param_sharding,
    pad_to_multiple,
    use_rules,
)
