# Distributed training of the port: logical-axis sharding over a
# torch.distributed DeviceMesh (`sharding`) and the data-parallel
# collectives the losses and k-means call (`collectives`).
from repro_torch.distributed.sharding import (
    LOGICAL_RULES,
    arch_rules,
    logical_to_pspec,
    make_shardings,
    prune_pspec,
    shard_params,
    with_sharding_constraint,
)
