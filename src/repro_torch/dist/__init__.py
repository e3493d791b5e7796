"""Distributed sparsity (port of ``repro/dist``): sharding rules over
DTensor, sparse collectives, compression and elasticity.

Submodules:
  * ``sharding``    — logical-axis rules, param/batch specs, placements,
    constraints
  * ``collectives`` — densify-allreduce-resparsify + value-only fast path
  * ``compression`` — top-k + error-feedback gradient exchange
  * ``elastic``     — straggler watchdog and remesh planning

The reference's ``compat`` (a version shim of JAX's ``shard_map``) has no
counterpart: the port's ``shard_map`` is
``torch.distributed.tensor.experimental.local_map`` or an explicit
``to_local`` with functional collectives.
"""

from repro_torch.dist.collectives import (
    allreduce_mean,
    densify_allreduce_resparsify,
    fixed_mask_value_allreduce,
)
from repro_torch.dist.compression import compressed_allreduce, ef_step
from repro_torch.dist.elastic import StragglerWatchdog, plan_remesh
from repro_torch.dist.sharding import (
    ShardingRules,
    active_rules,
    batch_spec,
    distribute_params,
    logical_constraint,
    param_specs,
    tree_shardings,
    use_rules,
)

__all__ = [
    "allreduce_mean", "densify_allreduce_resparsify",
    "fixed_mask_value_allreduce", "compressed_allreduce", "ef_step",
    "StragglerWatchdog", "plan_remesh", "ShardingRules", "active_rules",
    "batch_spec", "distribute_params", "logical_constraint", "param_specs",
    "tree_shardings", "use_rules",
]
