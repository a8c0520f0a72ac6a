"""Device mesh + sharding on ``torch.distributed`` (port of the JAX
package's ``parallel/``).

One process a rank, every rank running the same program in lockstep:

* ``mesh`` — ``MeshConfig`` and ``build_mesh``: the named axes ``dp``
  (data parallel: the engine's slots), ``pp``, ``sp``, ``ep`` and ``tp``
  (tensor parallel: megatron-style weight shards), each a process group;
* ``multihost`` — ``initialize_multihost``: the process group's join
  (NCCL between cards; gloo on the CPU when it is named);
* ``sharding`` — the logical-axis rules and ``shard_pytree``, which puts
  only a rank's shard of each leaf on its device;
* ``collectives`` — the collectives GSPMD inserts in the JAX package,
  written out (tp all-reduce and all-gather, dp all-gather, the rank-0
  broadcast of a host decision).

The JAX package's ring and Ulysses attention (sp) and its pipeline (pp)
are not ported yet.
"""

from copilot_for_consensus_tpu_torch.parallel.mesh import (
    MESH_AXES,
    Mesh,
    MeshConfig,
    build_mesh,
    local_mesh,
)
from copilot_for_consensus_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    LogicalAxisRules,
    logical_to_spec,
    serving_param_rules,
    shard_pytree,
)

__all__ = [
    "MESH_AXES",
    "Mesh",
    "MeshConfig",
    "build_mesh",
    "local_mesh",
    "LogicalAxisRules",
    "DEFAULT_RULES",
    "logical_to_spec",
    "serving_param_rules",
    "shard_pytree",
]
