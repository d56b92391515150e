"""Training over a mesh: the port's ``ray_tpu/parallel``. The mesh and its
process groups (``mesh``), the collectives over a mesh axis, with the
gradient-carrying ones FSDP, TP, Ulysses and the MoE need
(``collectives``), the sharding rules and each rank's shards of a
parameter tree (``sharding``), ring attention through the stats kernel and
Ulysses (``ring_attention``, ``ulysses``), the MoE and its expert
parallelism over the ``ep`` axis (``moe``), a step's loss and gradients
over a split batch and sharded parameters (``training``), the GPipe
schedule over the ``pp`` axis with TP and FSDP inside its stages
(``pipeline``), the MPMD pipeline of stage actors over a compiled DAG
(``mpmd_pipeline``), and the sharded dryrun (``dryrun``)."""

from . import collectives, moe, mpmd_pipeline
from .dryrun import dryrun_multichip, dryrun_rank
from .mesh import (AXES, Mesh, MeshSpec, data_axes, local_batch_size,
                   make_mesh, mesh_spec_from_string, shard_batch)
from .moe import (ep_moe_ffn, expert_shardings, make_ep_moe_ffn,
                  moe_ffn_dense)
from .pipeline import (make_pipelined_loss, make_stage_fn,
                       pipeline_shardings, pipelined_specs, spmd_pipeline,
                       stack_layers, to_pipeline_params, unstack_layers)
from .ring_attention import make_ring_attention, ring_attention
from .sharding import (LLAMA_RULES, VIT_RULES, Placement,
                       activation_sharding, clean_spec, gather_params,
                       optimizer_shardings, shard_params, shardings_for_tree,
                       spec_for, stage_submesh)
from .training import (allreduce_grads, global_grad_norm,
                       sharded_loss_fn)
from .ulysses import make_ulysses_attention, ulysses_attention

__all__ = [
    "AXES", "Mesh", "MeshSpec", "make_mesh", "mesh_spec_from_string",
    "data_axes", "local_batch_size", "shard_batch", "collectives",
    "ring_attention", "make_ring_attention", "ulysses_attention",
    "make_ulysses_attention", "sharded_loss_fn", "allreduce_grads",
    "global_grad_norm", "LLAMA_RULES", "VIT_RULES", "spec_for",
    "clean_spec", "shardings_for_tree", "shard_params", "gather_params",
    "optimizer_shardings", "activation_sharding", "Placement",
    "dryrun_multichip", "dryrun_rank", "moe", "moe_ffn_dense",
    "ep_moe_ffn", "make_ep_moe_ffn", "expert_shardings",
    "spmd_pipeline", "make_stage_fn", "stack_layers", "unstack_layers",
    "pipeline_shardings", "make_pipelined_loss", "to_pipeline_params",
    "pipelined_specs", "mpmd_pipeline", "stage_submesh",
]
