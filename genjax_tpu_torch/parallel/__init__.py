"""The scale-out layer: process groups and meshes, sharded particle and
chain batches, collective resampling, and the sharded SMC, MCMC, data- and
tensor-parallel drivers.

Counterpart of ``genjax_tpu/parallel/``. The reference drives many devices
from one process with ``shard_map`` and XLA collectives; the port runs one
process a rank on a ``torch.distributed`` process group (NCCL on the card,
gloo on the CPU), every rank the same program on its own shard, every
collective a call of ``_comm.py``. ``shard_map_compat`` has no counterpart;
``collective_log`` and ``collective_counts`` (``hlo_collectives``, the
reference's name) audit the collectives issued, where the reference reads
them out of compiled HLO.
"""

from ._comm import collective_log
from .audit import collective_counts, hlo_collectives
from .data import data_sharded_logdensity, make_mesh_2d, minibatch_logdensity, shard_data
from .islands import IslandFilterResult, IslandParticleFilter
from .mcmc import run_chains_sharded, warmup_adapt_step_size
from .mesh import (
    Mesh,
    gather_batch,
    host_local_mesh,
    initialize_distributed,
    make_hier_mesh,
    make_mesh,
    mesh_generators,
    shard_batch,
)
from .rbpf import RBPFResult, rbpf
from .resampling import (
    collective_log_normalizer,
    collective_resample,
    collective_weight_stats,
    effective_sample_size,
    multinomial_indices,
    packed_take,
    redistribute,
    resample_indices,
    resample_particles,
    residual_indices,
    stratified_counts,
    stratified_indices,
    systematic_counts,
    systematic_indices,
)
from .smc import ParticleFilterResult, SSMParticleFilter, sharded_importance
from .tensor_parallel import (
    bnn_logdensity_reference,
    bnn_param_count,
    shard_params,
    tensor_parallel_logdensity,
    tp_bnn_logdensity,
)

__all__ = [
    "IslandFilterResult",
    "IslandParticleFilter",
    "Mesh",
    "ParticleFilterResult",
    "RBPFResult",
    "SSMParticleFilter",
    "bnn_logdensity_reference",
    "bnn_param_count",
    "collective_counts",
    "collective_log",
    "collective_log_normalizer",
    "collective_resample",
    "collective_weight_stats",
    "data_sharded_logdensity",
    "effective_sample_size",
    "gather_batch",
    "hlo_collectives",
    "host_local_mesh",
    "initialize_distributed",
    "make_hier_mesh",
    "make_mesh",
    "make_mesh_2d",
    "mesh_generators",
    "minibatch_logdensity",
    "multinomial_indices",
    "packed_take",
    "rbpf",
    "redistribute",
    "resample_indices",
    "resample_particles",
    "residual_indices",
    "run_chains_sharded",
    "shard_batch",
    "shard_data",
    "shard_params",
    "sharded_importance",
    "stratified_counts",
    "stratified_indices",
    "systematic_counts",
    "systematic_indices",
    "tensor_parallel_logdensity",
    "tp_bnn_logdensity",
    "warmup_adapt_step_size",
]
