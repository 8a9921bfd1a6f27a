"""Particle methods on one device: resampling and the state-space particle
filter. The multi-device half of the reference's ``parallel/`` (meshes,
collective resampling, sharded drivers) waits for ``ROADMAP.md`` item 15."""

from .resampling import (
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
from .smc import ParticleFilterResult, SSMParticleFilter

__all__ = [
    "ParticleFilterResult",
    "SSMParticleFilter",
    "effective_sample_size",
    "multinomial_indices",
    "packed_take",
    "redistribute",
    "resample_indices",
    "resample_particles",
    "residual_indices",
    "stratified_counts",
    "stratified_indices",
    "systematic_counts",
    "systematic_indices",
]
