"""Sequential Monte Carlo: particle collections, importance initialisation,
target changes and conditional SMC.

Counterpart of ``genjax_tpu/inference/smc.py``: ``ParticleCollection``,
``SMCAlgorithm``, ``Importance``, ``ImportanceK`` (``run_csmc`` keeps the
retained particle in the last slot) and ``ChangeTarget``. A collection is
one pytree whose leaves carry the particle axis first; the particles are
one ``torch.func.vmap(..., randomness="different")`` over the particle
index, where the reference vmaps over split keys.

The methods that make particles from a seed (``run_smc``, ``run_csmc``,
``log_marginal_likelihood_estimate``, ``estimate_normalizing_constant``,
``estimate_reciprocal_normalizing_constant`` and
``run_csmc_for_normalizing_constant``) take a ``torch.Generator`` or an int
seed and ``device``, the card unless the caller asks for the CPU, and move
the algorithm's target there. As distributions, ``random_weighted`` and
``estimate_logpdf`` run where their generator lives, as the GFI does. One
generator is drawn from in sequence where the reference splits a key.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.utils._pytree as pytree

from ..core.device import entry_generator, to_device
from ..core.pytree import Pytree
from ..dists.catalog import categorical
from ..generative.choice_map import ChoiceMap
from ..generative.concepts import Score, Weight
from ..generative.trace import Trace
from ..parallel.resampling import effective_sample_size
from .sp import Algorithm, SampleDistribution, Target


def _tree_append(batched, single):
    """Append an unbatched pytree as the last entry of a batched pytree."""
    return pytree.tree_map(
        lambda b, s: torch.cat([b, torch.as_tensor(s, device=b.device).to(b.dtype)[None]], dim=0),
        batched,
        single,
    )


def _lanes(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.zeros(n, device=gen.device)


def _vmap(fn):
    return torch.func.vmap(fn, randomness="different")


@Pytree.dataclass
class ParticleCollection(Pytree):
    """Weighted particles: a batched trace (the particle axis leading every
    leaf), log importance weights and a validity flag."""

    particles: Trace
    log_weights: Any
    is_valid: Any

    def get_particles(self) -> Trace:
        return self.particles

    def get_particle(self, idx) -> Trace:
        return pytree.tree_map(lambda v: v[idx], self.particles)

    def get_log_weights(self):
        return self.log_weights

    def get_log_marginal_likelihood_estimate(self):
        return torch.logsumexp(self.log_weights, dim=0) - math.log(self.log_weights.shape[0])

    def effective_sample_size(self):
        """ESS = (sum w)^2 / sum w^2."""
        return effective_sample_size(self.log_weights)

    def __getitem__(self, idx):
        return pytree.tree_map(lambda v: v[idx], (self.particles, self.log_weights))

    def sample_particle(self, gen: torch.Generator) -> Trace:
        """One particle, drawn in proportion to its weight."""
        return self.get_particle(categorical.sample(gen, self.log_weights))


class SMCAlgorithm(Algorithm):
    """Base of the SMC algorithms. A subclass gives ``_run_smc(gen)`` and
    ``_run_csmc(gen, retained)`` on a generator; the public methods place
    the run."""

    def get_num_particles(self) -> int:
        raise NotImplementedError

    def get_final_target(self) -> Target:
        raise NotImplementedError

    def _run_smc(self, gen: torch.Generator) -> ParticleCollection:
        raise NotImplementedError

    def _run_csmc(self, gen: torch.Generator, retained: ChoiceMap) -> ParticleCollection:
        raise NotImplementedError

    def _placed(self, gen, device, entry: str):
        gen, device = entry_generator(gen, device, f"{type(self).__name__}.{entry}")
        return to_device(self, device), gen, device

    def run_smc(self, gen, *, device="cuda") -> ParticleCollection:
        alg, gen, _ = self._placed(gen, device, "run_smc")
        return alg._run_smc(gen)

    def run_csmc(self, gen, retained: ChoiceMap, *, device="cuda") -> ParticleCollection:
        alg, gen, device = self._placed(gen, device, "run_csmc")
        return alg._run_csmc(gen, to_device(retained, device))

    def log_marginal_likelihood_estimate(self, gen, target: Target | None = None, *, device="cuda"):
        alg, gen, device = self._placed(gen, device, "log_marginal_likelihood_estimate")
        if target is not None:
            alg = ChangeTarget(alg, to_device(target, device))
        return alg._run_smc(gen).get_log_marginal_likelihood_estimate()

    # ----- the GenSP interface: distributions over choice maps -----

    def random_weighted(self, gen: torch.Generator, *args) -> tuple[Score, ChoiceMap]:
        target: Target = args[0]
        collection = ChangeTarget(self, target)._run_smc(gen)
        particle = collection.sample_particle(gen)
        log_density_estimate = particle.get_score() - collection.get_log_marginal_likelihood_estimate()
        return log_density_estimate, target.filter_to_unconstrained(particle.get_choices())

    def estimate_logpdf(self, gen: torch.Generator, v: ChoiceMap, *args) -> Score:
        target: Target = args[0]
        collection = ChangeTarget(self, target)._run_csmc(gen, v)
        particle = collection.sample_particle(gen)
        return particle.get_score() - collection.get_log_marginal_likelihood_estimate()

    # ----- the VI hooks -----

    def estimate_normalizing_constant(self, gen, target: Target, *, device="cuda") -> Weight:
        alg, gen, device = self._placed(gen, device, "estimate_normalizing_constant")
        collection = ChangeTarget(alg, to_device(target, device))._run_smc(gen)
        return collection.get_log_marginal_likelihood_estimate()

    def estimate_reciprocal_normalizing_constant(
        self, gen, target: Target, latent_choices: ChoiceMap, w: Weight, *, device="cuda"
    ) -> Weight:
        alg, gen, device = self._placed(gen, device, "estimate_reciprocal_normalizing_constant")
        target, latent_choices, w = to_device((target, latent_choices, w), device)
        return ChangeTarget(alg, target)._csmc_for_normalizing_constant(gen, latent_choices, w)


@Pytree.dataclass
class Importance(SMCAlgorithm):
    """One-particle importance sampling from ``target``, through the
    proposal ``q`` if one is given."""

    target: Target
    q: SampleDistribution | None = None

    def get_num_particles(self) -> int:
        return 1

    def get_final_target(self) -> Target:
        return self.target

    def _collection(self, tr, weight) -> ParticleCollection:
        return ParticleCollection(
            pytree.tree_map(lambda v: v.unsqueeze(0), tr),
            torch.atleast_1d(weight),
            torch.ones((), dtype=torch.bool, device=weight.device),
        )

    def _run_smc(self, gen: torch.Generator) -> ParticleCollection:
        if self.q is not None:
            log_weight, choice = self.q.random_weighted(gen, self.target)
            tr, target_score = self.target.importance(gen, choice)
            return self._collection(tr, target_score - log_weight)
        tr, target_score = self.target.importance(gen, ChoiceMap.empty())
        return self._collection(tr, target_score)

    def _run_csmc(self, gen: torch.Generator, retained: ChoiceMap) -> ParticleCollection:
        q_score = 0.0 if self.q is None else self.q.estimate_logpdf(gen, retained, self.target)
        tr, target_score = self.target.importance(gen, retained)
        return self._collection(tr, target_score - q_score)


@Pytree.dataclass
class ImportanceK(SMCAlgorithm):
    """K-particle importance sampling, the particles one vmapped batch.

    >>> import genjax_tpu_torch as g
    >>> from genjax_tpu_torch.inference import ImportanceK, Target
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 0.5) @ "y"
    >>> target = Target(model, (), g.C["y"].set(1.0))
    >>> alg = ImportanceK(target, k_particles=500)
    >>> collection = alg.run_smc(0, device="cpu")
    >>> tuple(collection.get_log_weights().shape)
    (500,)
    """

    target: Target
    q: SampleDistribution | None = None
    k_particles: int = Pytree.static(default=2)

    def get_num_particles(self) -> int:
        return self.k_particles

    def get_final_target(self) -> Target:
        return self.target

    def _importance(self, gen):
        return _vmap(lambda chm: self.target.importance(gen, chm))

    def _proposals(self, gen, n: int):
        return _vmap(lambda _: self.q.random_weighted(gen, self.target))(_lanes(gen, n))

    def _run_smc(self, gen: torch.Generator) -> ParticleCollection:
        k = self.k_particles
        if self.q is not None:
            log_weights, choices = self._proposals(gen, k)
            trs, target_scores = self._importance(gen)(choices)
            target_scores = target_scores - log_weights
        else:
            trs, target_scores = _vmap(lambda _: self.target.importance(gen, ChoiceMap.empty()))(
                _lanes(gen, k)
            )
        return ParticleCollection(trs, target_scores, torch.ones((), dtype=torch.bool, device=gen.device))

    def _run_csmc(self, gen: torch.Generator, retained: ChoiceMap) -> ParticleCollection:
        """K - 1 fresh particles and the retained one in the last slot."""
        k = self.k_particles
        if self.q is not None:
            log_scores, choices = self._proposals(gen, k - 1)
            retained_q_score = self.q.estimate_logpdf(gen, retained, self.target)
            trs, target_scores = self._importance(gen)(_tree_append(choices, retained))
            target_scores = target_scores - _tree_append(log_scores, retained_q_score)
        else:
            free_trs, free_scores = _vmap(lambda _: self.target.importance(gen, ChoiceMap.empty()))(
                _lanes(gen, k - 1)
            )
            retained_tr, retained_score = self.target.importance(gen, retained)
            trs = _tree_append(free_trs, retained_tr)
            target_scores = _tree_append(free_scores, retained_score)
        return ParticleCollection(trs, target_scores, torch.ones((), dtype=torch.bool, device=gen.device))


@Pytree.dataclass
class ChangeTarget(SMCAlgorithm):
    """Reweight the particles of ``prev`` to a new ``target``.

    Contract (the reference's): ``target`` constrains the same addresses as
    ``prev``'s final target (the same observations at other values or
    arguments). The reweight divides by each particle's whole previous
    score, which is the right proposal density only when the two targets'
    unconstrained spaces coincide.
    """

    prev: SMCAlgorithm
    target: Target

    def get_num_particles(self) -> int:
        return self.prev.get_num_particles()

    def get_final_target(self) -> Target:
        return self.target

    def _latents(self, particle: Trace) -> ChoiceMap:
        return self.prev.get_final_target().filter_to_unconstrained(particle.get_choices())

    def _reweight_collection(self, gen: torch.Generator, collection: ParticleCollection) -> ParticleCollection:
        def reweight(particle, weight):
            new_trace, new_weight = self.target.importance(gen, self._latents(particle))
            return new_trace, new_weight - particle.get_score() + weight

        new_particles, new_weights = _vmap(reweight)(collection.get_particles(), collection.get_log_weights())
        return ParticleCollection(new_particles, new_weights, torch.ones((), dtype=torch.bool, device=gen.device))

    def _run_smc(self, gen: torch.Generator) -> ParticleCollection:
        return self._reweight_collection(gen, self.prev._run_smc(gen))

    def _run_csmc(self, gen: torch.Generator, retained: ChoiceMap) -> ParticleCollection:
        return self._reweight_collection(gen, self.prev._run_csmc(gen, retained))

    def run_csmc_for_normalizing_constant(self, gen, latent_choices: ChoiceMap, w: Weight, *, device="cuda"):
        """The low-variance estimate of the reciprocal normalising constant
        for VI: the retained particle is not proposed again, its proper
        weight ``w`` is known."""
        alg, gen, device = self._placed(gen, device, "run_csmc_for_normalizing_constant")
        return alg._csmc_for_normalizing_constant(gen, *to_device((latent_choices, w), device))

    def _csmc_for_normalizing_constant(self, gen: torch.Generator, latent_choices: ChoiceMap, w: Weight):
        collection = self.prev._run_csmc(gen, latent_choices)
        n = self.get_num_particles()

        def reweight(particle, weight):
            _, new_score = self.target.importance(gen, self._latents(particle))
            return new_score - particle.get_score() + weight

        rejected = _vmap(reweight)(
            pytree.tree_map(lambda v: v[:-1], collection.get_particles()),
            collection.get_log_weights()[:-1],
        )
        retained_score = collection.get_particle(-1).get_score()
        retained_weight = collection.get_log_weights()[-1]
        w = torch.as_tensor(w, device=retained_score.device)
        all_weights = torch.cat([rejected, (w - retained_score + retained_weight).reshape(1)])
        return retained_score - (torch.logsumexp(all_weights, dim=0) - math.log(n))
