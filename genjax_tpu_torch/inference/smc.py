"""Sequential Monte Carlo: particle collections, importance initialisation,
target changes and conditional SMC.

Counterpart of ``genjax_tpu/inference/smc.py``: ``ParticleCollection``,
``SMCAlgorithm``, ``Importance``, ``ImportanceK`` (``run_csmc`` keeps the
retained particle in the last slot) and ``ChangeTarget``. A collection is
one pytree whose leaves carry the particle axis first; the particles are
one ``torch.func.vmap`` (``keys.vmap_streams``): over split keys, as the
reference's, or over the particle index beside one generator.

The methods that make particles from a seed (``run_smc``, ``run_csmc``,
``log_marginal_likelihood_estimate``, ``estimate_normalizing_constant``,
``estimate_reciprocal_normalizing_constant`` and
``run_csmc_for_normalizing_constant``) take a key (``core/keys.py``), a
``torch.Generator`` or an int seed, and ``device``, the card unless the
caller asks for the CPU, and move the algorithm's target (and a key) there.
As distributions, ``random_weighted`` and ``estimate_logpdf`` run where
their key or generator lives, as the GFI does.

Under a key every method splits it as the reference does, and particle
``i`` draws under the ``i``-th of its ``split(..., K)`` (a
``torch.func.vmap`` over the split keys), so the particles, weights and
estimates are the reference's draw for draw. A generator (an int seed makes
one) is drawn from in sequence where the reference splits a key.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.utils._pytree as pytree

from ..core import keys
from ..core.device import to_device
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


def _valid(gen) -> torch.Tensor:
    return torch.ones((), dtype=torch.bool, device=gen.device)


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
        gen, device = keys.entry_stream(gen, device, f"{type(self).__name__}.{entry}")
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
        return alg._run_smc(keys.split_stream(gen)[1]).get_log_marginal_likelihood_estimate()

    # ----- the GenSP interface: distributions over choice maps -----

    def random_weighted(self, gen: torch.Generator, *args) -> tuple[Score, ChoiceMap]:
        target: Target = args[0]
        run_gen, pick_gen = keys.split_stream(gen)
        collection = ChangeTarget(self, target)._run_smc(run_gen)
        particle = collection.sample_particle(pick_gen)
        log_density_estimate = particle.get_score() - collection.get_log_marginal_likelihood_estimate()
        return log_density_estimate, target.filter_to_unconstrained(particle.get_choices())

    def estimate_logpdf(self, gen: torch.Generator, v: ChoiceMap, *args) -> Score:
        target: Target = args[0]
        run_gen, pick_gen = keys.split_stream(gen)
        collection = ChangeTarget(self, target)._run_csmc(run_gen, v)
        particle = collection.sample_particle(pick_gen)
        return particle.get_score() - collection.get_log_marginal_likelihood_estimate()

    # ----- the VI hooks -----

    def estimate_normalizing_constant(self, gen, target: Target, *, device="cuda") -> Weight:
        alg, gen, device = self._placed(gen, device, "estimate_normalizing_constant")
        collection = ChangeTarget(alg, to_device(target, device))._run_smc(keys.split_stream(gen)[1])
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
        p_gen, q_gen = keys.split_stream(gen)
        if self.q is not None:
            log_weight, choice = self.q.random_weighted(q_gen, self.target)
            tr, target_score = self.target.importance(p_gen, choice)
            return self._collection(tr, target_score - log_weight)
        tr, target_score = self.target.importance(p_gen, ChoiceMap.empty())
        return self._collection(tr, target_score)

    def _run_csmc(self, gen: torch.Generator, retained: ChoiceMap) -> ParticleCollection:
        p_gen, q_gen = keys.split_stream(gen)
        q_score = 0.0 if self.q is None else self.q.estimate_logpdf(q_gen, retained, self.target)
        tr, target_score = self.target.importance(p_gen, retained)
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

    def _importance(self, gen, n: int, choices=None):
        """``n`` particles of the target, each under its own stream
        (``keys.vmap_streams``), constrained by its row of ``choices`` if
        given."""
        if choices is None:
            return keys.vmap_streams(lambda g: self.target.importance(g, ChoiceMap.empty()), gen, n)()
        return keys.vmap_streams(lambda g, chm: self.target.importance(g, chm), gen, n)(choices)

    def _proposals(self, gen, n: int):
        return keys.vmap_streams(lambda g: self.q.random_weighted(g, self.target), gen, n)()

    def _run_smc(self, gen: torch.Generator) -> ParticleCollection:
        # the proposals and the target's own draws under separate keys
        k = self.k_particles
        q_gen, p_gen = keys.split_stream(gen)
        if self.q is not None:
            log_weights, choices = self._proposals(q_gen, k)
            trs, target_scores = self._importance(p_gen, k, choices)
            target_scores = target_scores - log_weights
        else:
            trs, target_scores = self._importance(p_gen, k)
        return ParticleCollection(trs, target_scores, _valid(gen))

    def _run_csmc(self, gen: torch.Generator, retained: ChoiceMap) -> ParticleCollection:
        """K - 1 fresh particles and the retained one in the last slot."""
        k = self.k_particles
        q_gen, est_gen, p_gen = keys.split_stream(gen, 3)
        if self.q is not None:
            log_scores, choices = self._proposals(q_gen, k - 1)
            retained_q_score = self.q.estimate_logpdf(est_gen, retained, self.target)
            trs, target_scores = self._importance(p_gen, k, _tree_append(choices, retained))
            target_scores = target_scores - _tree_append(log_scores, retained_q_score)
        else:
            free_trs, free_scores = self._importance(p_gen, k - 1)
            retained_tr, retained_score = self.target.importance(est_gen, retained)
            trs = _tree_append(free_trs, retained_tr)
            target_scores = _tree_append(free_scores, retained_score)
        return ParticleCollection(trs, target_scores, _valid(gen))


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
        def reweight(g, particle, weight):
            new_trace, new_weight = self.target.importance(g, self._latents(particle))
            return new_trace, new_weight - particle.get_score() + weight

        new_particles, new_weights = keys.vmap_streams(reweight, gen, self.get_num_particles())(
            collection.get_particles(), collection.get_log_weights()
        )
        return ParticleCollection(new_particles, new_weights, _valid(gen))

    def _run_smc(self, gen: torch.Generator) -> ParticleCollection:
        prev_gen, rw_gen = keys.split_stream(gen)
        return self._reweight_collection(rw_gen, self.prev._run_smc(prev_gen))

    def _run_csmc(self, gen: torch.Generator, retained: ChoiceMap) -> ParticleCollection:
        prev_gen, rw_gen = keys.split_stream(gen)
        return self._reweight_collection(rw_gen, self.prev._run_csmc(prev_gen, retained))

    def run_csmc_for_normalizing_constant(self, gen, latent_choices: ChoiceMap, w: Weight, *, device="cuda"):
        """The low-variance estimate of the reciprocal normalising constant
        for VI: the retained particle is not proposed again, its proper
        weight ``w`` is known."""
        alg, gen, device = self._placed(gen, device, "run_csmc_for_normalizing_constant")
        return alg._csmc_for_normalizing_constant(gen, *to_device((latent_choices, w), device))

    def _csmc_for_normalizing_constant(self, gen: torch.Generator, latent_choices: ChoiceMap, w: Weight):
        gen, sub_gen = keys.split_stream(gen)
        collection = self.prev._run_csmc(sub_gen, latent_choices)
        n = self.get_num_particles()

        def reweight(g, particle, weight):
            _, new_score = self.target.importance(g, self._latents(particle))
            return new_score - particle.get_score() + weight

        rejected = keys.vmap_streams(reweight, gen, n - 1)(
            pytree.tree_map(lambda v: v[:-1], collection.get_particles()),
            collection.get_log_weights()[:-1],
        )
        retained_score = collection.get_particle(-1).get_score()
        retained_weight = collection.get_log_weights()[-1]
        w = torch.as_tensor(w, device=retained_score.device)
        all_weights = torch.cat([rejected, (w - retained_score + retained_weight).reshape(1)])
        return retained_score - (torch.logsumexp(all_weights, dim=0) - math.log(n))
