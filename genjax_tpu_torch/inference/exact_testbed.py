"""Exact-inference testbed: discrete HMM inference problems whose posterior
and data marginal are known exactly, for calibrating approximate inference.

Counterpart of ``genjax_tpu/inference/exact_testbed.py``:
``DiscreteHMMInferenceProblem`` and ``build_test_against_exact_inference``,
whose problems start the chain at the fixed grid midpoint, the initial
state the exact forward filter assumes (the reference's corrected
testbed; its source draws the initial state uniformly).

>>> import torch
>>> make, chain, cfg = build_test_against_exact_inference(6, 4, 1, 1, 0.5, 0.5)
>>> p = make(torch.Generator().manual_seed(0))
>>> tuple(p.latent_sequence.shape), bool(p.log_posterior <= 0), int(p.initial_state)
((6,), True, 2)
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core import keys
from ..core.pytree import Pytree
from ..dists.discrete_hmm import DiscreteHMM, DiscreteHMMConfiguration
from ..models.hmm import discrete_hmm_model


@Pytree.dataclass
class DiscreteHMMInferenceProblem(Pytree):
    initial_state: Any
    log_posterior: Any
    log_data_marginal: Any
    latent_sequence: Any
    observation_sequence: Any


def build_test_against_exact_inference(
    max_length: int,
    state_space_size: int,
    transition_distance_truncation: int,
    observation_distance_truncation: int,
    transition_variance: float,
    observation_variance: float,
) -> tuple[Callable[[torch.Generator], DiscreteHMMInferenceProblem], Any, DiscreteHMMConfiguration]:
    """Returns ``(problem_generator, markov_chain_model, config)``: the
    scanned ``@gen`` Markov chain (addresses ``(t, "z")`` latent, ``(t,
    "x")`` observed) and ``problem_generator(gen)``, which simulates one
    problem on the device of ``gen``, a key or a generator; a key is split
    into the path's key and the posterior's, as the reference splits it."""
    config = DiscreteHMMConfiguration(
        state_space_size,
        transition_distance_truncation,
        observation_distance_truncation,
        transition_variance,
        observation_variance,
    )
    markov_chain, _ = discrete_hmm_model(config, max_length)

    def inference_test_generator(gen) -> DiscreteHMMInferenceProblem:
        gen, k_path = keys.split_stream(gen)
        initial_state = torch.tensor(config.linear_grid_dim // 2, device=gen.device)
        tr = markov_chain.simulate(k_path, (initial_state, torch.zeros(max_length, device=gen.device)))
        chm = tr.get_choices()
        latent_sequence, observation_sequence = chm[:, "z"], chm[:, "x"]
        return DiscreteHMMInferenceProblem(
            initial_state,
            DiscreteHMM.estimate_logpdf(gen, latent_sequence, config, observation_sequence),
            DiscreteHMM.data_logpdf(config, observation_sequence),
            latent_sequence,
            observation_sequence,
        )

    return inference_test_generator, markov_chain, config
