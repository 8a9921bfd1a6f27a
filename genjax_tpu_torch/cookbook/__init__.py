"""The cookbooks: the reference's 27 narratives (``examples/NN_*.py``) on
the port, one module each (``exNN_<name>.py``).

Each module has ``main(device=...)`` and runs as a script, on the card by
default::

    python -m genjax_tpu_torch.cookbook.ex10_sample_posterior --device cpu

A cookbook runs at its reference's sizes and makes every assertion its
reference makes, at the same tolerances; where a claim rests on a
documented deviation of the port (``ROADMAP.md``), it states the torch
counterpart of the claim and names the deviation's heading. The modules sit
above every other layer of the package and import none of JAX.

``COOKBOOKS`` lists them in the reference's order. ``23_model_evaluation``
has no counterpart: its claim on the Pareto k-hat does not hold in law
(``ROADMAP.md``, queue 3).
"""

COOKBOOKS = (
    "ex01_intro",
    "ex02_gfi",
    "ex03_choice_maps",
    "ex04_state_space_smc",
    "ex05_mcmc",
    "ex06_vi",
    "ex07_debugging",
    "ex08_dp_mixture",
    "ex09_smcp3",
    "ex10_sample_posterior",
    "ex11_stochastic_probabilities",
    "ex12_expressivity",
    "ex13_checkpoint_resume",
    "ex14_multichip",
    "ex15_map_laplace",
    "ex16_chees",
    "ex17_involutive_rj",
    "ex18_amortized_vi",
    "ex19_discrete_workflow",
    "ex20_big_data",
    "ex21_state_space_workflow",
    "ex22_gp_workflow",
    "ex24_likelihood_free",
    "ex25_island_pf",
    "ex26_dense_mass",
    "ex27_torch_basics",
)
