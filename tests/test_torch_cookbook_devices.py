"""The column samplers trace a model's shapes where its chains live.

``examples/26_dense_mass.py`` closes its model over a design on the device;
the port's ``sample_posterior`` (column algorithms) and ``ColumnPacker``
simulated the model once on the CPU to learn its shapes, so on the card such
a model failed (a CPU draw against a card constant) where the reference
traces shapes abstractly. They now simulate on the chains' device (or,
without one, the arguments'). This file imports no JAX: its ``cuda`` cases
run on the card (``python -m pytest tests/test_torch_cookbook_devices.py
-m cuda --noconftest``) and skip here.
"""

import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import sample_posterior
from genjax_tpu_torch.kernels import column_hmc
from genjax_tpu_torch.kernels.model_interface import ColumnPacker
from torch_threads import _one_thread  # noqa: F401

X = np.random.default_rng(0).normal(size=(6, 2)).astype(np.float32)
Y = np.random.default_rng(1).normal(size=6).astype(np.float32)


def _closure_model(device):
    """``w ~ N(0, I); y ~ N(X w, 0.5)`` with ``X`` a closure constant on
    ``device``: the model draws where its generator lives."""
    Xt = torch.from_numpy(X).to(device)

    @g.gen
    def model():
        w = g.mv_normal_diag(torch.zeros(2, device=device), torch.ones(2, device=device)) @ "w"
        _ = g.mv_normal_diag(Xt @ w, torch.full((6,), 0.5, device=device)) @ "y"

    return model


def _draw_devices(model):
    """The devices of the generators ``model`` is simulated with."""
    seen = []
    simulate = model.simulate

    def spy(gen, args):
        seen.append(gen.device)
        return simulate(gen, args)

    object.__setattr__(model, "simulate", spy)
    return seen


def test_the_packer_simulates_on_the_device_it_is_given():
    model = _closure_model(torch.device("cpu"))
    seen = _draw_devices(model)
    packer = ColumnPacker(model, g.C["y"].set(torch.from_numpy(Y)), (), ["w"], device=torch.device("cpu"))
    assert packer.dim == 2 and seen == [torch.device("cpu")]


def test_the_packer_simulates_where_the_arguments_live_by_default():
    @g.gen
    def model(x):
        _ = g.normal(x, 1.0) @ "z"

    seen = _draw_devices(model)
    ColumnPacker(model, None, (torch.tensor(0.5),), ["z"])
    assert seen == [torch.device("cpu")]


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["dense_hmc", "chees"])
def test_a_model_closed_over_a_card_constant_samples_on_the_card(algorithm):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    model = _closure_model(torch.device("cuda"))
    obs = g.C["y"].set(torch.from_numpy(Y).cuda())
    res = sample_posterior(0, model, obs, (), g.S["w"], n_chains=64, n_warmup=8, n_samples=4,
                           algorithm=algorithm, eps0=0.2, L=3, device="cuda")
    assert res["w"].is_cuda and tuple(res["w"].shape) == (64, 4, 2)
    q, accept, packer = column_hmc(model, obs, (), ["w"], n_chains=64, n_steps=4, eps=0.2, L=3, warmup=True,
                                   mass="dense", device="cuda")
    assert q.is_cuda and packer.dim == 2
