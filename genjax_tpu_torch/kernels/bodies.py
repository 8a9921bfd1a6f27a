"""Column log-densities with a hand-written device body in the CUDA sweeps.

CUDA has no autodiff, so the sweep kernels (``csrc/hmc_sweep.cu``,
``csrc/nuts_sweep.cu``) take the density and its gradient as a device body
chosen by id (``csrc/column_common.cuh``). This module is the registry of
those bodies, in place of the reference's jaxpr staging and primitive
whitelist (``genjax_tpu/kernels/hmc.py:166-228,314-335``). Each ``Body``
carries its constants and the plain torch formula of its log-density and
gradient, which is the kernel body's plain version. ``body_for`` recognises
a model's column log-density from the family and constants the model
declares as plain data.

Where the constants live in a kernel depends on the body's variant
(``variant``): at a specialised shape (``SPECIALISED_SHAPES``, the
flagship's ``(n_obs, d_w) = (16, 8)``) the kernel is compiled with the
shape fixed and takes ``X`` and ``y`` by value as a kernel parameter, read
as constant-bank operands; at any other shape (the ``generic`` variant,
runtime loop bounds) the kernel copies them into shared memory.

A ``Body`` is itself a column log-density ``(D, N) -> (N,)`` whose ``body``
attribute is itself, so it can be handed to ``pallas_hmc`` directly.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..generative.choice_map import StaticChm, ValueChm
from ..generative.mask import Mask

_LOG_2PI = math.log(2.0 * math.pi)

IID_NORMAL = 0
HIER_REGRESSION = 1

# hier_regression's (n_obs, d_w) compiled as their own kernel variant
SPECIALISED_SHAPES = ((16, 8),)


@dataclasses.dataclass(frozen=True, eq=False)
class Body:
    """A device body of the sweep kernel: its id, its constants (flat
    float32: ``X`` row-major, then ``y``) and their sizes."""

    kind: int
    consts: torch.Tensor = dataclasses.field(repr=False)
    n_obs: int = 0
    d_w: int = 0
    obs_scale: float = 0.0
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def body(self) -> "Body":
        return self

    @property
    def name(self) -> str:
        return ("iid_normal", "hier_regression")[self.kind]

    def min_dim(self) -> int:
        return 1 + self.d_w if self.kind == HIER_REGRESSION else 1

    def variant(self, d: int) -> str:
        """The kernel variant this body takes at packed dimension ``d``:
        ``"specialised"`` (no shape, or a shape in ``SPECIALISED_SHAPES`` that
        fits ``d``) or ``"generic"`` (runtime shape)."""
        if self.kind == HIER_REGRESSION and (
            (self.n_obs, self.d_w) not in SPECIALISED_SHAPES or d != 16
        ):
            return "generic"
        return "specialised"

    def shared_consts_floats(self, d: int) -> int:
        """Floats of the constants a kernel copies into shared memory at
        packed dimension ``d`` (``shared_consts_floats`` of
        ``csrc/column_common.cuh``): ``X`` and ``y`` rounded up to a float4
        in the generic variant, none otherwise."""
        if self.kind != HIER_REGRESSION or self.variant(d) != "generic":
            return 0
        return (self.n_obs * (self.d_w + 1) + 3) // 4 * 4

    def consts_on(self, device: torch.device) -> torch.Tensor:
        """The constants on ``device``, copied there once."""
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = self.consts.to(device).contiguous()
        return self._on_device[key]

    def lp_grad(self, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The plain torch formula: ``(lp (N,), grad (D, N))`` at ``q (D, N)``,
        the same arithmetic as the device body."""
        if self.kind == IID_NORMAL:
            return -0.5 * torch.sum(q * q, dim=0), -q
        return _hier_lp_grad(q, self.consts_on(q.device), self.n_obs, self.d_w, self.obs_scale)

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        return self.lp_grad(q)[0]


def iid_normal() -> Body:
    """``lp(q) = -1/2 sum_d q_d^2`` for every packed dimension."""
    return Body(IID_NORMAL, torch.zeros(0))


def hier_regression(X, y, obs_scale: float) -> Body:
    """The flagship ``hierarchical_regression`` packed over ``["tau", "w"]``
    with ``y`` constrained: ``q[0] = tau``, ``q[1:1 + d] = w``, standard-normal
    padding after them."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    n_obs, d_w = X.shape
    if y.shape != (n_obs,):
        raise ValueError(f"y has shape {y.shape}; X has {n_obs} rows")
    consts = torch.from_numpy(np.concatenate([X.reshape(-1), y]))
    return Body(HIER_REGRESSION, consts, n_obs, d_w, float(obs_scale))


def _path(addr) -> tuple:
    return addr if isinstance(addr, tuple) else (addr,)


def body_packing(model) -> tuple | None:
    """The address paths, in the body's row order, that ``model``'s family
    packs for its device body, or None for a model with none."""
    if getattr(model, "column_family", None) == "hierarchical_regression":
        return (("tau",), ("w",))
    return None


def body_for(model, constraint, args, addresses) -> Body | None:
    """The device body of ``model``'s column log-density under this packing,
    or None. A model names its family and constants as plain data
    (``column_family``, ``X``, ``obs_scale``; see
    ``models/regression.py``); only the packings below have a body."""
    packing = body_packing(model)
    if packing is None or tuple(_path(a) for a in addresses) != packing or args != ():
        return None
    if not isinstance(constraint, StaticChm) or constraint.keys != ("y",):
        return None
    y = constraint.get_submap("y")
    n_obs = np.shape(model.X)[0]
    if not isinstance(y, ValueChm) or isinstance(y.v, Mask) or tuple(np.shape(y.v)) != (n_obs,):
        return None
    y_host = y.v.detach().cpu() if isinstance(y.v, torch.Tensor) else y.v
    return hier_regression(model.X, y_host, model.obs_scale)


def _hier_lp_grad(q, consts, n_obs, d_w, obs_scale):
    X = consts[: n_obs * d_w].reshape(n_obs, d_w)
    y = consts[n_obs * d_w :]
    tau, w, pad = q[0], q[1 : 1 + d_w], q[1 + d_w :]
    # log-normal prior on tau: -inf off its support; the gradient keeps
    # log(tau), so it is NaN there, as autograd through the model gives
    lt = torch.log(tau)
    lp = torch.where(tau > 0.0, -(_LOG_2PI + math.log(0.25) + 4.0 * lt * lt) * 0.5 - lt, -torch.inf)
    g_tau = -(4.0 * lt + 1.0) / tau
    tau2 = tau * tau
    sum_w2 = torch.sum(w * w, dim=0)
    lp = lp - 0.5 * (d_w * torch.log((2.0 * math.pi) * tau2) + sum_w2 / tau2)
    g_tau = g_tau + sum_w2 / tau2 / tau - d_w / tau
    inv_s2 = 1.0 / (obs_scale * obs_scale)
    r = y[:, None] - X @ w
    lp = lp - 0.5 * (n_obs * math.log(2.0 * math.pi * obs_scale * obs_scale) + torch.sum(r * r, dim=0) * inv_s2)
    g_w = -w / tau2 + (X.T @ r) * inv_s2
    lp = lp - 0.5 * torch.sum(pad * pad, dim=0)
    return lp, torch.cat([g_tau[None], g_w, -pad], dim=0)
