"""NUTS: one chain's fixed-budget transition, and the column twin of the
NUTS sweep kernel (K4).

Counterpart of ``genjax_tpu/kernels/nuts.py`` (``nuts_transition``,
``nuts_transition_cols``, ``nuts_sweep_cols``). ``nuts_transition`` moves
one chain ``(D,)`` over a fixed budget of ``2**max_depth - 1`` leaves, for
``torch.func.vmap`` over chains (the trace path's ``NUTS`` request). The
column functions move ``(D, N)`` float32 positions, chains on the last axis.
The sampler is the iterative No-U-Turn scheme of the reference:

- multinomial progressive sampling within a subtree, biased progressive
  sampling across doublings;
- U-turn checks inside a subtree through a checkpoint stack: leaf ``i`` is
  pushed at slot ``popcount(i)`` and checked against slots
  ``popcount(i) - 1 - j`` for ``j < ntz(i + 1)``;
- divergence when the energy rises by more than ``divergence_threshold``.

In the column functions the batch of chains is explicit, never vmapped: the
leaf and doubling loops are Python loops over the whole batch with
collective exits (one host read of a flag per leaf and per doubling), and
per-chain freezing is the ``active`` mask.

Three random streams (``NUTSDraws``):

- ``"generator"``: a ``torch.Generator``; the ordinary twin, held in law
  against the reference's ``nuts_sweep_cols``;
- ``"rbg"``: the draws of the reference's ``nuts_sweep_cols`` from
  ``jax.random.key(seed, impl="rbg")`` (``core/keys.py``), draw for draw:
  transition ``t`` splits the ``t``-th step key into ``kr, kd, ku``, draws
  the momentum ``normal(kr, (D, N))``, doubling ``j``'s directions
  ``bernoulli(fold_in(kd, j), (N,))`` (True is forward), leaf ``i``'s
  uniforms from ``fold_in(fold_in(ku, j), i)`` and the subtree's from
  ``fold_in(fold_in(ku, j), 1 << 30)``. A chain's draws depend on nothing but
  its index, so the collective exits change none of them;
- ``"counter"``: the reference kernel's interpret-mode stream
  (``genjax_tpu/kernels/nuts_pallas.py::_nuts_kernel``) for chain block
  ``block_n``. There the loops exit per chain block, and a block's salt
  advances only while the block runs, so the salts a chain sees depend on
  every chain of its block. A block whose loop has exited has no active
  chain, so running it on with the others changes nothing but its salt; the
  twin therefore keeps the collective loops and advances a salt per block
  only while that block's own exit condition holds. With it the twin, the
  CUDA kernel and the Pallas kernel under ``interpret=True`` agree draw for
  draw.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core import keys
from .hmc import (_counter_stream, _inv_mass_col, _lp_grad, _mom_std, _normal, _uniform_01, rbg_rows_normal,
                  rbg_step_keys)
from .rows import Rows


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor
    num_leapfrogs: torch.Tensor
    diverged: torch.Tensor
    depth: torch.Tensor


def rbg_keys_stride(max_depth: int) -> int:
    """Keys a transition on the rbg stream: ``kr``, a direction and a
    subtree key a doubling, and ``2**max_depth - 1`` leaf keys."""
    return 2 * max_depth + (1 << max_depth)


def rbg_keys_of(step_keys: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Every key the transitions of ``step_keys (T, w)`` draw from to
    ``max_depth``, as the reference's ``nuts_transition_cols`` derives them:
    ``(T, rbg_keys_stride(max_depth), w)``. Transition ``t`` splits its step
    key into ``kr, kd, ku``; its row holds ``kr``, then ``fold_in(kd, j)``
    for ``j < max_depth``, then ``fold_in(fold_in(ku, j), 1 << 30)``, then
    the leaf keys ``fold_in(fold_in(ku, j), i)`` for ``i < 2**j``, doubling
    ``j``'s at ``2 max_depth + 2**j + i``. K4's rbg kernel reads the same
    table (``nuts_pallas.rbg_keys_table``)."""
    kr, kd, ku = keys.split(step_keys, 3).unbind(-2)
    device = step_keys.device
    j = torch.arange(max_depth, device=device)
    ku_j = keys.fold_in(ku[:, None, :], j)
    leaf_j = torch.tensor([m.bit_length() - 1 for m in range(1, 1 << max_depth)], dtype=torch.int64,
                          device=device)
    leaf_i = torch.arange(1, 1 << max_depth, device=device) - (1 << leaf_j)
    return torch.cat([kr[:, None, :], keys.fold_in(kd[:, None, :], j), keys.fold_in(ku_j, 1 << 30),
                      keys.fold_in(ku_j[:, leaf_j], leaf_i)], dim=1)


class NUTSDraws:
    """The random draws of a NUTS sweep over ``n`` chains.

    ``rng="generator"`` draws from ``seed_or_generator`` (a
    ``torch.Generator``, or an int that seeds one on ``device``); the chains
    form one block. ``rng="counter"`` is the reference kernel's counter
    stream: chain ``k`` is column ``k % block_n`` of block ``k // block_n``,
    and each block carries its own salt, starting at 1. ``rng="rbg"`` is the
    reference twin's keyed stream from the int seed, ``n_steps`` transitions
    of it to ``max_depth`` (``step_keys`` given instead: a transition a key,
    of either implementation), every key a sweep draws from made at once
    (``rbg_keys_of``, the table K4 reads), the momentum's rows mapped by
    ``stream_rows`` (``hmc.rbg_rows_normal``). Each transition calls
    ``start`` first.
    """

    def __init__(self, rng: str, seed_or_generator, n: int, block_n: int | None, device, *,
                 n_steps: int = 0, max_depth: int = 0, step_keys: torch.Tensor | None = None, stream_rows=None):
        self.rng, self.n = rng, n
        if stream_rows is not None and rng != "rbg":
            raise ValueError("stream_rows maps the rbg stream's rows: pass rng='rbg'")
        if rng == "rbg":
            self.n_blocks, self.stream_rows, self.t, self.max_depth = 1, stream_rows, 0, max_depth
            if step_keys is None:
                step_keys = rbg_step_keys(seed_or_generator, n_steps, device)
            self.table = rbg_keys_of(step_keys, max_depth)
        elif rng == "counter":
            if block_n is None:
                raise ValueError("the counter stream needs its chain block: pass block_n")
            if block_n <= 0 or n % block_n:
                raise ValueError(f"n_chains={n} is not a multiple of the chain block {block_n}")
            self.n_blocks = n // block_n
            self.bits = _counter_stream(int(seed_or_generator), n, block_n, device)
            self.block = torch.arange(n, device=device) // block_n
            self.salts = torch.ones(self.n_blocks, dtype=torch.int64, device=device)
        elif rng == "generator":
            self.n_blocks = 1
            gen = seed_or_generator
            if not isinstance(gen, torch.Generator):
                gen = torch.Generator(device=device).manual_seed(int(gen))
            self.gen, self.device = gen, device
        else:
            raise ValueError(f"rng must be 'generator', 'counter' or 'rbg', got {rng!r}")

    def start(self) -> None:
        """Begin a transition: on the rbg stream, take its row of keys."""
        if self.rng == "rbg":
            self.row = self.table[self.t]
            self.t += 1

    def blocks_any(self, flags: torch.Tensor) -> torch.Tensor:
        """``(n,)`` bool -> ``(n_blocks,)``: whether any chain of a block is set."""
        return flags.view(self.n_blocks, -1).any(dim=1)

    def advance(self, running: torch.Tensor | None = None) -> None:
        """Move the salt of every block, or of the ``running`` ones, by 4."""
        if self.rng == "counter":
            self.salts += 4 if running is None else 4 * running.to(torch.int64)

    def uniform(self) -> torch.Tensor:
        if self.rng == "counter":
            return _uniform_01(self.bits, (self.n,), self.salts[self.block])
        return torch.rand(self.n, generator=self.gen, device=self.device)

    def normal(self, d: int) -> torch.Tensor:
        if self.rng == "rbg":
            return rbg_rows_normal(self.row[0], d, self.n, self.stream_rows)
        if self.rng == "counter":
            return _normal(self.bits, (d, self.n), self.salts[self.block])
        return torch.randn((d, self.n), generator=self.gen, device=self.device)

    def direction(self, j: int) -> torch.Tensor:
        """Doubling ``j``'s direction, +1 or -1 a chain: the reference's
        ``bernoulli`` on the rbg stream (True forward); a uniform under 0.5
        is backward on the others, as the reference's kernel has it."""
        if self.rng == "rbg":
            return torch.where(keys.bernoulli(self.row[1 + j], 0.5, (self.n,)), 1.0, -1.0)
        return torch.where(self.uniform() < 0.5, -1.0, 1.0)

    def leaf(self, j: int, i: int) -> torch.Tensor:
        """The uniform that takes leaf ``i`` of doubling ``j``."""
        if self.rng == "rbg":
            return keys.uniform(self.row[2 * self.max_depth + (1 << j) + i], (self.n,))
        return self.uniform()

    def subtree(self, j: int) -> torch.Tensor:
        """The uniform that takes doubling ``j``'s subtree."""
        if self.rng == "rbg":
            return keys.uniform(self.row[1 + self.max_depth + j], (self.n,))
        return self.uniform()


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's ``logaddexp``: ``max + log1p(exp(-|a - b|))``, and
    ``a + b`` where ``a - b`` is NaN (so ``(-inf, -inf)`` gives ``-inf``)."""
    delta = a - b
    out = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(delta)))
    return torch.where(torch.isnan(delta), a + b, out)


def _uturn(dz, inv_mass, r_a, r_b, rows: Rows | None = None) -> torch.Tensor:
    """``dz . M^-1 r_a < 0`` or ``dz . M^-1 r_b < 0``, per chain (over the
    leading axis: a column block, or one chain's ``(D,)`` vectors); with
    ``rows``, both dot products over every row of the chain in one
    reduction."""
    if rows is None:
        return (torch.sum(dz * inv_mass * r_a, dim=0) < 0.0) | (
            torch.sum(dz * inv_mass * r_b, dim=0) < 0.0
        )
    a, b = rows.sums(dz * inv_mass * r_a, dz * inv_mass * r_b)
    return (a < 0.0) | (b < 0.0)


def nuts_transition(
    logdensity: Callable,
    z0: torch.Tensor,
    gen: torch.Generator,
    eps,
    max_depth: int = 8,
    divergence_threshold: float = 1000.0,
    inv_mass=None,
):
    """One NUTS transition of a single chain, for ``torch.func.vmap`` over
    chains (``randomness="different"``).

    ``logdensity`` maps ``z (D,)`` to a scalar; each leaf costs one
    ``torch.func.grad_and_value``, and the gradients at the trajectory's two
    ends are carried, not recomputed. The budget is fixed, as in the
    reference: doubling ``j`` integrates all ``2**j`` leaves of its subtree
    whatever the chain's state, so every loop bound, checkpoint slot
    (``popcount(i)``) and U-turn check count (``ntz(i + 1)``) is a function
    of the loop indices alone, and chains that turned, diverged or finished
    are frozen by ``torch.where`` masks; nothing reads a tensor's value, so
    the transition is safe under vmap. It costs ``2**max_depth - 1``
    gradients a transition. Draws from ``gen``, in order: the momentum, then
    for each doubling its direction, one uniform a leaf and the subtree's
    acceptance uniform. Under a PRNG key (``core/keys.py``) it draws what
    the reference's ``nuts_transition`` draws: ``kr, kd, ku = split(key,
    3)``, the momentum ``normal(kr, (D,))``, doubling ``j``'s direction
    ``bernoulli(fold_in(kd, j))`` (True forward), leaf ``i``'s uniform from
    ``fold_in(fold_in(ku, j), i)`` and the subtree's from ``fold_in(fold_in(ku,
    j), 1 << 30)``. ``inv_mass`` is a diagonal inverse mass ``(D,)`` or
    ``(D, 1)``.

    Returns ``(z_new, NUTSInfo)`` with 0-dim info fields.
    """
    d = z0.shape[0]
    device = z0.device
    if inv_mass is None:
        inv_mass = torch.ones(d, dtype=torch.float32, device=device)
    else:
        inv_mass = torch.as_tensor(inv_mass, dtype=torch.float32, device=device).reshape(d)
    grad_and_value = torch.func.grad_and_value(logdensity)

    def kinetic(r):
        return 0.5 * torch.sum(inv_mass * r * r)

    if keys.is_key(gen):
        kr, kd, ku = keys.split(gen, 3).unbind(-2)
        r0 = (1.0 / torch.sqrt(inv_mass)) * keys.normal(kr, (d,))

        def forward(j):
            return keys.bernoulli(keys.fold_in(kd, j))

        def leaf_u(j, i):
            return keys.uniform(keys.fold_in(keys.fold_in(ku, j), i))

        def subtree_u(j):
            return keys.uniform(keys.fold_in(keys.fold_in(ku, j), 1 << 30))
    else:
        r0 = torch.randn(d, generator=gen, device=device) / torch.sqrt(inv_mass)

        def forward(_j):
            return torch.rand((), generator=gen, device=device) < 0.5

        def leaf_u(_j, _i):
            return torch.rand((), generator=gen, device=device)

        def subtree_u(_j):
            return torch.rand((), generator=gen, device=device)

    g0, ld0 = grad_and_value(z0)
    energy0 = -ld0 + kinetic(r0)

    false = torch.zeros((), dtype=torch.bool, device=device)
    z_m, r_m, g_m = z0, r0, g0
    z_p, r_p, g_p = z0, r0, g0
    z_prop, lw_traj = z0, -energy0
    done, t_turn, t_div = false, false, false
    n_leap = torch.zeros((), dtype=torch.int32, device=device)
    depth = torch.zeros((), dtype=torch.int32, device=device)
    t_sacc = torch.zeros((), dtype=torch.float32, device=device)
    t_scnt = torch.zeros((), dtype=torch.float32, device=device)

    for j in range(max_depth):
        direction = torch.where(forward(j), 1.0, -1.0)
        fwd = direction > 0
        e = eps * direction
        # the subtree of 2**j leaves off the moving end, with its checkpoint
        # stack: leaf i is pushed at slot popcount(i), a Python index
        z = torch.where(fwd, z_p, z_m)
        r = torch.where(fwd, r_p, r_m)
        g = torch.where(fwd, g_p, g_m)
        ck_z, ck_r = [z] * (j + 1), [r] * (j + 1)
        s_zprop = z
        lw_sub = torch.full((), -torch.inf, device=device)
        s_turn, s_div, s_sacc, s_scnt = false, false, t_sacc, t_scnt
        for i in range(1 << j):
            active = ~(s_turn | s_div)
            r_half = r + 0.5 * e * g
            z_new = z + e * inv_mass * r_half
            g_new, ld_new = grad_and_value(z_new)
            r_new = r_half + 0.5 * e * g_new

            bc = bin(i).count("1")
            ck_z[bc], ck_r[bc] = z_new, r_new

            energy = -ld_new + kinetic(r_new)
            # an overflowed or NaN state is a divergence, not a NaN weight
            energy = torch.where(torch.isnan(energy), torch.inf, energy)
            lw_leaf = -energy
            div_new = active & (energy - energy0 > divergence_threshold)
            lw_new = torch.where(active, _logaddexp(lw_sub, lw_leaf), lw_sub)
            take = active & (leaf_u(j, i) < torch.exp(lw_leaf - lw_new))
            s_zprop = torch.where(take, z_new, s_zprop)

            acc = torch.clamp(torch.exp(energy0 - energy), max=1.0)
            s_sacc = s_sacc + torch.where(active, acc, 0.0)
            s_scnt = s_scnt + active.to(torch.float32)

            # the openers of every subtree closing at leaf i are the top
            # ntz(i + 1) stack entries
            ntz1 = ((i + 1) & -(i + 1)).bit_length() - 1
            for j_off in range(ntz1):
                slot = bc - 1 - j_off
                dz = direction * (z_new - ck_z[slot])
                s_turn = s_turn | (active & _uturn(dz, inv_mass, ck_r[slot], r_new))

            z = torch.where(active, z_new, z)
            r = torch.where(active, r_new, r)
            g = torch.where(active, g_new, g)
            lw_sub = lw_new
            s_div = s_div | div_new

        # biased progressive sampling across the doubling
        sub_ok = ~(s_turn | s_div)
        live = ~done
        p_acc = torch.clamp(torch.exp(lw_sub - lw_traj), max=1.0)
        take = live & sub_ok & (subtree_u(j) < p_acc)
        z_prop = torch.where(take, s_zprop, z_prop)
        grow = live & sub_ok
        lw_traj = torch.where(grow, _logaddexp(lw_traj, lw_sub), lw_traj)
        upd_f, upd_b = grow & fwd, grow & ~fwd
        z_p, r_p, g_p = (torch.where(upd_f, s, t) for s, t in ((z, z_p), (r, r_p), (g, g_p)))
        z_m, r_m, g_m = (torch.where(upd_b, s, t) for s, t in ((z, z_m), (r, r_m), (g, g_m)))

        global_turn = _uturn(z_p - z_m, inv_mass, r_m, r_p)
        n_leap = n_leap + torch.where(done, 0, 1 << j).to(torch.int32)
        depth = depth + live.to(torch.int32)
        # flags of a subtree built after the chain finished come from the
        # masked budget, not from its trajectory
        t_turn, t_div = t_turn | (live & s_turn), t_div | (live & s_div)
        t_sacc = torch.where(done, t_sacc, s_sacc)
        t_scnt = torch.where(done, t_scnt, s_scnt)
        done = done | ~sub_ok | global_turn

    info = NUTSInfo(
        accept_prob=t_sacc / torch.clamp(t_scnt, min=1.0),
        num_leapfrogs=n_leap,
        diverged=t_div,
        depth=depth,
    )
    return z_prop, info


def nuts_transition_cols(
    logdensity_cols: Callable,
    q0: torch.Tensor,
    key,
    eps: float,
    max_depth: int = 8,
    divergence_threshold: float = 1000.0,
    inv_mass=None,
):
    """One NUTS transition over an explicit ``(D, N)`` chain batch.

    ``key`` is a ``NUTSDraws`` (whose counter-stream salts it advances), a
    ``torch.Generator``, an int seed, or a PRNG key (``core/keys.py``, of
    either implementation), from which it draws what the reference's
    ``nuts_transition_cols`` draws. ``inv_mass`` is an optional diagonal
    inverse mass of shape ``(D,)`` or ``(D, 1)``.

    A row-sharded density (``.row_shard``): ``q0`` is this rank's block; the
    kinetic energies and both U-turn dot products are sums over the model
    axis, and every model rank of a chain draws alike and keeps its rows of
    the full-height momentum.

    Returns ``(z_new, NUTSInfo)`` with per-chain ``(N,)`` info fields.
    """
    d, n = q0.shape
    device = q0.device
    rows = Rows(logdensity_cols, d)
    if isinstance(key, NUTSDraws):
        draws = key
    elif keys.is_key(key):
        draws = NUTSDraws("rbg", None, n, None, device, max_depth=max_depth, step_keys=key[None])
    else:
        draws = NUTSDraws("generator", rows.seed(key), n, None, device)
    inv_mass = _inv_mass_col(inv_mass, d, device)
    mom_std = _mom_std(inv_mass, draws.rng)
    draws.start()

    def kinetic(r):
        return 0.5 * rows.sum(inv_mass * r * r)

    q0 = q0.to(torch.float32)
    r0 = mom_std * rows.normal(draws.normal)
    ld0, g0 = _lp_grad(logdensity_cols, q0)
    energy0 = -ld0 + kinetic(r0)
    draws.advance()  # r0 took salts s and s + 1; the doubling starts at s + 4

    z_m, r_m, g_m = q0, r0, g0
    z_p, r_p, g_p = q0, r0, g0
    z_prop, lw_traj = q0, -energy0
    fbool = torch.zeros(n, dtype=torch.bool, device=device)
    done, t_turn, t_div = fbool, fbool, fbool
    n_leap = torch.zeros(n, dtype=torch.int32, device=device)
    depth = torch.zeros(n, dtype=torch.int32, device=device)
    t_sacc = torch.zeros(n, dtype=torch.float32, device=device)
    t_scnt = torch.zeros(n, dtype=torch.float32, device=device)
    ck_z = torch.zeros((max(max_depth, 1), d, n), dtype=torch.float32, device=device)
    ck_r = torch.zeros_like(ck_z)

    for j in range(max_depth):
        running = draws.blocks_any(~done)
        if not bool(running.any()):
            break
        direction = draws.direction(j)
        draws.advance(running)
        fwd = direction > 0
        e = (eps * direction)[None, :]

        # the subtree of 2**j leaves off the moving end
        z = torch.where(fwd[None, :], z_p, z_m)
        r = torch.where(fwd[None, :], r_p, r_m)
        g = torch.where(fwd[None, :], g_p, g_m)
        s_zprop = z
        lw_sub = torch.full((n,), -torch.inf, device=device)
        s_turn, s_div, s_sacc, s_scnt = fbool, fbool, t_sacc, t_scnt
        for i in range(1 << j):
            active = ~(s_turn | s_div | done)
            running_leaf = draws.blocks_any(active)
            if not bool(running_leaf.any()):
                break
            r_half = r + 0.5 * e * g
            z_new = z + e * inv_mass * r_half
            ld_new, g_new = _lp_grad(logdensity_cols, z_new)
            r_new = r_half + 0.5 * e * g_new

            bc = bin(i).count("1")
            ck_z[bc], ck_r[bc] = z_new, r_new

            energy = -ld_new + kinetic(r_new)
            energy = torch.where(torch.isnan(energy), torch.inf, energy)
            lw_leaf = -energy
            div_new = active & (energy - energy0 > divergence_threshold)
            lw_new = torch.where(active, _logaddexp(lw_sub, lw_leaf), lw_sub)
            p_take = torch.exp(lw_leaf - lw_new)
            take = active & (draws.leaf(j, i) < p_take)  # NaN p_take never takes
            draws.advance(running_leaf)
            s_zprop = torch.where(take[None, :], z_new, s_zprop)

            acc = torch.minimum(torch.ones_like(energy), torch.exp(energy0 - energy))
            s_sacc = s_sacc + torch.where(active, acc, 0.0)
            s_scnt = s_scnt + active.to(torch.float32)

            # the openers of every subtree closing at leaf i are the top
            # ntz(i + 1) stack entries
            ntz1 = ((i + 1) & -(i + 1)).bit_length() - 1
            for j_off in range(ntz1):
                slot = bc - 1 - j_off
                dz = direction[None, :] * (z_new - ck_z[slot])
                s_turn = s_turn | (active & _uturn(dz, inv_mass, ck_r[slot], r_new, rows))

            z = torch.where(active[None, :], z_new, z)
            r = torch.where(active[None, :], r_new, r)
            g = torch.where(active[None, :], g_new, g)
            lw_sub = lw_new
            s_div = s_div | div_new

        sub_ok = ~(s_turn | s_div)
        p_acc = torch.minimum(torch.ones_like(lw_sub), torch.exp(lw_sub - lw_traj))
        live = ~done
        take = live & sub_ok & (draws.subtree(j) < p_acc)
        draws.advance(running)
        z_prop = torch.where(take[None, :], s_zprop, z_prop)
        grow = live & sub_ok
        lw_traj = torch.where(grow, _logaddexp(lw_traj, lw_sub), lw_traj)
        upd_f = (grow & fwd)[None, :]
        upd_b = (grow & ~fwd)[None, :]
        z_p, r_p, g_p = (torch.where(upd_f, s, t) for s, t in ((z, z_p), (r, r_p), (g, g_p)))
        z_m, r_m, g_m = (torch.where(upd_b, s, t) for s, t in ((z, z_m), (r, r_m), (g, g_m)))

        global_turn = _uturn(z_p - z_m, inv_mass, r_m, r_p, rows)
        n_leap = n_leap + torch.where(done, 0, 1 << j).to(torch.int32)
        depth = depth + (~done).to(torch.int32)
        t_turn, t_div = t_turn | s_turn, t_div | s_div
        t_sacc = torch.where(done, t_sacc, s_sacc)
        t_scnt = torch.where(done, t_scnt, s_scnt)
        done = done | ~sub_ok | global_turn
    draws.advance()

    info = NUTSInfo(
        accept_prob=t_sacc / torch.clamp(t_scnt, min=1.0),
        num_leapfrogs=n_leap,
        diverged=t_div,
        depth=depth,
    )
    return z_prop, info


def nuts_sweep_cols(
    logdensity_cols: Callable,
    q0: torch.Tensor,
    seed,
    *,
    n_steps: int,
    eps: float,
    max_depth: int = 8,
    inv_mass=None,
    rng: str = "generator",
    block_n: int | None = None,
    collect: bool = False,
    divergence_threshold: float = 1000.0,
    stream_rows=None,
):
    """``n_steps`` NUTS transitions over ``(D, N)`` column-layout chains: the
    plain version of the CUDA NUTS sweep (``nuts_pallas.nuts_sweep``).

    ``seed`` is an int or a ``torch.Generator``. ``rng="generator"`` is the
    ordinary twin; ``rng="counter"`` follows the reference kernel's counter
    stream, salt schedule and per-block exits for chain block ``block_n``
    (see the module docstring); ``rng="rbg"`` draws what the reference's
    ``nuts_sweep_cols`` draws from the int seed, draw for draw, the momentum's
    rows mapped by ``stream_rows`` (``hmc.rbg_rows_normal``). The statistics are accumulated per chain and
    averaged at the end, as the kernel does. A row-sharded density runs as
    ``nuts_transition_cols`` says, its statistics averaged over every chain
    of the mesh.

    Returns ``(q, accept_stat, mean_leapfrogs)``; with ``collect=True``,
    ``(q, accept_stat, mean_leapfrogs, draws, divergence_rate)`` where
    ``draws`` holds every transition's positions ``(n_steps, D, N)``.
    """
    d, n = q0.shape
    device = q0.device
    rows = Rows(logdensity_cols, d)
    draws = NUTSDraws(rng, rows.seed(seed), n, block_n, device, n_steps=n_steps, max_depth=max_depth,
                      stream_rows=stream_rows)
    q = q0.to(torch.float32)
    acc_sum = torch.zeros(n, dtype=torch.float32, device=device)
    leap_sum = torch.zeros(n, dtype=torch.float32, device=device)
    div_sum = torch.zeros(n, dtype=torch.float32, device=device)
    samples = []
    for _ in range(n_steps):
        q, info = nuts_transition_cols(
            logdensity_cols, q, draws, eps, max_depth=max_depth,
            divergence_threshold=divergence_threshold, inv_mass=inv_mass,
        )
        acc_sum = acc_sum + info.accept_prob
        leap_sum = leap_sum + info.num_leapfrogs.to(torch.float32)
        div_sum = div_sum + info.diverged.to(torch.float32)
        if collect:
            samples.append(q)
    accept_stat = rows.chain_mean(acc_sum.mean() / n_steps)
    mean_leaps = rows.chain_mean(leap_sum.mean() / n_steps)
    if collect:
        stacked = torch.stack(samples) if samples else q.new_zeros((0, d, n))
        return q, accept_stat, mean_leaps, stacked, rows.chain_mean(div_sum.mean() / n_steps)
    return q, accept_stat, mean_leaps
