"""Spawned gloo worlds for the port's multi-rank tests.

``run_world(program, world, tmp)`` starts ``world`` processes with
``torch.multiprocessing``'s spawn, joins them to a gloo process group through
a ``FileStore`` under ``tmp`` (no port to pick), runs
``program(rank, world, **kwargs)`` in every rank with one intra-op thread,
and returns what rank 0's call returned. A rank that raises fails the world
with its traceback; a world that has not finished in ``timeout`` seconds is
killed and fails, so that a rank that hangs cannot run the suite out of its
time. The programs live here, beside the helper: the ranks import this
module, torch and the port, and no JAX.

Each test file runs one world of all its multi-rank checks and asserts on
rank 0's results, one test a check.
"""

from __future__ import annotations

import math
import os
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

WORLD_TIMEOUT_S = 90


def _rank_main(program, rank: int, world: int, store_path: str, results, kwargs: dict) -> None:
    torch.set_num_threads(1)
    from genjax_tpu_torch.parallel import initialize_distributed

    try:
        initialize_distributed(rank=rank, world_size=world, store=dist.FileStore(store_path, world),
                               device_type="cpu", timeout_s=60)
        out = program(rank, world, **kwargs)
        if rank == 0:
            results.put(("ok", rank, out))
    except Exception:  # noqa: BLE001 - the boundary: reported to the parent, which fails the test
        results.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(program, world: int, tmp, timeout: float = WORLD_TIMEOUT_S, **kwargs):
    """Rank 0's ``program(0, world, **kwargs)`` from a spawned gloo world of
    ``world`` ranks; raises ``RuntimeError`` on a rank's error or on the
    timeout, the ranks killed either way."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(str(tmp), f"store_{program.__name__}_{time.monotonic_ns()}")
    procs = [ctx.Process(target=_rank_main, args=(program, r, world, store, results, kwargs), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                status, rank, out = results.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise RuntimeError(f"gloo world of {world} ranks ({program.__name__}) ran past {timeout} s") from None
            if status == "error":
                raise RuntimeError(f"rank {rank} of {program.__name__} failed:\n{out}")
            return out
    finally:
        # drain what other ranks wrote (their errors) before joining them
        try:
            while True:
                results.get_nowait()
        except queue.Empty:
            pass
        for p in procs:
            p.join(max(0.1, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def one_rank_group(tmp=None):
    """A 1-rank gloo group in this process, for the rank-free checks; the
    caller destroys it (``dist.destroy_process_group()``)."""
    from genjax_tpu_torch.parallel import initialize_distributed

    tmp = tempfile.mkdtemp() if tmp is None else str(tmp)
    initialize_distributed(rank=0, world_size=1, store=dist.FileStore(os.path.join(tmp, "store1"), 1),
                           device_type="cpu")


# ----------------------------------------------------------------------
# models shared by the programs
# ----------------------------------------------------------------------


def ssm_kernel():
    import genjax_tpu_torch as g

    @g.gen
    def kernel(c, x):
        z = g.normal(c, 1.0) @ "z"
        y = g.normal(z, 0.5) @ "y"
        return (z, y)

    return kernel


def exact_lgss_logz(ys, trans_sd=1.0, obs_sd=0.5) -> float:
    """The Kalman log marginal of ``z_t ~ N(z_{t-1}, q)``, ``y_t ~ N(z_t,
    r)``, ``z_0`` prior ``N(0, q)``."""
    q, r = trans_sd**2, obs_sd**2
    mean, var, log_z = 0.0, q, 0.0
    for y in np.asarray(ys, np.float64):
        s = var + r
        log_z += -0.5 * (math.log(2 * math.pi * s) + (y - mean) ** 2 / s)
        k = var / s
        mean, var = mean + k * (y - mean), var * (1 - k) + q
    return log_z


def conjugate_model():
    import genjax_tpu_torch as g

    @g.gen
    def model():
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(mu, 1.0) @ "y"

    return model


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


# ----------------------------------------------------------------------
# tests/test_torch_parallel.py
# ----------------------------------------------------------------------


def parallel_world(rank: int, world: int, *, lw, draws, ys_local, ys_gather):
    import genjax_tpu_torch as g
    from genjax_tpu_torch.parallel import (
        SSMParticleFilter,
        collective_log,
        collective_log_normalizer,
        collective_resample,
        collective_weight_stats,
        gather_batch,
        make_hier_mesh,
        make_mesh,
        run_chains_sharded,
        shard_batch,
        sharded_importance,
        warmup_adapt_step_size,
    )
    from genjax_tpu_torch.inference.diagnostics import ess, split_rhat
    from genjax_tpu_torch.inference.sample import sample_posterior

    out = {}
    mesh = make_mesh(device="cpu")
    hier = make_hier_mesh(2, world // 2, device="cpu")
    lw_all = torch.from_numpy(lw)
    # the weight statistics over 4 ranks, and over the 2 ranks of an island
    local = shard_batch(lw_all, mesh)
    out["stats4"] = [float(v) for v in collective_weight_stats(local, mesh)]
    out["norm4"] = float(collective_log_normalizer(local, mesh))
    half = lw_all.reshape(2, -1)[hier.axis_index("island")]
    local2 = shard_batch(half, hier, "batch")
    out["stats2"] = [float(v) for v in collective_weight_stats(local2, hier, "batch")]
    out["norm2"] = float(collective_log_normalizer(local2, hier, "batch"))

    # collective resampling: exact global resampling, and local mode
    k = lw_all.shape[0]
    particles = shard_batch(torch.arange(float(k)), mesh)
    for method in ("systematic", "multinomial"):
        new_p, new_lw, inc = collective_resample(torch.Generator().manual_seed(5), particles, local, mesh,
                                                 mode="all_gather", method=method)
        out[f"all_gather_{method}"] = _np(gather_batch(new_p, mesh))
        out[f"all_gather_lw_{method}"] = _np(gather_batch(new_lw, mesh))
        out[f"all_gather_inc_{method}"] = float(inc)
    gen_r = torch.Generator().manual_seed(100 + rank)
    new_p, new_lw, inc = collective_resample(gen_r, particles, local, mesh, mode="local")
    out["local_inc"] = float(inc)
    out["local_lw"] = _np(gather_batch(new_lw, mesh))

    # the sharded particle filter against Kalman, both modes
    kernel = ssm_kernel()
    pf = SSMParticleFilter(kernel, n_particles=4096)
    ys = torch.from_numpy(ys_local)
    with collective_log() as log:
        res = pf.run_sharded(0, 0.0, torch.zeros(len(ys)), g.C[:, "y"].set(ys), mesh)
    out["pf_local"] = float(res.log_marginal)
    out["pf_local_shapes"] = (tuple(res.carries.shape), tuple(res.ess_history.shape))
    out["pf_local_calls"] = [(c.op, c.axis, c.step) for c in log]
    ys = torch.from_numpy(ys_gather)
    pf = SSMParticleFilter(kernel, n_particles=1024)
    res = pf.run_sharded(1, 0.0, torch.zeros(len(ys)), g.C[:, "y"].set(ys), mesh, resample_mode="all_gather")
    out["pf_gather"] = float(res.log_marginal)
    a = pf.run_sharded(2, 0.0, torch.zeros(len(ys)), g.C[:, "y"].set(ys), mesh)
    b = pf.run_sharded(2, 0.0, torch.zeros(len(ys)), g.C[:, "y"].set(ys), mesh)
    out["pf_repeat_equal"] = bool(torch.equal(a.log_weights, b.log_weights) and torch.equal(a.log_marginal,
                                                                                             b.log_marginal))

    @g.gen
    def flip_model():
        p = g.beta(2.0, 2.0) @ "p"
        g.flip(p) @ "v"

    obs = g.C["v"].set(True)
    _trs, ws, log_z = sharded_importance(lambda gen: flip_model.importance(gen, obs, ()), 3, 4096, mesh)
    out["importance"] = (float(log_z), tuple(ws.shape))

    # sharded chains on the conjugate posterior N(1, 1/2)
    model = conjugate_model()
    cobs = g.C["y"].set(2.0)
    res = run_chains_sharded(4, lambda gen: model.generate(gen, cobs, ())[0], g.HMC(g.S["mu"], 0.3, L=10),
                             n_steps=60, n_chains=512, mesh=mesh, record=lambda t: t.get_choices()["mu"])
    out["chains_finals"] = _np(gather_batch(res.history[:, -1], mesh))
    out["chains_shapes"] = (tuple(res.history.shape), tuple(res.accept_rate.shape))

    # sample_posterior with the chains sharded (examples/14's check)
    obs1 = g.C["y"].set(2.0)
    for algorithm in ("hmc_sweep",):
        res = sample_posterior(5, model, obs1, (), g.S["mu"], n_chains=512, n_warmup=30, n_samples=40,
                               algorithm=algorithm, eps0=0.3, L=5, mesh=mesh)
        draws_all = gather_batch(res["mu"], mesh)
        out[f"sample_{algorithm}"] = (_np(draws_all), float(res.rhat_of("mu")), float(res.ess_of("mu")),
                                      float(res.accept_rate), tuple(res["mu"].shape))

    # the column algorithms with the chains sharded (the reference's
    # test_sharded_chain_axis for chees, and the others at smaller sizes)
    for algorithm, kw in [
        ("chees", dict(n_chains=64, n_warmup=100, n_samples=30, eps0=0.1)),
        ("pt", dict(n_chains=64, n_warmup=60, n_samples=30, eps0=0.3, L=5, n_rungs=3)),
        ("dense_hmc", dict(n_chains=64, n_warmup=40, n_samples=30, eps0=0.3, L=5)),
        ("dense_nuts", dict(n_chains=64, n_warmup=40, n_samples=24, eps0=0.3, max_depth=4)),
    ]:
        res = sample_posterior(8, model, obs1, (), g.S["mu"], algorithm=algorithm, mesh=mesh, **kw)
        out[f"column_{algorithm}"] = (_np(gather_batch(res["mu"], mesh)), float(res.rhat_of("mu")),
                                      float(res.accept_rate), tuple(res["mu"].shape))

    # dual averaging to the target accept over every rank's chains
    obs1 = g.C["y"].set(1.0)
    gen = torch.Generator().manual_seed(6)
    n_local = 256 // world
    traces = torch.func.vmap(lambda _: model.generate(gen, obs1, ())[0], randomness="different")(
        torch.zeros(n_local))
    traces, eps = warmup_adapt_step_size(7, traces, lambda e: g.HMC(g.S["mu"], e, L=5), n_warmup=100, eps0=2.0,
                                         mesh=mesh)

    def accept_prob(tr):
        _new, alpha, _, _ = tr.edit(gen, g.HMC(g.S["mu"], eps, L=5))
        return torch.clamp(torch.exp(alpha), max=1.0)

    accs = torch.func.vmap(accept_prob, randomness="different")(traces)
    out["warmup"] = (float(eps), float(mesh.all_reduce_mean(accs.mean(), "batch")))

    # the diagnostics over every rank's chains, against one rank on the whole
    d_all = torch.from_numpy(draws)
    d_local = shard_batch(d_all, mesh)
    out["rhat"] = (_np(split_rhat(d_local, mesh=mesh)), _np(split_rhat(d_all)))
    out["ess"] = (_np(ess(d_local, max_lag=20, mesh=mesh)), _np(ess(d_all, max_lag=20)))
    e_local, (tau_l, trunc_l) = ess(d_local, return_tau=True, mesh=mesh)
    e_all, (tau_a, trunc_a) = ess(d_all, return_tau=True)
    out["ess_tau"] = (_np(e_local), _np(tau_l), _np(trunc_l), _np(e_all), _np(tau_a), _np(trunc_a))

    # the mesh's refusals
    msgs = {}
    for name, call in [
        ("make_mesh_over", lambda: make_mesh(2 * world, device="cpu")),
        ("make_mesh_under", lambda: make_mesh(1, device="cpu")),
        ("hier_split", lambda: make_hier_mesh(3, device="cpu")),
        ("hier_need", lambda: make_hier_mesh(2, world, device="cpu")),
        ("shard_batch", lambda: shard_batch(torch.zeros(world + 2), mesh)),
        ("pf_divide", lambda: SSMParticleFilter(kernel, n_particles=4 * world + 1).run_sharded(
            0, 0.0, torch.zeros(2), g.C[:, "y"].set(torch.zeros(2)), mesh)),
    ]:
        try:
            call()
            msgs[name] = None
        except ValueError as e:
            msgs[name] = str(e)
    out["messages"] = msgs
    return out


# ----------------------------------------------------------------------
# tests/test_torch_islands.py
# ----------------------------------------------------------------------


def islands_world(rank: int, world: int, *, ys, ys_short):
    import genjax_tpu_torch as g
    from genjax_tpu_torch.parallel import (
        IslandParticleFilter,
        collective_counts,
        collective_log,
        make_hier_mesh,
        make_mesh,
    )

    out = {}
    kernel = ssm_kernel()
    ys_t = torch.from_numpy(ys)
    obs = g.C[:, "y"].set(ys_t)
    for shape in ((2, 2), (4, 1), (1, 4)):
        mesh = make_hier_mesh(*shape, device="cpu")
        pf = IslandParticleFilter(kernel, n_particles=2048, exchange_every=4)
        res = pf.run_sharded(11, 0.0, torch.zeros(len(ys)), obs, mesh)
        out[shape] = (float(res.log_marginal), int(res.n_exchanges), tuple(res.island_log_weights.shape),
                      tuple(res.ess_history.shape), tuple(res.carries.shape))
    mesh = make_hier_mesh(2, 2, device="cpu")
    short = torch.from_numpy(ys_short)
    pf = IslandParticleFilter(kernel, n_particles=128, exchange_every=4)
    with collective_log() as log:
        pf.run_sharded(12, 0.0, torch.zeros(len(short)), g.C[:, "y"].set(short), mesh)
    out["audit"] = collective_counts(log)
    out["audit_calls"] = [(c.op, c.axis, c.step, c.shape) for c in log]
    # exchange every step and never
    for every in (1, 10_000):
        pf = IslandParticleFilter(kernel, n_particles=2048, exchange_every=every)
        res = pf.run_sharded(13, 0.0, torch.zeros(len(ys)), obs, mesh)
        out[f"every_{every}"] = (float(res.log_marginal), int(res.n_exchanges))
    msgs = {}
    for name, call in [
        ("axes", lambda: IslandParticleFilter(kernel, n_particles=64).run_sharded(
            0, 0.0, torch.zeros(4), obs, make_mesh(device="cpu"))),
        ("divide", lambda: IslandParticleFilter(kernel, n_particles=63).run_sharded(
            0, 0.0, torch.zeros(4), obs, mesh)),
    ]:
        try:
            call()
            msgs[name] = None
        except ValueError as e:
            msgs[name] = str(e)
    out["messages"] = msgs
    return out


# ----------------------------------------------------------------------
# tests/test_torch_data_sharded.py
# ----------------------------------------------------------------------


def data_world(rank: int, world: int, *, X, Y, q, obs, q0):
    from genjax_tpu_torch.kernels.hmc import pallas_hmc
    from genjax_tpu_torch.parallel import data_sharded_logdensity, gather_batch, make_mesh_2d, shard_batch

    d_real = X.shape[1]

    def log_prior(q):
        return -0.5 * torch.sum(q**2, dim=0)

    def log_lik(q, shard):
        x, y = shard
        logits = x @ q[:d_real]
        return torch.sum(y[:, None] * torch.nn.functional.logsigmoid(logits)
                         + (1.0 - y[:, None]) * torch.nn.functional.logsigmoid(-logits), dim=0)

    out = {}
    data = (torch.from_numpy(X), torch.from_numpy(Y))
    q_all = torch.from_numpy(q)
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh_2d(shape, device="cpu")
        ld = data_sharded_logdensity(log_prior, log_lik, data, mesh)
        q_local = shard_batch(q_all.T, mesh, "batch").T.contiguous().requires_grad_(True)
        val = ld(q_local)
        (grad,) = torch.autograd.grad(val.sum(), q_local)
        out[shape] = (_np(gather_batch(val.detach(), mesh, "batch")),
                      _np(gather_batch(grad.T.contiguous(), mesh, "batch").T))
    mesh = make_mesh_2d((1, 4), device="cpu")
    ld = data_sharded_logdensity(log_prior, log_lik, data, mesh, chain_axis=None)
    qq = q_all.clone().requires_grad_(True)
    val = ld(qq)
    (grad,) = torch.autograd.grad(val.sum(), qq)
    out["replicated_chains"] = (_np(val.detach()), _np(grad))
    try:
        data_sharded_logdensity(log_prior, log_lik, (torch.zeros(13, d_real), torch.zeros(13)), mesh)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)

    # the conjugate Gaussian mean through the column HMC twin: data 2-way,
    # chains 2-way
    sigma = 0.7
    mesh = make_mesh_2d((2, 2), device="cpu")

    def lp(q):
        return -0.5 * torch.sum(q**2, dim=0)

    def ll(q, shard):
        (ys,) = shard
        return torch.sum(-0.5 * ((ys[:, None] - q[0]) / sigma) ** 2 - math.log(sigma * math.sqrt(2 * math.pi)),
                         dim=0)

    ld = data_sharded_logdensity(lp, ll, (torch.from_numpy(obs),), mesh)
    q0_local = shard_batch(torch.from_numpy(q0).T, mesh, "batch").T.contiguous()
    qf, accept = pallas_hmc(ld, q0_local, 7 + mesh.axis_index("batch"), n_steps=100, eps=0.15, L=8,
                            backend="torch")
    out["hmc"] = (_np(gather_batch(qf[0], mesh, "batch")), float(mesh.all_reduce_mean(accept, "batch")))
    return out


# ----------------------------------------------------------------------
# tests/test_torch_tensor_parallel.py
# ----------------------------------------------------------------------


def tensor_parallel_world(rank: int, world: int, *, X, y, q, hidden):
    from genjax_tpu_torch.parallel import (
        make_mesh_2d,
        shard_params,
        tensor_parallel_logdensity,
        tp_bnn_logdensity,
    )

    out = {}
    Xt, yt, q_all = torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(q)

    def assemble(mesh, block):
        """The whole ``(D, N)`` from every rank's block, on every rank."""
        rows = mesh.all_gather_cat(block, "model")
        cols = mesh.all_gather_cat(rows.T.contiguous(), "batch").T
        return cols

    for shape in ((2, 2), (4, 1), (1, 4)):
        mesh = make_mesh_2d(shape, axes=("model", "batch"), device="cpu")
        ld = tp_bnn_logdensity(Xt, yt, hidden, mesh)
        block = shard_params(q_all, mesh).requires_grad_(True)
        val = ld(block)
        (grad,) = torch.autograd.grad(val.sum(), block)
        vals = mesh.all_gather_cat(val.detach(), "batch")
        out[shape] = (_np(vals), _np(assemble(mesh, grad)))
    mesh = make_mesh_2d((4, 1), axes=("model", "batch"), device="cpu")

    # a generic shard_fn / combine_fn: a sum of squares split by rows
    def shard_fn(qb):
        return {"ss": torch.sum(qb * qb, dim=0), "s": torch.sum(qb, dim=0)}

    def combine_fn(t):
        return -0.5 * t["ss"] + 0.1 * t["s"]

    ld = tensor_parallel_logdensity(shard_fn, combine_fn, mesh)
    block = shard_params(q_all, mesh).requires_grad_(True)
    val = ld(block)
    (grad,) = torch.autograd.grad(val.sum(), block)
    out["generic"] = (_np(val.detach()), _np(assemble(mesh, grad)))
    try:
        tp_bnn_logdensity(Xt, yt, hidden + 2, mesh)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


# ----------------------------------------------------------------------
# tests/test_torch_distributed.py
# ----------------------------------------------------------------------


def distributed_world(rank: int, world: int, *, ckpt_root: str):
    import genjax_tpu_torch as g
    from genjax_tpu_torch.inference.sample import sample_posterior
    from genjax_tpu_torch.inference.smc2 import smc2
    from genjax_tpu_torch.parallel import make_mesh, run_chains_sharded

    out = {}
    mesh = make_mesh(device="cpu")
    # the cross-rank sum of rank + 1
    out["sum"] = float(mesh.all_reduce_sum(torch.tensor(float(rank + 1)), "batch"))
    out["ranks"] = (dist.get_rank(), dist.get_world_size(), dist.get_backend())

    model = conjugate_model()
    obs = g.C["y"].set(2.0)

    def chains(d, **kw):
        kw = {"checkpoint_every": 4, **kw}
        return run_chains_sharded(9, lambda gen: model.generate(gen, obs, ())[0], g.HMC(g.S["mu"], 0.3, L=5),
                                  n_steps=12, n_chains=64, mesh=mesh, record=lambda t: t.get_choices()["mu"],
                                  checkpoint_dir=d, **kw)

    whole = chains(None, checkpoint_every=0)
    segmented = chains(os.path.join(ckpt_root, "seg"))
    d = os.path.join(ckpt_root, "stopped")
    partial = chains(d, max_segments=2)
    mesh.barrier()
    layout = sorted(os.listdir(d)), sorted(os.listdir(os.path.join(d, f"rank_{rank}")))
    resumed = chains(d)

    def same(a, b):
        return bool(torch.equal(a.history, b.history) and torch.equal(a.accept_rate, b.accept_rate)
                    and torch.equal(a.trace.get_choices()["mu"], b.trace.get_choices()["mu"]))

    out["chains"] = {
        "segmented_equal": same(whole, segmented),
        "resumed_equal": same(whole, resumed),
        "partial_steps": tuple(partial.history.shape),
        "layout": layout,
        "all_equal": [bool(v) for v in mesh.all_gather_cat(
            torch.tensor([float(same(whole, resumed))]), "batch").tolist()],
    }

    def sampled(d, **kw):
        return sample_posterior(10, model, obs, (), g.S["mu"], n_chains=32, n_warmup=12, n_samples=12,
                                algorithm="hmc", eps0=0.3, L=3, mesh=mesh, checkpoint_dir=d, checkpoint_every=4,
                                **kw)

    whole = sample_posterior(10, model, obs, (), g.S["mu"], n_chains=32, n_warmup=12, n_samples=12,
                             algorithm="hmc", eps0=0.3, L=3, mesh=mesh)
    d = os.path.join(ckpt_root, "sample")
    sampled(d, max_segments=2)
    resumed = sampled(d)
    out["sample_resumed_equal"] = bool(torch.equal(whole["mu"], resumed["mu"])
                                       and float(whole.accept_rate) == float(resumed.accept_rate))

    # SMC² with the parameter particles sharded: an AR(1) coefficient
    @g.gen
    def theta_kernel(c, x):
        (a, z) = c
        z2 = g.normal(a * z, 1.0) @ "z"
        y = g.normal(z2, 0.5) @ "y"
        return ((a, z2), y)

    ys = torch.tensor([0.3, 0.9, 1.1, 0.6, 0.8, 1.2])
    res = smc2(11, theta_kernel, lambda gen: 0.5 + 0.2 * torch.randn((), generator=gen),
               lambda a: -0.5 * ((a - 0.5) / 0.2) ** 2, 0.0, torch.zeros(6), g.C[:, "y"].set(ys), n_theta=64,
               n_x=32, ess_threshold=0.9, mesh=mesh)
    all_lw = mesh.all_gather_cat(res.log_weights, "batch")
    out["smc2"] = (tuple(res.thetas.shape), float(torch.logsumexp(all_lw, 0)), float(res.log_evidence),
                   tuple(res.ess_history.shape), float(res.rejuv_accept_rate))
    return out
