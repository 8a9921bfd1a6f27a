"""The trace path on K1 and K4 for any model: the batched trace drivers
(``run_chains_hmc``, ``run_chains_nuts``, ``sample_posterior(hmc_sweep)``)
stage the model's column density (``kernels/staged.py``) over chain 0's
frozen choices and arguments, each leaf that differs between chains read by
every chain from its own chain operands (``mcmc._KernelView``).

Here, on numpy-seeded traces made alike in both packages
(``tests/torch_chm_bridge.py``):

- the staged body's ``lp_grad(q, c)`` equals the reference's
  ``column_view(traces, sel)[1]`` and ``jax.grad`` of its sum to rtol 1e-5
  and atol 1e-5 (the staged tests' tolerance): the flagship with ``tau``
  frozen per chain (``S["w"]``, ``k = 1``) and with each chain's own ``y``
  (``S["w"] | S["tau"]``, ``k = 16``), a discrete leaf frozen per chain and
  read through ``where``, and per-chain arguments;
- the emitted function with chain operands, compiled by the host's C++
  compiler, equals the lowered program;
- the view: the ``q`` and ``c`` packing, the sorting of every leaf with one
  host read, the header ``column_hmc`` stages when no leaf differs;
- ``sample_posterior(hmc_sweep)`` routed to the kernel stages once across
  its warmup, draws and checkpoint segments.

The ``cuda`` cases hold K1 and K4 with chain operands against their plain
versions on the counter stream. JAX is imported inside the tests that
compare with it, so that the ``cuda`` cases also run on a machine with no
JAX: ``python -m pytest tests/test_torch_trace_staged.py -m cuda --noconftest``.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import mcmc, sample
from genjax_tpu_torch.kernels import column_hmc, hmc, nuts, nuts_pallas, staged
from genjax_tpu_torch.models import hierarchical_regression
from torch_threads import _one_thread  # noqa: F401

N = 16


def flagship_data():
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    return X, y


def wide_data():
    """The flagship's model at 40 observations: each chain's own ``y`` is 40
    chain operands, past the kernels' register cap
    (``staged.CHAIN_REGISTER_CAP``)."""
    X = np.random.default_rng(2).normal(size=(40, 8)).astype(np.float32)
    y = np.random.default_rng(3).normal(size=(40,)).astype(np.float32)
    return X, y


@g.gen
def switched():
    b = g.flip(0.5) @ "b"
    mu = g.normal(torch.where(b, 2.0, -2.0), 1.0) @ "mu"
    _ = g.normal(mu, 0.5) @ "y"


@g.gen
def scaled(s):
    mu = g.normal(0.0, s) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


def _choices(case: str, n: int, seed: int = 0, spread: float = 0.1, y_shift: float = 0.0):
    """``(port model, {address: numpy values of every chain}, per-chain
    argument or None, selection)`` of one case. (ii) gives chain ``c`` the
    data ``y + spread * c``: ``tests/test_torch_mcmc.py`` builds it with a
    spread of 1. The flagship's cases add ``y_shift`` to every chain's
    data."""
    rng = np.random.default_rng(seed)
    if case in ("i", "ii", "wide"):
        X, y = wide_data() if case == "wide" else flagship_data()
        ys = np.broadcast_to(y + np.float32(y_shift), (n, y.shape[0])).copy()
        if case != "i":
            ys += np.float32(spread) * np.arange(n, dtype=np.float32)[:, None]
        values = {"tau": rng.uniform(0.5, 1.5, n).astype(np.float32),
                  "w": (0.3 * rng.normal(size=(n, 8))).astype(np.float32), "y": ys}
        sel = g.S["w"] if case == "i" else g.S["w"] | g.S["tau"]
        return hierarchical_regression(X), values, None, sel
    if case == "discrete":
        values = {"b": rng.random(n) < 0.5, "mu": rng.normal(size=n).astype(np.float32),
                  "y": np.full(n, 0.3, np.float32)}
        return switched, values, None, g.S["mu"]
    values = {"mu": rng.normal(size=n).astype(np.float32), "y": np.full(n, 0.7, np.float32)}
    return scaled, values, rng.uniform(0.5, 2.0, n).astype(np.float32), g.S["mu"]


def _constraint(values: dict):
    chm = None
    for addr, v in values.items():
        part = g.C[addr].set(torch.from_numpy(np.asarray(v)))
        chm = part if chm is None else chm | part
    return chm


def port_batch(case: str, n: int = N, seed: int = 0, device="cpu", spread: float = 0.1, y_shift: float = 0.0):
    """The case's traces in the port, every choice set from numpy."""
    model, values, arg, sel = _choices(case, n, seed, spread, y_shift)
    gen = torch.Generator(device=device).manual_seed(seed)
    chm = _constraint(values)
    chm = torch.utils._pytree.tree_map(lambda v: v.to(device), chm)
    if arg is None:
        trs = torch.func.vmap(lambda c: model.generate(gen, c, ())[0], randomness="different")(chm)
    else:
        a = torch.from_numpy(arg).to(device)
        trs = torch.func.vmap(lambda c, s: model.generate(gen, c, (s,))[0], randomness="different")(chm, a)
    return trs, sel


def reference_batch(case: str, trs):
    """The same traces in ``genjax_tpu``, and the reference's selection."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    import genjax_tpu as gj
    from genjax_tpu.models import hierarchical_regression as j_hier
    from torch_chm_bridge import to_jax

    if case in ("i", "ii", "wide"):
        model = j_hier((wide_data() if case == "wide" else flagship_data())[0])
        sel = gj.S["w"] if case == "i" else gj.S["w"] | gj.S["tau"]
    elif case == "discrete":
        @gj.gen
        def model():
            b = gj.flip(0.5) @ "b"
            mu = gj.normal(jnp.where(b, 2.0, -2.0), 1.0) @ "mu"
            _ = gj.normal(mu, 0.5) @ "y"

        sel = gj.S["mu"]
    else:
        @gj.gen
        def model(s):
            mu = gj.normal(0.0, s) @ "mu"
            _ = gj.normal(mu, 1.0) @ "y"

        sel = gj.S["mu"]
    chm = to_jax(trs.get_choices())
    args = tuple(jnp.asarray(a.numpy()) for a in trs.get_args())
    jtrs = jax.vmap(lambda c, a: model.generate(jr.key(0), c, a)[0])(chm, args)
    return jtrs, sel


CASES = {"i": 1, "ii": 16, "wide": 40, "discrete": 1, "args": 1}  # case -> chain operands a chain


@pytest.fixture(scope="module")
def views():
    """Each case's port traces, ``z`` and kernel view."""
    out = {}
    for case in CASES:
        trs, sel = port_batch(case)
        z, _, _ = mcmc.column_view(trs, sel, 0)
        out[case] = (trs, sel, z, mcmc._KernelView(trs, sel, 0, z.shape[0]))
    return out


def _packed(view, z):
    """``z`` in the body's rows, the padding rows 0 (which adds nothing to
    the log-density)."""
    q = view.packer.pack_columns(z, view.rows, torch.Generator().manual_seed(0))
    q[view.packer.dim:] = 0.0
    return q


@pytest.mark.parametrize("case", sorted(set(CASES) - {"wide"}))
def test_staged_body_with_chain_operands_matches_the_reference_view(case, views):
    """At 16 chains, at the traces' choices and off them. (ii)'s data are
    ``y + 0.1 c``; at ``y + c``, and for 40 observations, see the next
    test."""
    import jax
    import jax.numpy as jnp

    from genjax_tpu.inference.requests.grad_view import column_view as j_column_view

    trs, sel, z, view = views[case]
    body = view.body
    assert body.name == "staged" and body.k == CASES[case] and tuple(body.chain.shape) == (body.k, N)
    jtrs, jsel = reference_batch(case, trs)
    jz, jld, _ = j_column_view(jtrs, jsel)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))  # the same raveling in both
    for shift in (0.0, 0.1):  # at the traces' choices, and off them
        zs = z + shift * torch.from_numpy(np.random.default_rng(7).normal(size=tuple(z.shape)).astype(np.float32))
        jzs = jnp.asarray(zs.numpy())
        jlp, jg = jax.jit(lambda x: (jld(x), jax.grad(lambda v: jnp.sum(jld(v)))(x)))(jzs)
        lp, grad = body.lp_grad(_packed(view, zs), body.chain)
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(view.packer.unpack_columns(grad, view.rows).numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-5)


def _flagship_grad64(trs, z, X):
    """The flagship's gradient over ``(tau, w)`` in float64 (numpy): the
    log-normal prior of tau, N(0, tau) of each w_j, N(X w, 0.25) of y."""
    X = X.astype(np.float64)
    z = z.numpy().astype(np.float64)
    tau, w = z[0], z[1:]
    r = trs["y"].numpy().astype(np.float64).T - X @ w
    g_tau = -(4.0 * np.log(tau) + 1.0) / tau + (w * w).sum(0) / tau**3 - w.shape[0] / tau
    return np.concatenate([g_tau[None], -w / tau**2 + X.T @ r / 0.0625])


@pytest.mark.parametrize("case, spread", [("ii", 1.0), ("wide", 0.1)])
def test_with_widely_spread_data_the_body_is_as_close_to_float64_as_the_reference(case, spread):
    """(ii) as ``tests/test_torch_mcmc.py`` builds it, ``y + c`` for chain
    ``c``, and the flagship's model at 40 observations: a gradient of ``w``
    is a float32 sum of terms that cancel (near 1e3 far from the data; 40
    of them), where neither package comes within 1e-5 of the other
    everywhere; each is held against the float64 gradient instead, the
    port's largest error within twice the reference's (and a float32 step
    of the largest gradient), and the log-densities to 1e-5 of each
    other."""
    import jax
    import jax.numpy as jnp

    from genjax_tpu.inference.requests.grad_view import column_view as j_column_view

    trs, sel = port_batch(case, spread=spread)
    z, _, _ = mcmc.column_view(trs, sel, 0)
    view = mcmc._KernelView(trs, sel, 0, z.shape[0])
    assert view.body.k == CASES[case]
    jtrs, jsel = reference_batch(case, trs)
    _, jld, _ = j_column_view(jtrs, jsel)
    jz = jnp.asarray(z.numpy())
    jlp, jg = jax.jit(lambda x: (jld(x), jax.grad(lambda v: jnp.sum(jld(v)))(x)))(jz)
    lp, grad = view.body.lp_grad(_packed(view, z), view.body.chain)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    truth = _flagship_grad64(trs, z, (wide_data() if case == "wide" else flagship_data())[0])
    port_err = np.abs(view.packer.unpack_columns(grad, view.rows).numpy() - truth).max()
    ref_err = np.abs(np.asarray(jg, np.float64) - truth).max()
    step = float(np.spacing(np.float32(np.abs(truth).max())))
    assert port_err <= 2 * ref_err + step, (port_err, ref_err, step)


def test_the_view_packs_q_and_the_chain_operands(views):
    """``q``: ``z``'s rows in the packer's order, padded, and back; ``c``:
    each differing leaf's values, one row an element, chain-minor."""
    for case in CASES:
        trs, sel, z, view = views[case]
        q = view.packer.pack_columns(z, view.rows, torch.Generator().manual_seed(1))
        assert q.shape == (view.packer.padded_dim, N) and q.is_contiguous()
        assert torch.equal(view.packer.unpack_columns(q, view.rows), z)
        c = view.body.chain
        assert c.dtype == torch.float32 and c.is_contiguous()
    choices = {case: views[case][0] for case in CASES}
    assert torch.equal(views["i"][3].body.chain, choices["i"]["tau"][None])
    assert torch.equal(views["ii"][3].body.chain, choices["ii"]["y"].T)
    assert torch.equal(views["wide"][3].body.chain, choices["wide"]["y"].T)
    # the kernels hold up to CHAIN_REGISTER_CAP a chain in registers, and
    # read more through __ldg at each gradient
    assert {case: views[case][3].body.chain_read for case in CASES} == {
        "i": "registers", "ii": "registers", "wide": "ldg", "discrete": "registers", "args": "registers"}
    assert "constexpr bool kChainInRegisters = false;" in views["wide"][3].body.header
    assert "constexpr bool kChainInRegisters = true;" in views["ii"][3].body.header
    assert torch.equal(views["discrete"][3].body.chain, choices["discrete"]["b"].float()[None])
    assert torch.equal(views["args"][3].body.chain, choices["args"].get_args()[0][None])
    # the twin reads the block the body is bound to
    trs, sel, z, view = views["ii"]
    q = _packed(view, z)
    lp_bound, _ = hmc._lp_grad(view.body, q)
    lp, _ = view.body.lp_grad(q, view.body.chain)
    assert torch.equal(lp_bound, lp)
    with pytest.raises(ValueError, match="chain operands"):
        view.body.lp_grad(q, view.body.chain[:, :3])


class _Reads:
    """Counts the host reads of tensor values while it is entered."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("tolist", "item", "__bool__", "__int__", "__float__", "numpy"):
            original = getattr(torch.Tensor, name)

            def counted(self_, *a, _original=original, **k):
                self.n += 1
                return _original(self_, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, counted)


def test_every_leaf_is_sorted_with_one_host_read(monkeypatch):
    n = 12
    base = torch.arange(n, dtype=torch.float32)
    leaves = [
        torch.ones(n, 3),                              # 0: constant
        base[:, None] * torch.ones(n, 2),              # 1: differs
        base % 2 == 0,                                 # 2: a boolean that differs
        torch.full((n,), 7, dtype=torch.int64),        # 3: a constant integer
        torch.arange(n) - 5,                           # 4: an integer that differs
        torch.full((n, 2), float("nan")),              # 5: constant NaN
        2.5,                                           # 6: not a tensor: a constant
        torch.full((n,), 2**30, dtype=torch.int64),    # 7: a large constant integer
    ]
    reads = _Reads(monkeypatch)
    assert mcmc.chain_varying(leaves, 0) == [1, 2, 4]
    assert reads.n == 1
    lanes = [v.movedim(0, -1) if isinstance(v, torch.Tensor) else v for v in leaves]
    assert mcmc.chain_varying(lanes, -1) == [1, 2, 4] and reads.n == 2
    big = torch.arange(n, dtype=torch.int64) + 2**24
    with pytest.raises(ValueError, match="2\\^?24|16777216") as err:
        mcmc.chain_varying([big], 0)
    assert "backend='torch'" in str(err.value)
    assert mcmc.chain_varying([torch.arange(n, dtype=torch.int64) + 2**24 - n + 1], 0) == [0]


def test_with_no_chain_operand_the_header_is_column_hmcs(monkeypatch):
    """A batch whose frozen choices are the same in every chain stages the
    program ``column_hmc`` stages for the model: the same header (with
    ``kChain = 0`` and no ``GJT_STAGED_CHAIN``), so the same build."""
    staged_by_column_hmc = []

    def recording(ld, d, device):
        body = staged.stage_body(ld, d, device=device)
        staged_by_column_hmc.append(body)
        return body

    monkeypatch.setattr(hmc, "staged_body_for", recording)
    obs = g.C["y"].set(torch.tensor(2.0))
    with pytest.raises(ValueError, match="takes a CUDA tensor"):
        column_hmc(conjugate, obs, (), ["mu"], n_chains=8, n_steps=1, eps=0.1, backend="cuda",
                             device="cpu")
    gen = torch.Generator().manual_seed(0)
    trs = torch.func.vmap(lambda _: conjugate.generate(gen, obs, ())[0], randomness="different")(torch.zeros(8))
    view = mcmc._KernelView(trs, g.S["mu"], 0, 1)
    assert view.body.k == 0 and view.body.chain is None
    assert view.body.header == staged_by_column_hmc[0].header
    assert "constexpr int kChain = 0;" in view.body.header and "GJT_STAGED_CHAIN" not in view.body.header


def test_column_hmc_still_refuses_a_chain_varying_constant():
    """A column density that closes over a constant that differs along the
    chain axis stays refused: chain operands come in as ``c``, explicitly."""
    centers = torch.arange(251.0)

    def ld(q):
        return -0.5 * ((q - centers[: q.shape[1]]) ** 2).sum(0)

    with pytest.raises(ValueError, match="carries the chain axis.*backend='torch'"):
        staged.stage_body(ld, 8)


def _host_compiler():
    return shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")


@pytest.mark.parametrize("case", ["ii", "wide", "discrete"])
def test_emitted_body_with_chain_operands_on_the_host_matches_the_lowering(case, views, tmp_path):
    cxx = _host_compiler()
    if cxx is None:
        pytest.skip("no host C++ compiler (g++, c++ or clang++) to compile the emitted body")
    trs, sel, z, view = views[case]
    body = view.body
    assert "#define GJT_STAGED_CHAIN 1" in body.header and f"constexpr int kChain = {body.k};" in body.header
    (tmp_path / "staged.cuh").write_text(body.header)
    (tmp_path / "driver.cpp").write_text(
        '#include "staged.cuh"\n'
        "struct Column {\n"
        "  const float* p;\n"
        "  int n;\n"
        "  float operator[](int r) const { return p[r * n]; }\n"
        "};\n"
        'extern "C" void run(const float* q, float* lp, float* g, const float* c, const float* cc, int n) {\n'
        "  for (int j = 0; j < n; ++j) {\n"
        "    float qq[gjt_staged::kD], gg[gjt_staged::kD];\n"
        "    for (int d = 0; d < gjt_staged::kD; ++d) qq[d] = q[d * n + j];\n"
        "    lp[j] = gjt_staged::lp_grad(qq, gg, Column{cc + j, n}, c);\n"
        "    for (int d = 0; d < gjt_staged::kD; ++d) g[d * n + j] = gg[d];\n"
        "  }\n"
        "}\n"
    )
    so = tmp_path / "driver.so"
    proc = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                           str(tmp_path / "driver.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    q = _packed(view, z + 0.05)
    lp = torch.empty(N)
    grad = torch.empty(body.d, N)
    consts = body.consts_on(torch.device("cpu"))
    lib.run(q.data_ptr(), lp.data_ptr(), grad.data_ptr(), consts.data_ptr(), body.chain.data_ptr(), N)
    lp_ref, g_ref = body.lp_grad(q)
    np.testing.assert_allclose(lp.numpy(), lp_ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), g_ref.numpy(), rtol=1e-5, atol=1e-5)


def test_sample_posterior_stages_once_across_warmup_draws_and_segments(monkeypatch, tmp_path):
    """``sample_posterior(hmc_sweep)`` routed to the kernel (the traces taken
    to live on a card; each launch run by the twin over the body it was
    given) stages the model once a call: its warmup windows, its draws and
    its checkpoint segments share the body, for a batch with no chain
    operand (the conjugate model) and for one with (the flagship's ``w``,
    ``tau`` frozen per chain: (i)). The conjugate draws hold its exact
    posterior, N(1, 1/2)."""
    monkeypatch.setattr(mcmc, "trace_device", lambda tree: torch.device("cuda"))
    launches, stagings = [], []

    def launch(density, q, seed, *, backend, **kw):
        assert backend == "cuda" and density.name == "staged"
        launches.append(density.k)
        return hmc._reference_hmc(density, q, seed, **kw)

    def stage(*args, **kw):
        stagings.append(1)
        return staged.stage_body(*args, **kw)

    monkeypatch.setattr(sample, "pallas_hmc", launch)
    monkeypatch.setattr(mcmc, "stage_body", stage)
    res = sample.sample_posterior(0, conjugate, g.C["y"].set(2.0), (), g.S["mu"], n_chains=256, n_warmup=60,
                                  n_samples=6, algorithm="hmc_sweep", eps0=0.5, L=5, device="cpu",
                                  checkpoint_dir=str(tmp_path / "conj"), checkpoint_every=2)
    assert len(stagings) == 1 and launches == [0] * (6 + 6)
    mu = res["mu"]  # 256 chains x 6 draws: its mean's sd is under 0.05, however the draws correlate
    assert abs(float(mu.mean()) - 1.0) < 0.15 and abs(float(mu.var()) - 0.5) < 0.15
    launches.clear()
    stagings.clear()
    X, y = flagship_data()
    sample.sample_posterior(1, hierarchical_regression(X), g.C["y"].set(torch.from_numpy(y)), (), g.S["w"],
                            n_chains=64, n_warmup=6, n_samples=4, algorithm="hmc_sweep", eps0=0.02, L=3,
                            device="cpu", checkpoint_dir=str(tmp_path / "flag"), checkpoint_every=2)
    assert len(stagings) == 1 and launches == [1] * (6 + 4)


def test_one_outer_scope_stages_each_dataset_of_its_own(monkeypatch):
    """Calls inside one outer ``staging_scope`` (a scope opened inside
    another is the outer one) on one model share a staging only where the
    values folded into its program are the same: ``sample_posterior`` with
    ``y = 2`` twice (two tensors of one value) stages once, with ``y = -2``
    stages again and samples its own posterior, N(-1, 1/2); a view of (i)
    with another ``y``, equal in every chain, gets a body that computes its
    own log-density."""
    monkeypatch.setattr(mcmc, "trace_device", lambda tree: torch.device("cuda"))
    stagings = []

    def launch(density, q, seed, *, backend, **kw):
        return hmc._reference_hmc(density, q, seed, **kw)

    def stage(*args, **kw):
        stagings.append(1)
        return staged.stage_body(*args, **kw)

    monkeypatch.setattr(sample, "pallas_hmc", launch)
    monkeypatch.setattr(mcmc, "stage_body", stage)
    kw = dict(n_chains=256, n_warmup=60, n_samples=6, algorithm="hmc_sweep", eps0=0.5, L=5, device="cpu")
    with staged.staging_scope():
        for seed, y_obs in enumerate((2.0, 2.0, -2.0)):
            res = sample.sample_posterior(seed, conjugate, g.C["y"].set(torch.tensor(y_obs)), (), g.S["mu"], **kw)
            assert len(stagings) == (1 if y_obs > 0 else 2)
            mu = res["mu"]
            assert abs(float(mu.mean()) - y_obs / 2) < 0.15 and abs(float(mu.var()) - 0.5) < 0.15
        trs, sel = port_batch("i")
        z, _, _ = mcmc.column_view(trs, sel, 0)
        first = mcmc._KernelView(trs, sel, 0, z.shape[0])
        assert mcmc._KernelView(trs, sel, 0, z.shape[0]).body.program is first.body.program
        trs2, _ = port_batch("i", y_shift=1.0)
        n_before = len(stagings)
        view2 = mcmc._KernelView(trs2, sel, 0, z.shape[0])
        assert len(stagings) == n_before + 1
    q = _packed(view2, z)
    fresh = mcmc._KernelView(trs2, sel, 0, z.shape[0])
    assert torch.equal(view2.body.lp_grad(q)[0], fresh.body.lp_grad(q)[0])
    assert not torch.equal(first.body.lp_grad(q)[0], fresh.body.lp_grad(q)[0])


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["i", "ii", "wide"])
def test_kernels_with_chain_operands_match_their_plain_versions(case):
    """K1 and K4 with chain operands against the twins over the same bound
    body, counter stream, at the gates of ``chip_smoke.py``: in registers
    ((i), (ii)) and read through ``__ldg`` (40 a chain)."""
    device = _cuda()
    trs, sel = port_batch(case, 4096, seed=3, device=device)
    z, _, _ = mcmc.column_view(trs, sel, 0)
    view = mcmc._KernelView(trs, sel, 0, z.shape[0])
    body = view.body
    assert body.k == CASES[case] and body.chain.is_cuda
    assert body.chain_read == ("ldg" if case == "wide" else "registers")
    q0 = view.packer.pack_columns(z, view.rows, torch.Generator(device=device).manual_seed(4))
    im = view.packer.pack_inv_mass(None, view.rows, device)
    kw = dict(rng="counter", block_n=128, inv_mass=im)
    qk, acc = hmc.hmc_sweep(body, q0, 5, n_steps=5, eps=0.02, L=5, **kw)
    assert hmc.hmc_sweep.last_variant == "staged"
    qt, rate = hmc._reference_hmc(body, q0, 5, n_steps=5, eps=0.02, L=5, **kw)
    assert float(((qk - qt).abs().amax(dim=0) <= 1e-4).float().mean()) >= 0.995
    assert abs(float(acc.mean()) / 5 - float(rate)) <= 0.005
    qk, acc, leaps = nuts_pallas.nuts_sweep(body, q0, 5, n_steps=3, eps=0.05, max_depth=6, **kw)
    qt, acc_t, leaps_t = nuts.nuts_sweep_cols(body, q0, 5, n_steps=3, eps=0.05, max_depth=6, **kw)
    assert float(((qk - qt).abs().amax(dim=0) <= 1e-4).float().mean()) >= 0.99
    assert abs(float(acc.mean()) / 3 - float(acc_t)) <= 0.005
    with pytest.raises(ValueError, match="chain operands"):
        hmc.hmc_sweep(body.bind(body.chain[:, :100].contiguous()), q0, 5, n_steps=1, eps=0.02, L=1)


@pytest.mark.cuda
def test_the_drivers_launch_the_kernels_on_the_card_by_default():
    device = _cuda()
    trs, sel = port_batch("ii", 2048, seed=5, device=device)
    gen = torch.Generator(device=device).manual_seed(6)
    hmc.hmc_sweep_launches = nuts_pallas.nuts_sweep_launches = 0
    new, acc = g.run_chains_hmc(gen, trs, sel, eps=0.02, L=5, n_steps=10)
    assert g.run_chains_hmc.last_backend == "cuda" and g.run_chains_hmc.last_body == "staged"
    assert hmc.hmc_sweep_launches == 1 and torch.equal(new["y"], trs["y"])
    new, acc, leaps = g.run_chains_nuts(gen, trs, sel, eps=0.02, max_depth=5, n_steps=3)
    assert g.run_chains_nuts.last_backend == "cuda" and g.run_chains_nuts.last_body == "staged"
    assert nuts_pallas.nuts_sweep_launches == 1 and float(leaps) >= 1.0
