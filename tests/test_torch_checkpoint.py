"""Checkpointed resume of ``sample_posterior`` (``inference/sample.py``)
and the checkpoint layer (``io/checkpoint.py``): the single-device tests of
``tests/inference/test_checkpoint_resume.py`` for the port's ``"hmc"``,
``"nuts"`` and ``"hmc_sweep"`` on the CPU.

A segmented run equals the unsegmented one bit for bit; a run stopped by
``max_segments`` and resumed, in the same process or in a fresh one, equals
the whole run bit for bit; a checkpoint of another geometry, other dynamics
or another seed is refused; the column algorithms refuse
``checkpoint_dir``; a crash between a state's write and the meta's flip
leaves a resumable checkpoint; ``n_samples=0`` fails before the warmup and
``max_segments=0`` on a fresh run raises; a save writes one segment's draws
beside the state, and a checkpoint of the layout that rewrote every draw is
refused. The sharded resume (2 gloo ranks) is in
``tests/test_torch_distributed.py``.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import sample
from genjax_tpu_torch.inference.sample import sample_posterior
from genjax_tpu_torch.io import check_meta_matches, load_segment_state, restore_pytree, save_pytree, save_segment_state
from torch_threads import _one_thread  # noqa: F401

ALGORITHMS = ["hmc", "nuts", "hmc_sweep"]


@g.gen
def model():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


OBS = g.C["y"].set(2.0)
KW = dict(n_chains=32, n_warmup=20, n_samples=12, eps0=0.3, L=3, max_depth=3, device="cpu")


def _run(algorithm, seed=7, **over):
    return sample_posterior(seed, model, OBS, (), g.S["mu"], **{**KW, "algorithm": algorithm, **over})


def _same(a, b):
    assert torch.equal(a["mu"], b["mu"])
    assert float(a.accept_rate) == float(b.accept_rate)
    assert float(a.divergence_rate) == float(b.divergence_rate)
    assert torch.equal(a.eps, b.eps) and torch.equal(a.inv_mass, b.inv_mass)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_segmentation_is_bitwise_invariant(algorithm):
    plain = _run(algorithm)
    with tempfile.TemporaryDirectory() as d:
        seg = _run(algorithm, checkpoint_dir=d, checkpoint_every=5)
    _same(plain, seg)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_interrupted_plus_resumed_is_bitwise_in_process(algorithm):
    plain = _run(algorithm)
    with tempfile.TemporaryDirectory() as d:
        partial = _run(algorithm, checkpoint_dir=d, checkpoint_every=4, max_segments=2)
        assert tuple(partial["mu"].shape) == (32, 8)
        meta = json.load(open(os.path.join(d, "meta.json")))
        assert meta["next_segment"] == 2 and meta["n_done"] == 8 and meta["state_dir"] == "state_2"
        resumed = _run(algorithm, checkpoint_dir=d, checkpoint_every=4)
        assert tuple(resumed["mu"].shape) == (32, 12)
    _same(plain, resumed)


def test_draw_seeds_differ_where_a_cpu_generator_reads_them():
    """The CPU generator keeps the low 32 bits of a seed: those of the draw
    seeds of 64 bases x 64 draws are all distinct."""
    low = {sample._draw_seed(base, s) & 0xFFFFFFFF for base in range(64) for s in range(64)}
    assert len(low) == 64 * 64
    assert all(0 <= sample._sweep_seed(base, s) < 2**30 for base in (0, 2**30 - 1) for s in (0, 1, 2**20))


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_the_same_traces_drawn_from_two_bases_differ(algorithm):
    """Two runs' base seeds give the same warmed traces different draws, so
    that replicate runs on the CPU are independent."""
    traces = sample._init_traces(torch.Generator().manual_seed(7), model, OBS, (), 32, torch.device("cpu"))
    eps, inv_mass = torch.tensor(0.3), torch.ones(1)

    def draws(base):
        draw_gen = torch.Generator()
        kw = dict(lo=0, hi=4, base=base, thin=1, eps=eps, inv_mass=inv_mass)
        if algorithm == "hmc_sweep":
            return sample._draw_sweep(draw_gen, traces, g.S["mu"], L=3, backend="auto", **kw)[1]
        step = sample._trace_step(draw_gen, g.S["mu"], algorithm, L=3, max_depth=3)
        return sample._draw(step, draw_gen, traces, g.S["mu"], **kw)[1]

    a, b = draws(1), draws(2)
    assert torch.equal(a, draws(1))
    for s in range(4):
        assert not torch.equal(a[:, s], b[:, s])


def test_a_callers_generator_ends_where_the_whole_run_leaves_it():
    whole = torch.Generator().manual_seed(3)
    plain = _run("hmc", seed=whole)
    with tempfile.TemporaryDirectory() as d:
        first = torch.Generator().manual_seed(3)
        _run("hmc", seed=first, checkpoint_dir=d, checkpoint_every=4, max_segments=1)
        again = torch.Generator().manual_seed(3)
        resumed = _run("hmc", seed=again, checkpoint_dir=d, checkpoint_every=4)
    _same(plain, resumed)
    assert torch.equal(whole.get_state(), again.get_state())


_FRESH = r"""
import sys
import numpy as np
import genjax_tpu_torch as g
from genjax_tpu_torch.inference.sample import sample_posterior

stage, d, out = sys.argv[1], sys.argv[2], sys.argv[3]

@g.gen
def model():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"

for algorithm in ("hmc", "nuts", "hmc_sweep"):
    kw = dict(n_chains=32, n_warmup=20, n_samples=12, eps0=0.3, L=3, max_depth=3, device="cpu",
              algorithm=algorithm, checkpoint_dir=d + "/" + algorithm, checkpoint_every=4)
    if stage == "partial":
        kw["max_segments"] = 2
    res = sample_posterior(7, model, g.C["y"].set(2.0), (), g.S["mu"], **kw)
    np.save(out + "_" + algorithm + ".npy", res["mu"].numpy())
print("STAGE_OK", stage)
"""


def test_interrupted_plus_resumed_is_bitwise_fresh_process():
    """The resume runs in a new process: only the checkpoint directory
    survives, as after a preemption."""
    plains = {a: _run(a)["mu"].numpy() for a in ALGORITHMS}
    with tempfile.TemporaryDirectory() as d:
        script = os.path.join(d, "stage.py")
        with open(script, "w") as f:
            f.write(_FRESH)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join([str(Path(__file__).parents[1]), env.get("PYTHONPATH", "")])
        for stage in ("partial", "resume"):
            proc = subprocess.run([sys.executable, script, stage, os.path.join(d, "ckpt"), os.path.join(d, stage)],
                                  capture_output=True, text=True, env=env, timeout=300)
            assert proc.returncode == 0, proc.stdout + proc.stderr
            assert f"STAGE_OK {stage}" in proc.stdout
        for a in ALGORITHMS:
            partial = np.load(os.path.join(d, f"partial_{a}.npy"))
            resumed = np.load(os.path.join(d, f"resume_{a}.npy"))
            assert partial.shape == (32, 8) and resumed.shape == (32, 12)
            assert np.array_equal(plains[a], resumed), a


def test_resume_refuses_mismatched_geometry():
    with tempfile.TemporaryDirectory() as d:
        _run("hmc", checkpoint_dir=d, checkpoint_every=4, max_segments=1)
        with pytest.raises(ValueError, match="refusing to resume"):
            _run("hmc", checkpoint_dir=d, checkpoint_every=4, n_samples=20)
        with pytest.raises(ValueError, match="refusing to resume"):
            _run("hmc", checkpoint_dir=d, checkpoint_every=4, n_chains=16)


@pytest.mark.parametrize("over", [dict(eps0=0.1), dict(seed=99), dict(algorithm="hmc_sweep"), dict(thin=2)])
def test_resume_refuses_different_dynamics(over):
    with tempfile.TemporaryDirectory() as d:
        _run("hmc", checkpoint_dir=d, checkpoint_every=4, max_segments=1)
        args = {"algorithm": "hmc", **over}
        with pytest.raises(ValueError, match="refusing to resume"):
            _run(args.pop("algorithm"), checkpoint_dir=d, checkpoint_every=4, **args)


@pytest.mark.parametrize("algorithm", ["chees", "pt", "dense_hmc", "dense_nuts"])
def test_column_algorithms_reject_checkpointing(algorithm):
    with pytest.raises(ValueError, match="trace-path"):
        _run(algorithm, checkpoint_dir="ckpt_never_written")
    assert not os.path.exists("ckpt_never_written")


@pytest.mark.parametrize("algorithm", ["hmc", "hmc_sweep"])
def test_crash_window_leaves_resumable_checkpoint(algorithm):
    """A crash while segment 3's state is written (a partial ``state_3``
    that the meta does not point at) does not spoil the checkpoint."""
    plain = _run(algorithm)
    with tempfile.TemporaryDirectory() as d:
        _run(algorithm, checkpoint_dir=d, checkpoint_every=4, max_segments=2)
        assert json.load(open(os.path.join(d, "meta.json")))["state_dir"] == "state_2"
        os.makedirs(os.path.join(d, "state_3"))
        with open(os.path.join(d, "state_3", "leaves.pt"), "w") as f:
            f.write("partial write")
        resumed = _run(algorithm, checkpoint_dir=d, checkpoint_every=4)
        assert sorted(n for n in os.listdir(d) if n.startswith("state_")) == ["state_3"]
    _same(plain, resumed)


def test_n_samples_zero_fails_fast_and_max_segments_zero_raises():
    with pytest.raises(ValueError, match="n_samples must be"):
        _run("hmc", n_samples=0)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(ValueError, match="no sampling segments ran"):
            _run("hmc", checkpoint_dir=d, checkpoint_every=4, max_segments=0)
        # the warmup's state was kept: the next call resumes after it
        assert json.load(open(os.path.join(d, "meta.json")))["next_segment"] == 0
        _same(_run("hmc"), _run("hmc", checkpoint_dir=d, checkpoint_every=4))


# ---- the checkpoint layer


def test_pytree_round_trip_of_a_trace_batch():
    trs = torch.func.vmap(lambda _: model.generate(torch.Generator().manual_seed(0), OBS, ())[0],
                          randomness="different")(torch.zeros(5))
    with tempfile.TemporaryDirectory() as d:
        save_pytree(os.path.join(d, "s"), {"traces": trs, "step": torch.tensor(3)})
        template = {"traces": model.generate(torch.Generator().manual_seed(1), OBS, ())[0], "step": torch.tensor(0)}
        with pytest.raises(ValueError, match="wrong template"):
            restore_pytree(os.path.join(d, "s"), template)
        zero = torch.func.vmap(lambda _: model.generate(torch.Generator().manual_seed(1), OBS, ())[0],
                               randomness="different")(torch.zeros(5))
        back = restore_pytree(os.path.join(d, "s"), {"traces": zero, "step": torch.tensor(0)})
    assert int(back["step"]) == 3
    assert torch.equal(back["traces"].get_choices()["mu"], trs.get_choices()["mu"])
    assert torch.equal(back["traces"].get_score(), trs.get_score())


def test_segment_state_protocol():
    with tempfile.TemporaryDirectory() as d:
        assert load_segment_state(d, lambda meta: None) is None
        for seg in (0, 1, 2):
            save_segment_state(d, {"x": torch.full((3,), float(seg))}, {"next_segment": seg, "who": "me"})
        assert sorted(os.listdir(d)) == ["meta.json", "state_2"]
        state, meta = load_segment_state(d, lambda meta: {"x": torch.zeros(3)})
        assert torch.equal(state["x"], torch.full((3,), 2.0)) and meta["who"] == "me"
        with pytest.raises(ValueError, match="refusing to resume"):
            check_meta_matches(d, meta, {"who": "you"})
        with pytest.raises(ValueError, match="refusing to resume"):
            check_meta_matches(d, meta, {"missing": 1})
        check_meta_matches(d, meta, {"who": "me", "next_segment": 2})


# ---- the increments: a save writes one segment's draws


def _tensor_bytes(tree) -> int:
    """The bytes of the storages under a tree's tensors, each storage once
    (views share one, and are saved once)."""
    from torch.utils._pytree import tree_leaves

    storages = {v.untyped_storage().data_ptr(): v.untyped_storage().nbytes()
                for v in tree_leaves(tree) if isinstance(v, torch.Tensor)}
    return sum(storages.values())


def _file_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(path) for f in files)


@pytest.mark.parametrize("algorithm", ["hmc", "hmc_sweep"])
def test_a_save_writes_one_segments_draws_and_the_state(algorithm):
    """Each save writes the state the next segment starts from and that
    segment's draws, accepts and divergences once: its bytes are theirs
    within 10%, the same at every segment, where the earlier layout
    rewrote every draw so far at each save."""
    n_chains, seg, n_samples, d = 2048, 4, 12, 1
    with tempfile.TemporaryDirectory() as dd:
        res = _run(algorithm, checkpoint_dir=dd, checkpoint_every=seg, n_chains=n_chains, n_samples=n_samples)
        names = sorted(os.listdir(dd))
        assert names == ["increment_0", "increment_1", "increment_2", "meta.json", "state_3"]
        increments = [_file_bytes(os.path.join(dd, f"increment_{i}")) for i in range(3)]
        state = _file_bytes(os.path.join(dd, "state_3"))
        inc_leaves = torch.load(os.path.join(dd, "increment_2", "leaves.pt"), weights_only=True)
        state_leaves = torch.load(os.path.join(dd, "state_3", "leaves.pt"), weights_only=True)
    # the increment is one segment's draws, accepts and divergences
    assert sorted(tuple(v.shape) for v in inc_leaves) == sorted([(n_chains, seg, d), (seg,), (seg,)])
    want_increment = 4 * (n_chains * seg * d + 2 * seg)
    assert _tensor_bytes(inc_leaves) == want_increment
    # the state holds no draw: traces, eps, inv_mass, base, generator state
    assert not [v for v in state_leaves if v is not None and v.dim() >= 2 and v.shape[1] == n_samples]
    want = want_increment + _tensor_bytes(state_leaves)
    assert abs(increments[-1] + state - want) <= 0.1 * want
    assert max(increments) == min(increments)
    assert tuple(res["mu"].shape) == (n_chains, n_samples)


def test_the_layout_that_saved_every_draw_is_refused():
    """A checkpoint of the earlier layout (every draw so far in each state,
    no ``layout`` in its meta) is refused by the run-identity check: no
    accepted run is left to resume from one."""
    with tempfile.TemporaryDirectory() as d:
        _run("hmc", checkpoint_dir=d, checkpoint_every=4, max_segments=1)
        meta_path = os.path.join(d, "meta.json")
        meta = json.load(open(meta_path))
        assert meta["layout"] == "increments"
        del meta["layout"]
        json.dump(meta, open(meta_path, "w"))
        with pytest.raises(ValueError, match="refusing to resume"):
            _run("hmc", checkpoint_dir=d, checkpoint_every=4)
