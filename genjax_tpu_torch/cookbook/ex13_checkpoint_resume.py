"""Checkpoint and resume for long-running inference jobs.

Counterpart of ``examples/13_checkpoint_resume.py``. Two levels:

1. the wired-in driver: ``sample_posterior(checkpoint_dir=...,
   checkpoint_every=k)`` saves the sampler state after every segment of
   ``k`` draws (each segment's draws once, as an increment beside the
   state: the ``"increments"`` layout); called again with the same
   arguments after a preemption it resumes at the last saved segment and
   returns the uninterrupted run bit for bit, because every draw's stream
   is seeded from one base seed and the draw's index where the reference
   pre-splits a key a draw (``ROADMAP.md``, Deviations of the one-call
   driver and the NUTS trace path); ``max_segments`` bounds one call's
   work;
2. the manual primitive: ``save_pytree`` / ``restore_pytree`` on any chain
   state, for custom drivers.
"""

import shutil
import tempfile

import torch
import torch.utils._pytree as pytree

import genjax_tpu_torch as g
from genjax_tpu_torch.inference.sample import sample_posterior
from genjax_tpu_torch.io import restore_pytree, save_pytree

from ._common import batch, cli, device_of


@g.gen
def model():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


OBS = g.C["y"].set(2.0)
N_CHAINS = 128


def init_traces(seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return batch(lambda: model.generate(gen, OBS, ())[0], N_CHAINS, device)


def run_segment(seed, traces, n_steps=20):
    """``n_steps`` of HMC on every chain, from a stream seeded by ``seed``."""
    device = pytree.tree_leaves(traces)[0].device
    gen = torch.Generator(device=device).manual_seed(seed)
    step = torch.func.vmap(lambda t: g.mh(gen, t, g.HMC(g.S["mu"], 0.3, L=5)), randomness="different")
    accs = []
    for _ in range(n_steps):
        traces, acc = step(traces)
        accs.append(torch.mean(acc.to(torch.float32)))
    return traces, torch.mean(torch.stack(accs))


def driver_resume_demo(workdir, device):
    """The production path: preemption-safe ``sample_posterior``."""
    kw = dict(n_chains=64, n_warmup=30, n_samples=20, algorithm="hmc", eps0=0.3, L=3,
              checkpoint_dir=f"{workdir}/driver", checkpoint_every=5, device=device)
    # "preempted" run: the quota allowed only 2 of 4 segments
    partial = sample_posterior(11, model, OBS, (), g.S["mu"], **kw, max_segments=2)
    assert partial["mu"].shape[1] == 10  # 2 segments x 5 draws
    # later (a fresh process in real life): the same call resumes and completes
    full = sample_posterior(11, model, OBS, (), g.S["mu"], **kw)
    assert tuple(full["mu"].shape) == (64, 20)
    # and equals the never-interrupted run bit for bit
    uninterrupted = sample_posterior(11, model, OBS, (), g.S["mu"],
                                     **{k: v for k, v in kw.items() if k not in ("checkpoint_dir", "checkpoint_every")})
    assert torch.equal(full["mu"], uninterrupted["mu"])
    print("sample_posterior resume: bitwise continuation OK")


def main(device="cuda"):
    device = device_of(device)
    workdir = tempfile.mkdtemp(prefix="genjax_ckpt_")
    try:
        driver_resume_demo(workdir, device)
        # --- segment 1: run, then checkpoint the full chain state
        traces = init_traces(0, device)
        traces, _ = run_segment(1, traces)
        save_pytree(f"{workdir}/chains", traces)

        # --- segment 2a: continue in THIS process
        cont, _ = run_segment(2, traces)

        # --- segment 2b: "fresh process": rebuild the template from code,
        # restore the leaves, continue with the same stream
        template = init_traces(0, device)  # structure only
        restored = restore_pytree(f"{workdir}/chains", template)
        resumed, _ = run_segment(2, restored)

        # bit-exact resumption: the restored run reproduces the original
        for a, b in zip(pytree.tree_leaves(cont), pytree.tree_leaves(resumed)):
            assert torch.equal(a, b), "resume diverged from original"

        # and the chains are sampling the right posterior
        mus = resumed.get_choices()["mu"]
        assert abs(float(torch.mean(mus)) - 1.0) < 0.2
        print("checkpoint/resume cookbook: bit-exact resumption OK")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    cli(main)
