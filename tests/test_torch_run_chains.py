"""``ScaleRunner.run_chains`` and ``scale --chains`` on the CPU.

Ports of tests/test_scale.py's run_chains tests (``slow`` there; here at
fewer steps a cycle): the tempered chains climb above the start's
likelihood, keep distinct likelihoods after replica-exchange rounds, carry
their own nuisance parameters (the best chain's come back, with d_max
inside the band's coverage), and a checkpointed run resumed from its
ensemble npz equals the uninterrupted run bit for bit (every chain's
genome, parameters and likelihood, the generator's state, the metrics).
Each step of all chains is one B4 and one B2 call (the plain versions
here: the wrappers count no launch on the CPU). The CLI's ``scale
--chains N --t-max T`` writes the JAX command's outputs from the best
chain and ``chains_checkpoint.npz``, and ``--resume`` equals the
uninterrupted command.
"""

import os

import numpy as np
import pytest
import torch

from graal_tpu_torch import cli as tcli
from graal_tpu_torch import scale as tscale
from graal_tpu_torch.core.state import check_invariants
from graal_tpu_torch.ops import mini_grid_cuda, obsgrid_cuda
from graal_tpu_torch.utils.synthetic_sparse import (make_scale_genome, scale_params,
                                                    shuffle_genome, simulate_sparse_contacts)
import tests.test_torch_state  # noqa: F401  (one intra-op thread per test worker)


def problem(n_bins, seed, n_pieces):
    params = scale_params()
    state, table = make_scale_genome(n_bins, 4, seed=seed)
    sobs = simulate_sparse_contacts(state, table, params, seed=seed)
    return state, table, params, sobs, shuffle_genome(state, n_pieces, seed=seed + 1)


def count_calls(monkeypatch):
    """Count the plain B2 / B4 calls (what a launch is on the card)."""
    calls = {"mini": 0, "obs": 0}
    mini, obs = mini_grid_cuda.MiniGridScorer.plain, obsgrid_cuda.WindowObsGrid.plain

    def spy_mini(self, *a):
        calls["mini"] += 1
        return mini(self, *a)

    def spy_obs(self, *a):
        calls["obs"] += 1
        return obs(self, *a)

    monkeypatch.setattr(mini_grid_cuda.MiniGridScorer, "plain", spy_mini)
    monkeypatch.setattr(obsgrid_cuda.WindowObsGrid, "plain", spy_obs)
    return calls


def test_run_chains_climbs_and_keeps_chains_distinct(monkeypatch):
    state, table, params, sobs, shuf = problem(300, 21, 10)
    runner = tscale.ScaleRunner(table, sobs, params)
    ll0 = float(runner.anchor_fn()(shuf, params))
    calls = count_calls(monkeypatch)
    final, best_ll, m = runner.run_chains(shuf, n_chains=4, n_cycles=2, steps_per_cycle=48,
                                          f_max_min=64, f_max_cap=64, exchange_every=1,
                                          seed=3, progress=False)
    check_invariants(final)
    assert best_ll > ll0
    # one obs-grid and one mini-grid call a step for all four chains
    assert calls == {"mini": 2 * 48, "obs": 2 * 48}
    assert runner.mini_grid.n_launches == runner.obs_grid.n_launches == 0
    last = np.asarray(m["likelihood"][-1])
    assert last.shape == (4,) and not np.allclose(last, last.max())
    assert len(m["swaps"]) == 2 and len(m["best"]) == 2 and m["best"][-1] == best_ll
    assert m["f_max"] == [64, 64]
    # every chain's genome is its own after the swap rounds
    ids = runner.chain_states.id_c
    assert len({tuple(ids[c].tolist()) for c in range(4)}) == 4
    # the carried chains' likelihoods are their re-anchors
    want = runner.chains_anchor_fn()(runner.chain_states, params)
    assert torch.equal(torch.as_tensor(last), want)


def test_run_chains_sample_param():
    state, table, params, sobs, shuf = problem(240, 25, 8)
    runner = tscale.ScaleRunner(table, sobs, params)
    ll0 = float(runner.anchor_fn()(shuf, params))
    final, best_ll, m = runner.run_chains(shuf, n_chains=4, n_cycles=2, steps_per_cycle=40,
                                          f_max_min=64, f_max_cap=64, exchange_every=1,
                                          sample_param=True, seed=3, progress=False)
    check_invariants(final)
    assert best_ll > ll0
    assert float(m["params"].fact) > 0
    assert float(m["params"].d_max) <= runner.max_covered_d_max + 1e-3
    # the best chain's parameters score its genome to the returned likelihood
    assert float(runner.anchor_fn()(final, m["params"])) == best_ll


def test_run_chains_checkpoint_resume_bitexact(tmp_path):
    state, table, params, sobs, shuf = problem(160, 71, 6)
    kw = dict(n_chains=4, steps_per_cycle=32, f_max_min=64, f_max_cap=64, exchange_every=1,
              sample_param=True, seed=9, progress=False)
    full_path, part_path = str(tmp_path / "full.npz"), str(tmp_path / "part.npz")
    full, full_ll, m_full = tscale.ScaleRunner(table, sobs, params).run_chains(
        shuf, n_cycles=3, checkpoint_path=full_path, **kw)
    tscale.ScaleRunner(table, sobs, params).run_chains(shuf, n_cycles=1,
                                                       checkpoint_path=part_path, **kw)
    res, res_ll, m_res = tscale.ScaleRunner(table, sobs, params).run_chains(
        shuf, n_cycles=3, checkpoint_path=part_path, resume=True, **kw)
    for a, b in zip(full, res):
        assert torch.equal(a, b)
    assert res_ll == full_ll
    for k in ("likelihood", "best", "f_max", "swaps"):
        assert m_res[k] == m_full[k], k
    with np.load(full_path) as a, np.load(part_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "m_cycle_s":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("chains") / "ds")
    tcli.main(["simulate", d, "--bins", "96", "--contigs", "3", "--seed", "5"])
    return d


SCALE_OUTPUTS = ["0list_likelihood.txt", "0list_n_contigs.txt", "0list_dist_init_genome.txt",
                 "0list_overflow.txt", "0list_f_max.txt", "0list_fact.txt", "0list_slope.txt",
                 "0list_d_max.txt", "0list_d_nuc.txt", "genome.fasta", "info_frags.txt",
                 "chains_checkpoint.npz"]


def test_cli_scale_chains_and_resume(ds, tmp_path):
    def argv(out, cycles, *extra):
        return ["scale", ds, "--size", "3", "--level", "1", "--cycles", str(cycles),
                "--chains", "3", "--t-max", "4", "--steps-per-cycle", "40",
                "--f-max-min", "32", "--out", out, "--device", "cpu",
                "--fasta", os.path.join(ds, "genome.fa"), *extra]

    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    runner, final, m = tcli.execute(argv(full, 2))
    check_invariants(final)
    for f in SCALE_OUTPUTS:
        assert os.path.exists(os.path.join(full, f)), f
    best = np.loadtxt(os.path.join(full, "0list_likelihood.txt"))
    assert best.shape == (2,) and best[-1] == m["chains"]["best"][-1]
    assert len(np.loadtxt(os.path.join(full, "0list_f_max.txt"), ndmin=1)) == 2
    tcli.execute(argv(part, 1))
    _, res, _ = tcli.execute(argv(part, 2, "--resume"))
    for a, b in zip(final, res):
        assert torch.equal(a, b)
    with open(os.path.join(full, "genome.fasta")) as fa, \
            open(os.path.join(part, "genome.fasta")) as fb:
        assert fa.read() == fb.read()
    with np.load(os.path.join(full, "chains_checkpoint.npz")) as a, \
            np.load(os.path.join(part, "chains_checkpoint.npz")) as b:
        for k in a.files:
            if k != "m_cycle_s":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
