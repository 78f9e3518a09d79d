"""Parity of graal_tpu_torch.core.model_hic (the broken-power-law contact
model) with the JAX package.

- ``hic_contacts`` at rtol 1e-6 (f32 ``pow`` of XLA-CPU and torch), on
  every segment, the breakpoints and the clamps.
- The host fit (``peval``, ``estimate_param_hic``,
  ``estimate_max_dist_intra``, ``fit_hic_from_matrix``) is the JAX
  package's numpy / scipy code and must give its numbers exactly.
- ``log_likelihood_hic`` and the batched, chunked scorer at rtol 1e-5.
- EM cycles under the HiC scorer on shared draws (tests/test_torch_mcmc.py's
  bridge) commit the JAX cycle's mutations; the likelihood at rtol 1e-5.
- ``Runner`` with ``use_rippe = False``: the JAX Runner's parameters,
  nuisance sampling off, the HiC scorer (no kernel scorer), a run that
  climbs, and the JAX package's ``params.json``; delta scoring refuses
  the model.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import mcmc as jm
from graal_tpu.core import model_hic as jh
from graal_tpu.core.subfrags import trivial_table
from graal_tpu_torch import convert
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core import model_hic as th
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.core.state import check_invariants
from tests.test_mcmc import true_genome
from tests.test_torch_mcmc import jax_cycle_draws, port_draws
from tests.test_torch_state import assert_states_equal, to_port

LL_RTOL = 1e-5
FIT = [20.0, 300.0, -1.0, -1.5, -2.5, 100.0]


def make_params(**kw):
    d = dict(d0=20.0, d1=300.0, alpha_0=-1.0, alpha_1=-1.5, alpha_2=-2.5, fact=100.0,
             d_max=800.0, v_inter=0.01)
    d.update(kw)
    return jh.HiCParams.create(**d)


def test_hic_contacts_match():
    p = make_params()
    tp = convert.hic_params_from_numpy(p._asdict())
    s = np.concatenate([np.linspace(-5.0, 1000.0, 2001), [0.0, 20.0, 300.0, 799.99, 800.0],
                        np.geomspace(1e-6, 5e3, 500)]).astype(np.float32)
    want = np.asarray(jh.hic_contacts(s, p))
    got = th.hic_contacts(torch.as_tensor(s), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(tp.slope) == float(p.slope) == float(p.alpha_1)


def test_host_fit_matches_exactly():
    true = [25.0, 250.0, -0.8, -1.4, -2.2, 150.0]
    bins = np.arange(3.0, 600.0, 3.0)
    y = jh.peval(bins, true)
    np.testing.assert_array_equal(th.peval(bins, true), y)
    fit_j, est_j = jh.estimate_param_hic(y, bins)
    fit_t, est_t = th.estimate_param_hic(y, bins)
    assert fit_t == fit_j
    np.testing.assert_array_equal(est_t, est_j)
    for v in (0.05, 0.01, 1e-4):
        assert th.estimate_max_dist_intra(FIT, v) == jh.estimate_max_dist_intra(FIT, v)


@pytest.fixture(scope="module")
def hic_problem():
    """tests/test_model_hic.py's EM problem: contacts drawn from the model."""
    n = 16
    state = true_genome(n, len_bp=3000)
    table = trivial_table(np.asarray(state.len_bp))
    params = make_params(fact=3000.0, d_max=900.0, v_inter=0.1)
    rng = np.random.default_rng(0)
    mid = np.asarray(state.start_bp) / 1000.0 + np.asarray(state.len_bp) / 2000.0
    s = np.abs(mid[:, None] - mid[None, :])
    same = np.asarray(state.id_c)[:, None] == np.asarray(state.id_c)[None, :]
    e = np.where(same, np.asarray(jh.hic_contacts(s.astype(np.float32), params)), 0.1)
    obs = rng.poisson(np.maximum(np.triu(e, 1), 0)).astype(np.float32)
    obs = obs + obs.T
    return dict(state=state, table=table, params=params, obs=obs,
                tt=convert.table_from_numpy(table._asdict()),
                tp=convert.hic_params_from_numpy(params._asdict()))


def test_fit_from_matrix_matches_exactly(hic_problem):
    p = hic_problem
    soa = {f: np.asarray(getattr(p["state"], f)) for f in ("id_c", "start_bp", "len_bp",
                                                           "pos")}
    want = jh.fit_hic_from_matrix(p["obs"], soa, 0.1, 40.0, 3.0)
    got = th.fit_hic_from_matrix(p["obs"], soa, 0.1, 40.0, 3.0)
    for f, a, b in zip(want._fields, got, want):
        assert float(a) == float(b), f


def test_log_likelihood_and_scorer_match(hic_problem):
    p = hic_problem
    rng = np.random.default_rng(2)
    states = [p["state"], jm.explode_genome(p["state"])]
    for _ in range(6):
        st = states[-1]
        states.append(jm.apply_mutation(st, int(rng.integers(16)), int(rng.integers(16)),
                                        int(rng.integers(13))))
    want = np.array([float(jh.log_likelihood_hic(s, p["table"], p["obs"], p["params"]))
                     for s in states])
    batch = TState(*[torch.stack(xs) for xs in zip(*[to_port(s) for s in states])])
    one = np.array([float(th.log_likelihood_hic(to_port(s), p["tt"], p["obs"], p["tp"]))
                    for s in states])
    np.testing.assert_allclose(one, want, rtol=LL_RTOL)
    for max_cells in (th.MAX_CELLS, 3 * 16 * 16):      # one chunk, chunks of 3
        scorer = th.make_hic_scorer(p["tt"], p["obs"], max_cells=max_cells)
        got = scorer(batch, p["tp"]).numpy()
        np.testing.assert_allclose(got, want, rtol=LL_RTOL)
        np.testing.assert_array_equal(got, one.astype(np.float32))


def test_em_cycles_under_hic_match_jax(hic_problem):
    """tests/test_model_hic.py::test_em_assembles_under_hic_model on shared
    draws: the same mutations, states bit for bit."""
    p = hic_problem
    n = 16
    nb = jm.build_neighbour_table(p["obs"], np.arange(n), n)
    tnb = convert.neighbour_table_from_numpy(nb._asdict())
    cycle_j = jm.make_em_cycle(p["table"], p["obs"], nb, delta=4, sample_param=False,
                               scorer=jh.make_hic_scorer(p["table"], p["obs"]))
    cycle_t = tm.make_em_cycle(p["tt"], p["obs"], tnb, delta=4, sample_param=False,
                               scorer=th.make_hic_scorer(p["tt"], p["obs"]))
    cur_j = jm.explode_genome(p["state"])
    cur_t = to_port(cur_j)
    ll0 = float(jh.log_likelihood_hic(cur_j, p["table"], p["obs"], p["params"]))
    ll_true = float(jh.log_likelihood_hic(p["state"], p["table"], p["obs"], p["params"]))
    l_j = jnp.float32(ll0)
    l_t = torch.tensor(np.float32(ll0))
    key = jax.random.key(0)
    for j in range(4):
        key, k1, k2 = jax.random.split(key, 3)
        order = jax.random.permutation(k1, n)
        cur_j, _, l_j, m_j = cycle_j(cur_j, k2, p["params"], order, l_j, jnp.float32(1.0))
        draws = port_draws(jax_cycle_draws(k2, n, nb.pk.shape[1], tm.n_slots(tnb, 4)))
        cur_t, par_t, l_t, m_t = cycle_t(cur_t, draws, p["tp"], torch.as_tensor(
            np.array(order)), l_t, 1.0)
        np.testing.assert_array_equal(m_t.op_sampled.numpy(), np.asarray(m_j.op_sampled))
        np.testing.assert_array_equal(m_t.id_f_sampled.numpy(), np.asarray(m_j.id_f_sampled))
        np.testing.assert_allclose(m_t.likelihood.numpy(), np.asarray(m_j.likelihood),
                                   rtol=LL_RTOL)
        assert_states_equal(cur_t, cur_j, f"cycle {j}")
        assert par_t is p["tp"]
    check_invariants(cur_t)
    assert float(l_t) > ll0 + 0.8 * (ll_true - ll0)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from graal_tpu_torch import cli as tcli

    d = str(tmp_path_factory.mktemp("hic") / "ds")
    assert tcli.main(["simulate", d, "--bins", "96", "--contigs", "3", "--seed", "5"]) == 0
    return d


def test_runner_under_hic_model(dataset, tmp_path):
    from graal_tpu.config import RunConfig as JConfig
    from graal_tpu.pipeline import Runner as JRunner
    from graal_tpu_torch.config import RunConfig
    from graal_tpu_torch.ops.likelihood_cuda import CopyRowScorer
    from graal_tpu_torch.pipeline import Runner

    jcfg = JConfig(dataset_dir=dataset, output_dir=str(tmp_path / "jax"), platform="cpu")
    jcfg.pyramid.size, jcfg.sampler.level, jcfg.model.use_rippe = 3, 1, False
    jcfg.sampler.n_cycles = 1
    jr = JRunner(jcfg)
    cfg = RunConfig(dataset_dir=dataset, output_dir=str(tmp_path / "port"), device="cpu")
    cfg.pyramid.size, cfg.sampler.level, cfg.model.use_rippe = 3, 1, False
    cfg.sampler.n_cycles = 2
    r = Runner(cfg)
    assert isinstance(r.params, th.HiCParams) and r.is_hic
    for f, a, b in zip(jr.params._fields, r.params, jr.params):
        assert float(a) == float(b), f
    assert not r.sample_param and cfg.sampler.sample_param
    assert not isinstance(r.scorer, CopyRowScorer)
    asm = r.run_em(progress=False)
    check_invariants(asm.state)
    lik = asm.metrics["likelihood"]
    assert lik[-1] > lik[0]
    assert len(set(asm.metrics["fact"])) == 1          # nuisance sampling is off
    assert set(asm.metrics["slope"]) == {float(r.params.alpha_1)}
    r.save_behaviour(asm)
    jr.save_behaviour(jr.run_em(progress=False))
    with open(os.path.join(cfg.output_dir, "params.json")) as a, \
            open(os.path.join(jcfg.output_dir, "params.json")) as b:
        assert json.load(a) == json.load(b)
    # resume keeps the model's parameter type
    r2 = Runner(cfg)
    asm2 = r2.run_em(progress=False, resume=True)
    assert isinstance(asm2.params, th.HiCParams)
    with pytest.raises(ValueError, match="HiC"):
        r.run_em(scoring="delta", progress=False)
