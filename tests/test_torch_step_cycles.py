"""The EM and delta cycles against the JAX package, run again through
the step kernels' dispatch (``tests/test_torch_step_kernels.py`` holds the
public functions themselves).

On the CPU the dense EM cycle's neighbour draw, selection and commit and
nuisance move, and the delta cycle's draw and commit, take the plain
versions beside ``core.mcmc`` / ``core.delta``'s public functions (on a
card, kernels D1-D3 of ``csrc/step.cu``). On shared draws (split from the
JAX keys as the JAX cycles split them): a dense EM cycle with nuisance
sampling at f_t 0.8, decisions, accepts and states bit for bit,
parameters and likelihoods at rtol 1e-5; a delta cycle at f_max 8, so
that slots overflow, with the blacklisted fragment among its steps; and
the dense scorers' parameter row handed from the nuisance proposal to
the scorer (``CopyRowScorer.__call__(..., pvec=)``) giving the cycle the
scorer gives computing the row itself, bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import delta as jd
from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jm
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer
from tests.test_torch_delta import jax_delta_draws, walked_state
from tests.test_torch_mcmc import RTOL, assert_params_close, jax_cycle_draws, port_draws
from tests.test_torch_scan_io import route_to_card as route_scan_to_card
from tests.test_torch_state import assert_states_equal, to_port
from tests.test_torch_step_kernels import DELTA, dense, sparse, t  # noqa: F401  (fixtures)

DELTA_F_MAX = 8


@pytest.fixture(scope="module")
def dense_jax(dense):
    """The JAX dense EM cycle (nuisance sampling on, f_t 0.8) and its
    shared inputs, compiled and run once for this file's tests."""
    p = dense
    n = p["state"].n_frags
    cycle_j = jm.make_em_cycle(p["table"], p["obs"], p["nb"], DELTA, sample_param=True)
    n_slots = tm.n_slots(p["t_nb"], DELTA)
    cur_j = jm.explode_genome(p["state"])
    l_j = jl.log_likelihood(cur_j, p["table"], p["obs"], p["params"])
    order = np.random.default_rng(9).permutation(n).astype(np.int32)
    k_cycle = jax.random.key(41)
    out_j = cycle_j(cur_j, k_cycle, p["params"], jnp.asarray(order), l_j, jnp.float32(0.8))
    draws = port_draws(jax_cycle_draws(k_cycle, n, p["nb"].pk.shape[1], n_slots))
    return dict(cur_j=cur_j, l_j=l_j, order=order, out_j=out_j, draws=draws)


def check_dense_cycle(p, run):
    """The port's dense EM cycle on ``run``'s shared inputs against JAX's:
    decisions, accepts and states bit for bit."""
    n = p["state"].n_frags
    cycle_t = tm.make_em_cycle(p["t_table"], p["obs"], p["t_nb"], DELTA, sample_param=True)
    out_t = cycle_t(to_port(run["cur_j"]), run["draws"], p["t_params"],
                    torch.as_tensor(run["order"]), torch.tensor(np.float32(run["l_j"])), 0.8)
    out_j = run["out_j"]
    for f in ("op_sampled", "id_f_sampled", "n_contigs", "success"):
        np.testing.assert_array_equal(getattr(out_t[3], f).numpy(),
                                      np.asarray(getattr(out_j[3], f)), err_msg=f)
    assert_states_equal(out_t[0], out_j[0])
    assert_params_close(out_t[1], out_j[1])
    np.testing.assert_allclose(float(out_t[2]), float(out_j[2]), rtol=RTOL)
    assert 0 < int(out_t[3].success.sum()) < n


def test_dense_cycle_with_nuisance_matches_jax(dense, dense_jax):
    """A dense EM cycle, nuisance sampling on, f_t 0.8, against the JAX
    cycle on shared draws: decisions, accepts and states bit for bit."""
    check_dense_cycle(dense, dense_jax)


def test_dense_cycle_through_the_scan_kernels_matches_jax(dense, dense_jax, monkeypatch):
    """The same cycle with every step's loads and stores on the card's
    route (kernels H2 / H3's tables, run by ``tests/test_torch_scan_io``'s
    transcription): one load (H2) for the call and one step launch (H3: the
    stores and the next step's loads) a step."""
    spy = route_scan_to_card(monkeypatch)
    check_dense_cycle(dense, dense_jax)
    n = dense["state"].n_frags
    assert spy.launches.by_key() == {"load": 1, "store": n}


def test_parameter_row_reaches_the_dense_scorer(dense, monkeypatch):
    """The nuisance step hands a dense scorer the test set's parameter row
    (``pvec``): the cycle equals, bit for bit, the same cycle whose scorer
    computes the row itself."""
    p = dense
    scorer = make_dense_scorer(p["t_table"], p["obs"], "cpu")
    rows = []
    call = type(scorer).__call__

    def spy(self, states, params, pvec=None):
        rows.append(pvec)
        return call(self, states, params, pvec)

    monkeypatch.setattr(type(scorer), "__call__", spy)
    n = p["state"].n_frags
    gen = torch.Generator().manual_seed(3)
    draws = tm.draw_step_inputs(gen, p["t_nb"], DELTA, (n,))
    order = torch.randperm(n, generator=gen)
    start = tm.explode_genome(to_port(p["state"]))
    l0 = scorer(TState(*[x[None] for x in start]), p["t_params"])[0]
    outs = []
    for sc_ in (scorer, lambda s, par: scorer(s, par)):
        cycle = tm.make_em_cycle(p["t_table"], p["obs"], p["t_nb"], DELTA, sample_param=True,
                                 scorer=sc_)
        outs.append(cycle(start, draws, p["t_params"], order, l0, 1.0))
    with_row = [r for r in rows if r is not None]
    assert len(with_row) == n and all(r.shape == (10,) for r in with_row)
    (s1, p1, l1, m1), (s2, p2, l2, m2) = outs
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    assert all(torch.equal(a, b) for a, b in zip(p1, p2)) and torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(m1, m2))


@pytest.fixture(scope="module")
def delta_jax(sparse):
    """The JAX delta EM cycle at f_max 8 (slots overflow), the blacklisted
    fragment among its steps, and its shared inputs, run once."""
    p = sparse
    cycle_j = jd.make_delta_em_cycle(p["table"], None, p["nb"], DELTA, DELTA_F_MAX,
                                     sobs=p["sobs"], anchor_fn=False)
    cur_j = walked_state(p["state"], seed=2)
    order = np.concatenate([[9], np.random.default_rng(6).permutation(p["state"].n_frags)[:23]])
    order = order.astype(np.int32)
    key = jax.random.key(23)
    out_j = cycle_j(cur_j, key, p["params"], jnp.asarray(order), jnp.float32(-5000.0),
                    jnp.float32(0.9))
    u_nb, gum = jax_delta_draws(key, len(order), p["nb"].pk.shape[1], tm.n_slots(p["t_nb"],
                                                                                   DELTA))
    return dict(cur_j=cur_j, order=order, out_j=out_j,
                draws=tm.StepDraws(t(u_nb), t(gum), None, None, None))


def check_delta_cycle(p, run):
    cycle_t = td.make_delta_em_cycle(p["t_table"], None, p["t_nb"], DELTA, DELTA_F_MAX,
                                     sobs=p["t_sobs"], anchor_fn=False)
    cur_j2, l_j2, out_j = run["out_j"]
    cur_t, l_t, out_t = cycle_t(to_port(run["cur_j"]), run["draws"], p["t_params"],
                                torch.as_tensor(run["order"]), torch.tensor(-5000.0), 0.9)
    for name, g, w in zip(("ops", "fbs", "overs", "ncs"), out_t[1:], out_j[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(out_t[1][0]) == -1 and int(out_t[3].sum()) > 0
    assert_states_equal(cur_t, cur_j2)
    np.testing.assert_allclose(float(l_t), float(l_j2), rtol=RTOL)


def test_delta_cycle_with_overflow_matches_jax(sparse, delta_jax):
    """A sparse delta cycle at f_max 8 (slots overflow), the blacklisted
    fragment among the steps, against the JAX cycle on shared draws."""
    check_delta_cycle(sparse, delta_jax)


def test_delta_cycle_through_the_scan_kernels_matches_jax(sparse, delta_jax, monkeypatch):
    """The same delta cycle with every step's loads and stores on the
    card's route (H2 / H3's tables transcribed): one load for the call and
    one step launch a step."""
    spy = route_scan_to_card(monkeypatch)
    check_delta_cycle(sparse, delta_jax)
    steps = len(delta_jax["order"])
    assert spy.launches.by_key() == {"load": 1, "store": steps}
