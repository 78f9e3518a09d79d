"""The dense repeat EM path of the port against the JAX package, on the CPU.

A small ``entry.repeat_problem`` (30 bins x 3 subs, 3 bins duplicated
once: K = 99 copy rows on S = 90 data subs, max_copies 2, so 13 x 10 = 130
candidates per step) runs through the port's EM step, nuisance step and
cycle with the copy-summing scorer (kernel B3's plain version on the CPU),
and through the JAX package's ``make_em_step`` / ``make_em_cycle`` (the jnp
copy-summing likelihood) on the same observed map, fed the same draws
(uniforms, Gumbel noise and nuisance draws split from the JAX key as the
JAX functions split it). Decisions and the int32 states must be
bit-identical; likelihoods agree at rtol 1e-5. The runs must commit moves
that involve a repeat copy, and a swap-activity (op 8).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jm
from graal_tpu.core.model import RippeParams
from graal_tpu_torch import entry as tentry
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.core.state import check_invariants
from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer
from tests.test_torch_mcmc import jax_cycle_draws, port_draws
from tests.test_torch_pipeline import _jax_repeat_problem
from tests.test_torch_state import assert_states_equal, to_port

LL_RTOL = 1e-5
SWAP_ACTIVITY = 8


@pytest.fixture(scope="module")
def problem():
    n_bins, n_contigs, n_dups, seed = 30, 3, 3, 4
    state, table, params, obs, nb = tentry.repeat_problem(n_bins, n_contigs, n_dups, seed=seed,
                                                          device="cpu")
    j_state, j_table, _ = _jax_repeat_problem(n_bins, n_contigs, n_dups, seed)
    # the neighbour tables are numpy-built on both sides (test_torch_pipeline
    # holds them equal); the JAX one is the port's, carried over
    j_nb = jm.NeighbourTable(**{f: jnp.asarray(getattr(nb, f).numpy())
                                for f in ("xk", "pk", "dispatcher", "blacklist")},
                             n_bins=nb.n_bins, max_copies=nb.max_copies)
    return dict(state=state, table=table, params=params, obs=obs, nb=nb,
                scorer=make_dense_scorer(table, obs, "cpu"),
                j_state=j_state, j_table=j_table, j_nb=j_nb)


def _jax_params(params):
    return RippeParams(*[jnp.float32(x) for x in params.astuple_np()])


def _committed(ops_, fa, fb, rep):
    """(moves involving a repeat copy, swap-activity moves that toggled a
    copy's activity) among committed steps."""
    done = ops_ >= 0
    with_rep = done & ((rep[fa] == 1) | (rep[np.clip(fb, 0, None)] == 1))
    return int(with_rep.sum()), int((with_rep & (ops_ == SWAP_ACTIVITY) & (rep[fa] == 1)).sum())


def test_em_steps_match_jax(problem):
    p = problem
    jp = _jax_params(p["params"])
    delta = tentry.DELTA
    step_j = jax.jit(jm.make_em_step(p["j_table"], p["obs"], p["j_nb"], delta))
    step_t = tm.make_em_step(p["table"], p["obs"], p["nb"], delta, scorer=p["scorer"])
    n_slots = tm.n_slots(p["nb"], delta)
    assert n_slots == 130
    n_top = p["nb"].pk.shape[1]
    rep = p["state"].rep.numpy()
    cur = jm.explode_genome(p["j_state"])
    key = jax.random.key(3)
    # the three copies, the originals of their bins, and ordinary fragments
    for f_a in (30, 31, 32, 5, 14, 24, 0, 7, 30, 31):
        key, k_step = jax.random.split(key)
        new_j, (score_j, op_j, fb_j) = step_j(cur, k_step, jp, jnp.int32(f_a),
                                              jnp.float32(1.0))
        k_nb, k_sel = jax.random.split(k_step)
        draws = tm.StepDraws(torch.as_tensor(np.array(jax.random.uniform(k_nb, (n_top,)))),
                             torch.as_tensor(np.array(jax.random.gumbel(k_sel, (n_slots,)))),
                             None, None, None)
        new_t, (score_t, op_t, fb_t) = step_t(to_port(cur), draws, p["params"],
                                              torch.tensor(f_a), 1.0)
        assert (int(op_t), int(fb_t)) == (int(op_j), int(fb_j)), f"f_a={f_a}"
        assert_states_equal(new_t, new_j, f"f_a={f_a}")
        np.testing.assert_allclose(float(score_t), float(score_j), rtol=LL_RTOL)
        cur = new_j
    assert rep[30] == rep[5] == 1


def test_em_cycles_match_jax(problem):
    p = problem
    jp = _jax_params(p["params"])
    delta = tentry.DELTA
    n = p["state"].n_frags
    scorer = p["scorer"]
    cycle_j = jm.make_em_cycle(p["j_table"], p["obs"], p["j_nb"], delta, sample_param=True)
    cycle_t = tm.make_em_cycle(p["table"], p["obs"], p["nb"], delta, sample_param=True,
                               scorer=scorer)
    n_slots = tm.n_slots(p["nb"], delta)
    n_top = p["nb"].pk.shape[1]
    cur_j = jm.explode_genome(p["j_state"])
    cur_t = tm.explode_genome(p["state"])
    l_j = jl.log_likelihood(cur_j, p["j_table"], p["obs"], jp)
    l_t = scorer(TState(*[x[None] for x in cur_t]), p["params"])[0]
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=LL_RTOL)
    par_j, par_t = jp, p["params"]
    rep = p["state"].rep.numpy()
    rng = np.random.default_rng(5)
    key = jax.random.key(17)
    with_rep = swaps = 0
    for c in range(2):
        key, k_cycle = jax.random.split(key)
        order = rng.permutation(n).astype(np.int32)
        cur_j, par_j, l_j, m_j = cycle_j(cur_j, k_cycle, par_j, jnp.asarray(order),
                                         l_j, jnp.float32(1.0))
        draws = port_draws(jax_cycle_draws(k_cycle, n, n_top, n_slots))
        cur_t, par_t, l_t, m_t = cycle_t(cur_t, draws, par_t, torch.as_tensor(order), l_t, 1.0)
        ops_ = m_t.op_sampled.numpy()
        np.testing.assert_array_equal(ops_, np.asarray(m_j.op_sampled), err_msg=f"cycle {c}")
        np.testing.assert_array_equal(m_t.id_f_sampled.numpy(), np.asarray(m_j.id_f_sampled))
        np.testing.assert_array_equal(m_t.success.numpy(), np.asarray(m_j.success))
        assert_states_equal(cur_t, cur_j, f"cycle {c}")
        np.testing.assert_allclose(m_t.likelihood.numpy(), np.asarray(m_j.likelihood),
                                   rtol=LL_RTOL)
        for f in jp._fields:
            np.testing.assert_allclose(float(getattr(par_t, f)), float(getattr(par_j, f)),
                                       rtol=LL_RTOL, err_msg=f)
        r, s = _committed(ops_, order, m_t.id_f_sampled.numpy(), rep)
        with_rep, swaps = with_rep + r, swaps + s
    check_invariants(cur_t)
    assert with_rep > 0, "no committed move involved a repeat copy"
    assert swaps > 0, "no committed swap-activity move"
    rescored = scorer(TState(*[x[None] for x in cur_t]), par_t)[0]
    assert rescored.item() == l_t.item()
    assert scorer.n_launches == 0
