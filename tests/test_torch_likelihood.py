"""Parity of graal_tpu_torch.core.likelihood and of the dense scorer
(graal_tpu_torch.ops.likelihood_cuda) with the JAX package, on the CPU.

Tolerances:
- ``log_likelihood``: rtol 1e-5 against the JAX jnp implementation (the
  same f32 per-cell math; libm paths and summation order differ by ulps).
- the scorer's plain version: rtol 1e-4 against ``make_pallas_scorer``
  run in the Pallas interpreter and against ``log_likelihood`` (log-space
  math vs the direct pmf: the bench's standard, bench.py:59).
- ``log_likelihood_ref`` (f64 loop oracle): rtol 5e-5, atol 0.5, as
  tests/test_parity.py holds the JAX package.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jmcmc
from graal_tpu.core import ops as jops
from graal_tpu.core.state import GenomeState as JState
from graal_tpu.ops import likelihood_pallas as lp
from graal_tpu.utils.synthetic import default_params, make_genome, simulate_contacts
from graal_tpu_torch import convert
from graal_tpu_torch.core import likelihood as tl
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.ops import likelihood_cuda as lc
from tests.test_torch_state import to_port

LL_RTOL = 1e-5
SCORER_RTOL = 1e-4


@pytest.fixture(scope="module")
def problem():
    state, table = make_genome(n_bins=40, n_contigs=4, subs_per_bin=3, seed=3)
    params = default_params(fact=5000.0)
    obs = simulate_contacts(state, table, params, seed=3)
    return state, table, params, obs


def port_problem(state, table, params):
    return (to_port(state), convert.table_from_numpy(table._asdict()),
            convert.params_from_numpy(params._asdict()))


def circularised(state):
    """Contig 0 circularised by pasting its two ends (tests/test_pallas.py)."""
    s = state.to_numpy()
    members = np.nonzero(s["id_c"] == 0)[0]
    order = members[np.argsort(s["pos"][members])]
    out = jops.paste(state, int(order[0]), int(order[-1]),
                     int(np.max(s["id_c"])))
    assert int(np.asarray(out.circ)[order[0]]) == 1
    return out


def variants(state):
    """The scorer variants of tests/test_pallas.py:41-73."""
    return [
        state,
        jmcmc.explode_genome(state),
        jops.flip(state, 7),
        jops.pop_out(state, 11, int(np.max(np.asarray(state.id_c)))),
        jops.paste(jops.split(state, 20, 1, 50), 3, 30, 99),
        circularised(state),
    ]


def stack_port(states):
    return TState(*[torch.stack(xs) for xs in zip(*[to_port(s) for s in states])])


def test_log_likelihood_matches_jax(problem):
    state, table, params, obs = problem
    _, tt, tp = port_problem(state, table, params)
    obs_t = torch.as_tensor(obs)
    vs = variants(state)
    want = np.asarray([float(jl.log_likelihood(v, table, obs, params)) for v in vs])
    single = np.asarray([float(tl.log_likelihood(to_port(v), tt, obs_t, tp))
                         for v in vs])
    batched = tl.log_likelihood(stack_port(vs), tt, obs_t, tp).numpy()
    np.testing.assert_allclose(single, want, rtol=LL_RTOL)
    np.testing.assert_allclose(batched, want, rtol=LL_RTOL)
    np.testing.assert_allclose(
        tl.sub_frag_midpoints(to_port(vs[2]), tt).numpy(),
        np.asarray(jl.sub_frag_midpoints(vs[2], table)), rtol=0, atol=0)


def _repeat_problem():
    from tests.test_pallas import _repeat_problem as rp
    return rp(seed=9, n_bins=16, dup_bins=(3, 11))


def test_expected_data_matrix_with_repeats():
    state, table, params, obs = _repeat_problem()
    ts, tt, tp = port_problem(state, table, params)
    assert tt.has_repeats
    deact = state._replace(activ=state.activ.at[-1].set(0))
    for s in (state, deact, jmcmc.explode_genome(state)):
        np.testing.assert_allclose(
            tl.expected_data_matrix(to_port(s), tt, tp).numpy(),
            np.asarray(jl.expected_data_matrix(s, table, params)), rtol=LL_RTOL)
        np.testing.assert_allclose(
            float(tl.log_likelihood(to_port(s), tt, torch.as_tensor(obs), tp)),
            float(jl.log_likelihood(s, table, obs, params)), rtol=LL_RTOL)


def test_log_likelihood_ref_oracle():
    state, table = make_genome(n_bins=14, n_contigs=3, subs_per_bin=2, seed=5)
    params = default_params(fact=5000.0)
    obs = simulate_contacts(state, table, params, seed=5)
    _, tt, tp = port_problem(state, table, params)
    for s in (state, jmcmc.explode_genome(state), circularised(state)):
        ref_t = tl.log_likelihood_ref(to_port(s), tt, obs, tp)
        ref_j = jl.log_likelihood_ref(s, table, obs, params)
        np.testing.assert_allclose(ref_t, ref_j, rtol=1e-12)
        got = float(tl.log_likelihood(to_port(s), tt, torch.as_tensor(obs), tp))
        np.testing.assert_allclose(got, ref_t, rtol=5e-5, atol=0.5)


def test_plain_scorer_matches_pallas_and_jnp(problem):
    state, table, params, obs = problem
    _, tt, tp = port_problem(state, table, params)
    vs = variants(state)
    jbatch = JState(*[jnp.stack(xs) for xs in zip(*vs)])
    pallas = np.asarray(lp.make_pallas_scorer(table, obs, interpret=True)(jbatch, params))
    jnp_ll = np.asarray([float(jl.log_likelihood(v, table, obs, params)) for v in vs])
    scorer = lc.make_dense_scorer(tt, obs, "cpu")
    got = scorer(stack_port(vs), tp).numpy()
    assert got.dtype == np.float32 and got.shape == (len(vs),)
    np.testing.assert_allclose(got, pallas, rtol=SCORER_RTOL)
    np.testing.assert_allclose(got, jnp_ll, rtol=SCORER_RTOL)
    assert scorer.n_launches == 0        # the CPU path never launches


def test_plain_scorer_is_batch_and_chunk_invariant(problem):
    state, table, params, obs = problem
    _, tt, tp = port_problem(state, table, params)
    scorer = lc.make_dense_scorer(tt, obs, "cpu")
    batch = stack_port(variants(state))
    vecs = scorer.sub_vectors(batch)
    pvec = lc.params_vector(tp, scorer.log_nfpb)
    whole = lc.score_dense_plain(*vecs, scorer.la, scorer.obs, pvec,
                                 scorer.obs_const)
    k = tt.n_subs
    chunked = lc.score_dense_plain(*vecs, scorer.la, scorer.obs, pvec,
                                   scorer.obs_const, max_cells=2 * k * k)
    np.testing.assert_array_equal(whole.numpy(), chunked.numpy())
    for i in range(batch.pos.shape[0]):
        alone = scorer(TState(*[x[i:i + 1] for x in batch]), tp)
        assert alone.item() == whole[i].item()


def test_obs_constant_matches_pallas(problem):
    obs = problem[3]
    assert lc.obs_constant(obs) == lp.obs_constant(obs)


def test_scorer_guards(problem):
    state, table, params, obs = problem
    ts, tt, tp = port_problem(state, table, params)
    scorer = lc.make_dense_scorer(tt, obs, "cpu")
    one = TState(*[x[None] for x in ts])
    with pytest.raises(ValueError):        # unbatched state
        scorer(ts, tp)
    with pytest.raises(ValueError):        # wrong dtype
        scorer(one._replace(pos=one.pos.long()), tp)
    with pytest.raises(ValueError):        # the kernel launch is CUDA-only
        scorer.launch(*scorer.sub_vectors(one),
                      lc.params_vector(tp, scorer.log_nfpb))
    # a repeat table is never scored by the repeat-free math: the repeat-free
    # scorer refuses it, and make_dense_scorer dispatches it to the
    # copy-summing scorer (kernel B3), whose CPU path is its plain version
    rstate, rtable, rparams, robs = _repeat_problem()
    rts, rtt, rtp = port_problem(rstate, rtable, rparams)
    with pytest.raises(ValueError, match="copy-summing"):
        lc.DenseScorer(rtt, robs, "cpu")
    rscorer = lc.make_dense_scorer(rtt, robs, "cpu")
    assert type(rscorer).__name__ == "RepeatScorer"
    got = rscorer(TState(*[x[None] for x in rts]), rtp)[0].item()
    want = float(jl.log_likelihood(rstate, rtable, robs, rparams))
    np.testing.assert_allclose(got, want, rtol=SCORER_RTOL)
    assert rscorer.n_launches == 0
