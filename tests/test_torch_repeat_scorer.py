"""Parity of the copy-summing dense scorer (graal_tpu_torch.ops.repeat_cuda,
kernel B3's plain version) with the JAX package, on the CPU.

The repeat problem is tests/test_pallas.py's ``_repeat_problem`` (30 bins
x 2 subs, bins 3 and 11 duplicated once). Tolerances are the JAX tests':
- against ``make_repeat_pallas_scorer`` in the Pallas interpreter and
  against the jnp ``log_likelihood``: rtol 5e-4, atol 0.5
  (tests/test_pallas.py:149,161);
- against the f64 loop oracle ``log_likelihood_ref``: rtol 5e-5, atol 0.5.
Cases: the genome as it is, one copy deactivated, the exploded genome, and
a circularised contig holding a repeat copy (the original of bin 3).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jm
from graal_tpu.core import ops as jops
from graal_tpu.core.state import GenomeState as JState
from graal_tpu.ops import likelihood_pallas as lp
from graal_tpu_torch import convert
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.ops import likelihood_cuda as lc
from graal_tpu_torch.ops import repeat_cuda as rc
from tests.test_pallas import _repeat_problem
from tests.test_torch_state import to_port

RTOL, ATOL = 5e-4, 0.5
REF_RTOL, REF_ATOL = 5e-5, 0.5
CASES = ("as_is", "deactivated", "exploded", "circular")


def _variants(state):
    n = state.n_frags
    s = state.to_numpy()
    deact = state._replace(activ=jnp.asarray(np.where(np.arange(n) == n - 1, 0, s["activ"]),
                                             jnp.int32))
    members = np.nonzero(s["id_c"] == s["id_c"][3])[0]          # holds bin 3 (rep == 1)
    order = members[np.argsort(s["pos"][members])]
    circ = jops.paste(state, int(order[0]), int(order[-1]), int(np.max(s["id_c"])))
    assert int(np.asarray(circ.circ)[3]) == 1 and int(s["rep"][3]) == 1
    return dict(as_is=state, deactivated=deact, exploded=jm.explode_genome(state),
                circular=circ)


@pytest.fixture(scope="module")
def problem():
    state, table, params, obs = _repeat_problem()
    variants = _variants(state)
    batch = JState(*[jnp.stack(xs) for xs in zip(*[variants[c] for c in CASES])])
    pallas = np.asarray(lp.make_repeat_pallas_scorer(table, obs, interpret=True)(batch, params))
    tt = convert.table_from_numpy(table._asdict())
    tp = convert.params_from_numpy(params._asdict())
    scorer = lc.make_dense_scorer(tt, obs, "cpu")
    tbatch = TState(*[torch.stack(xs) for xs in zip(*[to_port(variants[c]) for c in CASES])])
    return dict(state=state, table=table, params=params, obs=obs, variants=variants,
                pallas=dict(zip(CASES, pallas)), tt=tt, tp=tp, scorer=scorer,
                tbatch=tbatch, got=dict(zip(CASES, scorer(tbatch, tp).numpy())))


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_and_jnp(problem, case):
    p = problem
    got = p["got"][case]
    want = float(jl.log_likelihood(p["variants"][case], p["table"], p["obs"], p["params"]))
    np.testing.assert_allclose(got, p["pallas"][case], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_f64_oracle(problem, case):
    p = problem
    ref = jl.log_likelihood_ref(p["variants"][case], p["table"], p["obs"], p["params"])
    np.testing.assert_allclose(p["got"][case], ref, rtol=REF_RTOL, atol=REF_ATOL)


def test_dispatch_through_make_dense_scorer(problem):
    p = problem
    scorer = p["scorer"]
    assert isinstance(scorer, rc.RepeatScorer)
    assert scorer.n_launches == 0                      # the CPU path never launches
    assert p["tt"].has_repeats and scorer.k == p["tt"].n_subs > scorer.s
    with pytest.raises(ValueError):                    # the kernel launch is CUDA-only
        scorer.launch(*scorer.sub_vectors(p["tbatch"]),
                      lc.params_vector(p["tp"], scorer.log_nfpb))
    with pytest.raises(ValueError):                    # the repeat-free scorer refuses
        lc.DenseScorer(p["tt"], p["obs"], "cpu")
    # a copy-free table still gets the repeat-free scorer
    from graal_tpu_torch.core.subfrags import trivial_table
    assert isinstance(lc.make_dense_scorer(trivial_table(np.full(6, 3000.0)),
                                           np.zeros((6, 6), np.float32), "cpu"),
                      lc.DenseScorer)


def test_batch_and_chunk_invariance(problem):
    p = problem
    scorer, batch = p["scorer"], p["tbatch"]
    vecs = scorer.sub_vectors(batch)
    pvec = lc.params_vector(p["tp"], scorer.log_nfpb)
    whole = scorer.plain(*vecs, pvec)
    chunked = scorer.plain(*vecs, pvec, max_cells=scorer.s * scorer.s)   # one genome a chunk
    np.testing.assert_array_equal(whole.numpy(), chunked.numpy())
    for i in range(batch.pos.shape[0]):
        alone = scorer(TState(*[x[i:i + 1] for x in batch]), p["tp"])
        assert alone.item() == whole[i].item()


def test_log_factorial_plane_bit_identical():
    rng = np.random.default_rng(0)
    ob = rng.poisson(6.0, (50, 50)).astype(np.float32)
    ob[0, :40] = np.arange(40)                         # every branch, 0 to 39
    np.testing.assert_array_equal(rc.log_factorial_np(ob), lp._log_factorial_np(ob))


def test_copy_vectors_follow_copy_order(problem):
    """The copy-order vectors put each data sub's copies at its CSR range,
    in row order, so the kernel's per-block runs are contiguous."""
    p = problem
    scorer = p["scorer"]
    data_id = p["tt"].data_id.numpy()
    start = scorer.copy_start.numpy()
    order = np.argsort(data_id, kind="stable")
    for s_ in (3 * 2, 3 * 2 + 1, 0, 59):
        rows = order[start[s_]:start[s_ + 1]]
        assert np.all(data_id[rows] == s_) and np.all(np.diff(rows) > 0)
    assert len(order[start[6]:start[7]]) == 2              # a duplicated sub: two copies
    assert scorer.max_blk == p["tt"].n_subs                 # one 64-sub block holds all
