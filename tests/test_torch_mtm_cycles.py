"""Parity of the port's MTM / MH cycles with the JAX package
(graal_tpu_torch.core.mtm), and of the delta scorer with the MH catalogue.

- Dense MTM and MH cycles on shared draws (the Gumbel noise and acceptance
  uniforms split from the JAX key as ``make_mtm_cycle`` splits it): equal
  accept flags and contig counts, states bit-identical, likelihoods at
  rtol 1e-5; a Generator-driven cycle is deterministic.
- The delta scorer with the MH catalogue reproduces the full likelihood
  difference of each ``mh_candidates`` candidate (the JAX test's atol
  2e-2), and its mini candidates written back are the JAX candidates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graal_tpu.core import candidates as jc
from graal_tpu.core import likelihood as jl
from graal_tpu.core import mtm as jmtm
from graal_tpu.core import sparse as js
from graal_tpu_torch import convert
from graal_tpu_torch.core import candidates as tc
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import mtm as tmtm
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.core.state import check_invariants
from tests.test_mcmc import make_problem
from tests.test_torch_mtm import LL_RTOL, dense, jax_move_draws, t  # noqa: F401
from tests.test_torch_state import assert_states_equal, to_port


@pytest.mark.parametrize("variant", ["mtm", "mh"])
def test_dense_cycles_match_jax(dense, variant):
    d = dense
    n = d["state"].n_frags
    cycle_j = jmtm.make_mtm_cycle(d["table"], d["obs"], d["jump"], variant=variant)
    cycle_t = tmtm.make_mtm_cycle(d["tt"], d["obs"], d["tj"], variant=variant)
    n_slots = tmtm.n_move_slots(d["tj"])
    cur_j, cur_t = d["cur"], to_port(d["cur"])
    l_j = jnp.float32(d["l0"])
    l_t = torch.tensor(np.float32(d["l0"]))
    key = jax.random.key(1)
    for c in range(2):
        key, k1, k2 = jax.random.split(key, 3)
        order = jax.random.permutation(k1, n)
        cur_j, l_j, (lls_j, acc_j, ncs_j) = cycle_j(cur_j, k2, d["params"], order, l_j,
                                                    jnp.float32(1.0))
        gum, u = jax_move_draws(k2, n, n_slots)
        cur_t, l_t, (lls_t, acc_t, ncs_t) = cycle_t(cur_t, tmtm.MoveDraws(t(gum), t(u)),
                                                    d["tp"], t(order), l_t, 1.0)
        np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j), err_msg=str(c))
        np.testing.assert_array_equal(ncs_t.numpy(), np.asarray(ncs_j), err_msg=str(c))
        np.testing.assert_allclose(lls_t.numpy(), np.asarray(lls_j), rtol=LL_RTOL)
        assert_states_equal(cur_t, cur_j, f"cycle {c}")
    check_invariants(cur_t)
    assert float(l_t) > d["l0"]


def test_generator_cycle_deterministic(dense):
    d = dense
    n = d["state"].n_frags
    cycle = tmtm.make_mtm_cycle(d["tt"], d["obs"], d["tj"])
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(4)
        outs.append(cycle(to_port(d["cur"]), gen, d["tp"], torch.randperm(n, generator=gen),
                          torch.tensor(np.float32(d["l0"])), 1.0))
    assert all(torch.equal(a, b) for a, b in zip(outs[0][0], outs[1][0]))
    assert torch.equal(outs[0][1], outs[1][1])
    check_invariants(outs[0][0])


def test_delta_mh_catalogue_matches_full_difference():
    """tests/test_mtm.py::test_delta_mh_catalogue_matches_full_difference
    for the port's delta scorer with the MH catalogue, held to the JAX
    package's full likelihoods of mh_candidates."""
    state, table, params, obs = make_problem(seed=3, n=24)
    sobs = js.sparse_from_dense(obs)
    dsc = td.make_delta_scorer(convert.table_from_numpy(table._asdict()), None, 32,
                               sobs=convert.sparse_from_numpy(sobs._asdict()),
                               catalogue=tc.mh_candidates)
    tp = convert.params_from_numpy(params._asdict())
    obs_j = jnp.asarray(obs, jnp.float32)
    full = jax.jit(lambda s: jl.log_likelihood(s, table, obs_j, params))
    base = float(full(state))
    ts_ = to_port(state)
    for f_a, f_b in ((3, 4), (7, 15), (0, 23), (23, 0), (12, 12)):
        dll, cands, rows, valid, over = dsc(ts_, torch.tensor(f_a), torch.tensor(f_b), tp,
                                            ts_.id_c.amax())
        assert not bool(over)
        want_c = jc.mh_candidates(state, f_a, f_b)
        want = np.array([float(full(jax.tree.map(lambda x: x[i], want_c))) - base
                         for i in range(13)])
        np.testing.assert_allclose(dll.numpy(), want, atol=2e-2, err_msg=f"{f_a} {f_b}")
        for i in range(13):
            got, = td.drop_chain(td.scatter_mini(*td.lift_chain(
                ts_, TState(*[x[i] for x in cands]), rows, valid)))
            assert_states_equal(got, jax.tree.map(lambda x: x[i], want_c), f"{f_a} {f_b} {i}")

