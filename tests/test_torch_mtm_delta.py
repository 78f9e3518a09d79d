"""Parity of the port's delta-scored MTM / MH steps with the JAX package
(graal_tpu_torch.core.mtm), on a repeat-free table: the delta engine with
the MH catalogue, each neighbour on its own member rows (B4 + B2's plain
versions on the CPU).

Delta MTM and MH steps, ``corrected`` False and True, on shared draws
(tests/test_torch_mtm.py's bridge): decisions equal, states bit-identical,
the carried likelihood at rtol 1e-5; every committed state passes the
invariants. tests/test_torch_mtm_repeats.py and
tests/test_torch_mh_repeats.py run the same steps on a repeat table (the
repeat engine v2 with the MH catalogue).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jm
from graal_tpu.core import mtm as jmtm
from graal_tpu.core import sparse as js
from graal_tpu.utils.synthetic import (bin_level_matrix, default_params, make_genome,
                                       simulate_contacts)
from graal_tpu_torch import convert
from graal_tpu_torch.core import mtm as tmtm
from graal_tpu_torch.core.state import check_invariants
from tests.test_delta_repeats import _repeat_problem
from tests.test_torch_mtm import LL_RTOL, move_draws
from tests.test_torch_state import assert_states_equal, to_port

DELTA = 4
F_MAX = 24


def _walked(state, seed, n_moves=5):
    rng = np.random.default_rng(seed)
    n = state.n_frags
    apply = jax.jit(jm.apply_mutation)
    for _ in range(n_moves):
        state = apply(state, int(rng.integers(n)), int(rng.integers(n)), int(rng.integers(13)))
    return state


def _plain_problem():
    state, table = make_genome(n_bins=36, n_contigs=6, subs_per_bin=3, seed=4)
    params = default_params(fact=4000.0)
    obs = simulate_contacts(state, table, params, seed=4)
    n = state.n_frags
    jump = jmtm.build_jump_table(bin_level_matrix(obs, table), np.ones(n), np.arange(n), n,
                                 DELTA)
    return state, table, params, obs, jump


def _rep_problem():
    state, table, params, obs = _repeat_problem()
    n_bins = table.n_data_sub // 2
    bin_mat = np.asarray(obs).reshape(n_bins, 2, n_bins, 2).sum(axis=(1, 3))
    id_d = np.asarray(state.id_d)
    jump = jmtm.build_jump_table(bin_mat, np.full(n_bins, 2.0), id_d, state.n_frags, DELTA)
    return state, table, params, obs, jump


def delta_setup(kind):
    state, table, params, obs, jump = (_plain_problem if kind == "plain" else _rep_problem)()
    sobs = js.sparse_from_dense(obs)
    start = _walked(state, seed=8)
    return dict(kind=kind, state=state, start=start, table=table, params=params,
                sobs=sobs, jump=jump, ts=to_port(state),
                tt=convert.table_from_numpy(table._asdict()),
                tp=convert.params_from_numpy(params._asdict()),
                tsobs=convert.sparse_from_numpy(sobs._asdict()),
                tj=convert.jump_table_from_numpy(jump._asdict()),
                l0=float(jl.log_likelihood(start, table, obs, params)))


def check_delta_steps(p, variant, corrected):
    """10 delta steps of ``variant`` on ``p`` (a :func:`delta_setup`), the
    port against the JAX step on shared draws."""
    make_j = jmtm.make_delta_mtm_step if variant == "mtm" else jmtm.make_delta_mh_step
    make_t = tmtm.make_delta_mtm_step if variant == "mtm" else tmtm.make_delta_mh_step
    step_j = jax.jit(make_j(p["table"], p["jump"], F_MAX, p["sobs"], corrected=corrected))
    step_t = make_t(p["tt"], p["tj"], F_MAX, p["tsobs"], corrected=corrected,
                    rep=p["ts"].rep)
    n_slots = tmtm.n_move_slots(p["tj"])
    n = p["state"].n_frags
    cur = p["start"]
    l_j = jnp.float32(p["l0"])
    l_t = torch.tensor(np.float32(p["l0"]))
    key = jax.random.key(31 + 2 * corrected + (variant == "mh"))
    accepted = 0
    for f_a in np.random.default_rng(2).permutation(n)[:10]:
        key, sub = jax.random.split(key)
        new_j, l_j, acc_j, nc_j = step_j(cur, sub, p["params"], l_j, jnp.int32(f_a),
                                         jnp.float32(1.0))
        new_t, l_t, acc_t, nc_t = step_t(to_port(cur), move_draws(sub, n_slots), p["tp"], l_t,
                                         torch.tensor(int(f_a)), 1.0)
        msg = f"{p['kind']} {variant} corrected={corrected} f_a={f_a}"
        assert bool(acc_t) == bool(acc_j) and int(nc_t) == int(nc_j), msg
        assert_states_equal(new_t, new_j, msg)
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=LL_RTOL, err_msg=msg)
        check_invariants(new_t)
        accepted += bool(acc_t)
        cur = new_j
    assert accepted > 0


@pytest.fixture(scope="module")
def plain():
    return delta_setup("plain")


@pytest.mark.parametrize("corrected", [False, True])
@pytest.mark.parametrize("variant", ["mtm", "mh"])
def test_delta_steps_match_jax(plain, variant, corrected):
    check_delta_steps(plain, variant, corrected)
