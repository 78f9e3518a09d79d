"""The MTM / MH step kernels' public functions (E1-E3) against the JAX
package through delta steps at the edges and a dense step on a repeat
table (``tests/test_torch_mtm_kernels.py``'s companion; the files split so
that each stays within a tier-1 worker's minute).

On the CPU the public functions take their plain versions. On shared
draws (split from the JAX keys as ``tests/test_torch_mtm.py`` splits them):
delta MTM (``corrected=True``) and MH steps at f_max 8 from one laid-out
genome, a pivot whose every forward neighbour overflows f_max (rejected),
a circular contig's ends, a pivot among singletons, accept and reject; and
dense MTM steps on a copy-expanded table with pivots among the repeat
copies. States, accept flags and contig counts bit for bit, likelihoods at
rtol 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import likelihood as jl
from graal_tpu.core import mtm as jmtm
from graal_tpu_torch import convert
from graal_tpu_torch.core import mtm as tmtm
from graal_tpu_torch.core.delta import extract_rows_each
from graal_tpu_torch.core.state import check_invariants
from tests.test_delta_repeats import _repeat_problem
from tests.test_torch_mtm import LL_RTOL, move_draws
from tests.test_torch_mtm_delta import _walked
from tests.test_torch_mtm_kernels import DELTA, F_MAX_SMALL, sparse  # noqa: F401  (fixture)
from tests.test_torch_state import assert_states_equal, to_port


def test_dense_mtm_on_a_repeat_table_matches_jax():
    """Dense MTM steps on a copy-expanded table, pivots among the repeat
    copies, against the JAX step on shared draws."""
    state, table, params, obs = _repeat_problem()
    n_bins = table.n_data_sub // 2
    bin_mat = np.asarray(obs).reshape(n_bins, 2, n_bins, 2).sum(axis=(1, 3))
    id_d = np.asarray(state.id_d)
    jump = jmtm.build_jump_table(bin_mat, np.full(n_bins, 2.0), id_d, state.n_frags, DELTA)
    cur = _walked(state, seed=3)
    step_j = jax.jit(jmtm.make_mtm_step(table, obs, jump))
    tj = convert.jump_table_from_numpy(jump._asdict())
    step_t = tmtm.make_mtm_step(convert.table_from_numpy(table._asdict()), obs, tj)
    tp = convert.params_from_numpy(params._asdict())
    l_j = jl.log_likelihood(cur, table, obs, params)
    l_t = torch.tensor(np.float32(l_j))
    copies = np.nonzero(np.asarray(state.rep) == 1)[0]
    key = jax.random.key(80)
    accepted = 0
    for f_a in list(copies[:4]) + [0, 7, 20]:
        key, sub = jax.random.split(key)
        new_j, l_j, acc_j, nc_j = step_j(cur, sub, params, l_j, jnp.int32(f_a), jnp.float32(1.0))
        new_t, l_t, acc_t, nc_t = step_t(to_port(cur), move_draws(sub, tmtm.n_move_slots(tj)),
                                         tp, l_t, torch.tensor(int(f_a)), 1.0)
        assert bool(acc_t) == bool(acc_j) and int(nc_t) == int(nc_j), f_a
        assert_states_equal(new_t, new_j, str(f_a))
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=LL_RTOL)
        accepted += bool(acc_t)
        cur = new_j
    assert accepted > 0


# ---------------------------------------------------------------------------
# E2 and E3 through delta steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant, corrected", [("mtm", True), ("mh", False)])
def test_delta_steps_at_the_edges_match_jax(sparse, variant, corrected):
    """Delta steps at f_max 8 from one genome (:func:`sparse`): the
    all-overflow pivot, the circular contig's ends, the singletons' pivot
    and others, against the JAX step on shared draws.
    (tests/test_torch_mtm_delta.py holds both variants at both settings of
    ``corrected``, walking at f_max 24.)"""
    p = sparse
    make_j = jmtm.make_delta_mtm_step if variant == "mtm" else jmtm.make_delta_mh_step
    make_t = tmtm.make_delta_mtm_step if variant == "mtm" else tmtm.make_delta_mh_step
    step_j = jax.jit(make_j(p["table"], p["jump"], F_MAX_SMALL, p["sobs"], corrected=corrected))
    step_t = make_t(p["tt"], p["tj"], F_MAX_SMALL, p["tsobs"], corrected=corrected)
    n_slots = tmtm.n_move_slots(p["tj"])
    cur, ts_ = p["start"], p["ts"]
    l_j = jnp.float32(p["l0"])
    l_t = torch.tensor(np.float32(p["l0"]))
    key = jax.random.key(90 + corrected)
    seen = dict(accept=0, reject=0, all_over=0)
    for f_a in [24, 12, 17, 25, 25, 25, 26, 20, 5, 0, 11]:
        key, sub = jax.random.split(key)
        ids = tmtm.move_set(ts_, torch.tensor(f_a), p["tj"], torch.tensor(f_a))[0]
        over = extract_rows_each(ts_, torch.tensor(f_a), ids, F_MAX_SMALL)[2]
        new_j, l_j2, acc_j, nc_j = step_j(cur, sub, p["params"], l_j, jnp.int32(f_a),
                                          jnp.float32(1.0))
        new_t, l_t2, acc_t, nc_t = step_t(ts_, move_draws(sub, n_slots), p["tp"], l_t,
                                          torch.tensor(f_a), 1.0)
        msg = f"{variant} corrected={corrected} f_a={f_a}"
        assert bool(acc_t) == bool(acc_j) and int(nc_t) == int(nc_j), msg
        assert_states_equal(new_t, new_j, msg)
        np.testing.assert_allclose(float(l_t2), float(l_j2), rtol=LL_RTOL, err_msg=msg)
        check_invariants(new_t)
        if bool(over.all()):
            assert not bool(acc_t), msg
            seen["all_over"] += 1
        seen["accept" if bool(acc_t) else "reject"] += 1
    assert seen["accept"] and seen["reject"] and seen["all_over"], seen


