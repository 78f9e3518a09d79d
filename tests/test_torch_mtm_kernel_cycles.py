"""The MTM / MH cycles against the JAX package, run through the step
kernels' dispatch (``tests/test_torch_mtm_kernels.py`` holds the public
functions themselves).

A cycle is a scan of steps (``core.graphs.Scan``, ``capture=False`` on the
CPU): on a card each step launches kernels E1-E3 of ``csrc/mtm.cu``, and
the delta steps write their proposals into the scan's carry in place and
restore its rows on a rejection. Here each cycle runs twice on shared
draws (split from the JAX keys as the JAX cycles split them) against the
JAX cycle: through the plain versions (the CPU's dispatch), and through
the card branches with a stand-in wrapper (``tests.test_torch_mtm_kernels.StandIn``:
the plain versions behind the wrapper's checks, the delta proposal
written into the carry and restored as the kernels do). Cases: the dense
MH cycle with ``corrected=True`` at f_t 0.8 (a Python float: the scan's 0-d
f32 constant) and the delta MTM cycle at f_max 24. States, accept flags
and contig counts bit for bit; likelihoods at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graal_tpu.core import mtm as jmtm
from graal_tpu_torch.core import mtm as tmtm
from graal_tpu_torch.core.state import check_invariants
from tests.test_torch_graphs_samplers import jax_delta_cycle
from tests.test_torch_mtm import dense, jax_move_draws, t  # noqa: F401  (fixture)
from tests.test_torch_mtm_delta import F_MAX, delta_setup
from tests.test_torch_mtm_kernels import StandIn, route_to_card
from tests.test_torch_state import assert_states_equal, to_port

RTOL = 1e-5


@pytest.fixture(scope="module")
def plain():
    return delta_setup("plain")


def check_cycle(out_t, out_j, msg):
    cur_t, l_t, (lls_t, acc_t, ncs_t) = out_t
    cur_j, l_j, (lls_j, acc_j, ncs_j) = out_j
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j), err_msg=msg)
    np.testing.assert_array_equal(ncs_t.numpy(), np.asarray(ncs_j), err_msg=msg)
    np.testing.assert_allclose(lls_t.numpy(), np.asarray(lls_j), rtol=RTOL, err_msg=msg)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=RTOL, err_msg=msg)
    assert_states_equal(cur_t, cur_j, msg)
    check_invariants(cur_t)
    return int(acc_t.sum())


@pytest.fixture(scope="module")
def dense_jax(dense):  # noqa: F811
    """The JAX dense MH cycle (corrected) and its draws."""
    d = dense
    cycle_j = jmtm.make_mtm_cycle(d["table"], d["obs"], d["jump"], variant="mh", corrected=True)
    key, k1, k2 = jax.random.split(jax.random.key(21), 3)
    order = jax.random.permutation(k1, d["state"].n_frags)
    out_j = cycle_j(d["cur"], k2, d["params"], order, jnp.float32(d["l0"]), jnp.float32(0.8))
    return order, out_j, jax_move_draws(k2, d["state"].n_frags, tmtm.n_move_slots(d["tj"]))


@pytest.fixture(scope="module")
def delta_jax(plain):
    """The JAX delta MTM cycle's 16 steps, their order and draws."""
    p = plain
    steps = 16
    order = np.random.default_rng(8).permutation(p["state"].n_frags)[:steps].astype(np.int32)
    key = jax.random.key(23)
    out_j = jax_delta_cycle(p, "mtm")(p["start"], key, p["params"], jnp.asarray(order),
                                      jnp.float32(p["l0"]), jnp.float32(1.0))
    return order, out_j, jax_move_draws(key, steps, tmtm.n_move_slots(p["tj"]))


@pytest.mark.parametrize("route", ["plain", "card"])
def test_dense_mh_cycle_corrected_matches_jax(dense, dense_jax, monkeypatch, route):  # noqa: F811
    d = dense
    n = d["state"].n_frags
    if route == "card":
        spy = StandIn()
        route_to_card(monkeypatch, spy)
    cycle_t = tmtm.make_mtm_cycle(d["tt"], d["obs"], d["tj"], variant="mh", corrected=True,
                                  capture=False)
    order, out_j, (gum, u) = dense_jax
    out_t = cycle_t(to_port(d["cur"]), tmtm.MoveDraws(t(gum), t(u)), d["tp"], t(order),
                    torch.tensor(np.float32(d["l0"])), 0.8)
    n_acc = check_cycle(out_t, out_j, f"dense mh, {route}")
    assert 0 < n_acc < n
    if route == "card":
        assert spy.calls == ["set", "draw", "set", "accept"] * n


@pytest.mark.parametrize("route", ["plain", "card"])
def test_delta_mtm_cycle_matches_jax(plain, delta_jax, monkeypatch, route):
    """16 delta MTM steps from a walked genome; on the card route every
    proposal is written into the scan's carry and a rejection restores
    it."""
    p = plain
    if route == "card":
        spy = StandIn()
        route_to_card(monkeypatch, spy)
    order, out_j, (gum, u) = delta_jax
    steps = len(order)
    cycle_t = tmtm.make_delta_mtm_cycle(p["tt"], p["tj"], F_MAX, p["tsobs"], variant="mtm",
                                        capture=False)
    start = to_port(p["start"])
    out_t = cycle_t(start, tmtm.MoveDraws(t(gum), t(u)), p["tp"], torch.as_tensor(order),
                    torch.tensor(np.float32(p["l0"])), 1.0)
    n_acc = check_cycle(out_t, out_j, f"delta mtm, {route}")
    assert 0 < n_acc < steps
    assert all(torch.equal(a, b) for a, b in zip(start, to_port(p["start"])))
    if route == "card":
        assert spy.calls == ["set", "draw", "set", "accept"] * steps
