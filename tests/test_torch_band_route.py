"""The delta scorer's route by device: ``core.delta.effective_band_w``.

- On a CUDA device every bucket of the 100k ladder (f_max 256-16,384,
  band 996) scores on the grid, B4 + B2 (the card's measured crossover);
  the device is given as an argument, so no card is needed.
- On the CPU the reference's rule holds: equal to the JAX package's
  ``effective_band_w`` at every bucket of the ladder.
- Where the reference routes banded (a 400-fragment problem with d_max
  20 kb: band 23 at f_max 256), the port's grid route on the CPU (the
  plain versions of B4 and B2) against JAX's banded scorer (jnp grid,
  einsum observed term) within the reference's own banded-vs-grid
  tolerance, rtol 1e-3, atol 0.05 (tests/test_delta.py).
- Delta EM steps on the draws the JAX step consumed, on each route: the
  decisions and committed states equal JAX's banded step; the carried
  likelihood (a sum of deltas) within the port's delta tolerance against
  JAX on the banded route (rtol 1e-4, atol 1e-2: tests/test_torch_delta.py)
  and within the banded-vs-grid tolerance on the grid route.
- Every chr1-scale runner (``ScaleRunner.run``, ``run_chains``,
  ``run_mtm``) builds its scorers through the rule of its table's device:
  under the card's rule none of them calls the banded mass, under the
  CPU's each does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graal_tpu import scale as jscale
from graal_tpu.core import delta as jd
from graal_tpu.core.model import RippeParams as JParams
from graal_tpu.utils import synthetic_sparse as jss
from graal_tpu_torch import convert
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.scale import ScaleRunner
from graal_tpu_torch.utils import synthetic_sparse as tss
from tests.test_torch_delta import step_draws
from tests.test_torch_state import assert_states_equal, to_port

DELTA = 4
F_MAX = 256                 # the banded bucket of the problem below (8 x 23 <= 256)
BAND_RTOL, BAND_ATOL = 1e-3, 0.05
DLL_RTOL, DLL_ATOL = 1e-4, 1e-2
LADDER = (256, 512, 1024, 2048, 4096, 8192, 16384)   # ScaleRunner's tiers at 100k
BAND_100K = 996             # the 100k problem's band (PERF.md section 4)


@pytest.fixture(scope="module")
def ladder_table():
    """A one-sub-per-fragment table wider than the top tier."""
    return tss.make_scale_genome(2 * LADDER[-1], 4, seed=3)[1]


@pytest.mark.parametrize("f_max", LADDER)
def test_card_rule_routes_every_tier_to_the_grid(ladder_table, f_max):
    for device in ("cuda", torch.device("cuda", 0)):
        assert td.effective_band_w(BAND_100K, ladder_table, f_max, device=device) is None
    assert td.effective_band_w(None, ladder_table, f_max, device="cuda") is None


@pytest.mark.parametrize("f_max", LADDER)
def test_cpu_rule_is_the_reference_rule(ladder_table, f_max):
    j_table = jss.make_scale_genome(2 * LADDER[-1], 4, seed=3)[1]
    want = jd.effective_band_w(BAND_100K, j_table, f_max)
    assert td.effective_band_w(BAND_100K, ladder_table, f_max) == want
    assert td.effective_band_w(BAND_100K, ladder_table, f_max, device="cpu") == want
    # the reference bands the top tiers: the routes differ there
    assert (want is not None) == (8 * BAND_100K <= f_max)


@pytest.fixture(scope="module")
def problem():
    truth, table = jss.make_scale_genome(400, 2, seed=41)
    params = JParams.create(kuhn=1.0, lm=9.6, slope=-1.5, d=3.0, fact=6000.0, d_max=20.0,
                            v_inter=1e-3)
    sobs = jss.simulate_sparse_contacts(truth, table, params, seed=41)
    shuf = jss.shuffle_genome(truth, 10, seed=42)
    runner = jscale.ScaleRunner(table, sobs, params)
    w = runner.w
    assert jd.effective_band_w(w, table, F_MAX) == w       # the reference bands here
    return dict(truth=truth, shuf=shuf, table=table, params=params, sobs=sobs,
                nb=runner.nb, w=w,
                t_table=convert.table_from_numpy(table._asdict()),
                t_params=convert.params_from_numpy(params._asdict()),
                t_sobs=convert.sparse_from_numpy(sobs._asdict()),
                t_nb=convert.neighbour_table_from_numpy(runner.nb._asdict()))


def extremities(state):
    pos, l_cont = np.asarray(state.pos), np.asarray(state.l_cont)
    return np.nonzero((pos == 0) | (pos == l_cont - 1))[0]


def test_grid_route_matches_jax_banded_scorer(problem):
    p = problem
    score_j = jax.jit(jd.make_delta_scorer(p["table"], None, F_MAX, sobs=p["sobs"],
                                           band_w=p["w"], grid_impl="jnp",
                                           obs_impl="einsum"))
    score_t = td.make_delta_scorer(p["t_table"], None, F_MAX, sobs=p["t_sobs"])
    assert score_t.band_w is None
    state = p["shuf"]
    ts_ = to_port(state)
    max_id = jnp.max(state.id_c)
    rng = np.random.default_rng(5)
    ext = extremities(state)
    pairs = [(int(a), int(b)) for a, b in zip(rng.permutation(ext)[:4],
                                              rng.permutation(ext)[:4])]
    pairs.append((int(ext[0]), int(ext[0]) + 1))
    for f_a, f_b in pairs:
        want = score_j(state, jnp.int32(f_a), jnp.int32(f_b), p["params"], max_id)
        got = score_t(ts_, f_a, f_b, p["t_params"], torch.tensor(int(max_id)))
        msg = f"f_a={f_a} f_b={f_b}"
        assert bool(got[4]) == bool(want[4]), msg
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]), err_msg=msg)
        assert_states_equal(got[1], want[1], msg)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=BAND_RTOL,
                                   atol=BAND_ATOL, err_msg=msg)


@pytest.fixture(scope="module")
def jax_step(problem):
    p = problem
    return jax.jit(jd.make_delta_em_step(p["table"], None, p["nb"], DELTA, F_MAX,
                                         sobs=p["sobs"], band_w=p["w"]))


def count_banded(monkeypatch):
    """Count the calls of the banded expected mass, by every scorer."""
    calls = []
    inner = td.DeltaScorer._banded_dll

    def spy(self, *a):
        calls.append(1)
        return inner(self, *a)

    monkeypatch.setattr(td.DeltaScorer, "_banded_dll", spy)
    return calls


@pytest.mark.parametrize("route", ["grid", "banded"])
def test_delta_step_on_each_route_matches_jax(problem, jax_step, monkeypatch, route):
    p = problem
    calls = count_banded(monkeypatch)
    step_t = td.make_delta_em_step(p["t_table"], None, p["t_nb"], DELTA, F_MAX,
                                   sobs=p["t_sobs"],
                                   band_w=p["w"] if route == "banded" else None)
    n_top = p["nb"].pk.shape[1]
    n_slots = tm.n_slots(p["t_nb"], DELTA)
    cur = p["shuf"]
    l_j = jnp.float32(-1000.0)
    l_t = torch.tensor(np.float32(-1000.0))
    key = jax.random.key(13)
    moved = 0
    for f_a in np.random.default_rng(6).permutation(extremities(cur))[:5]:
        key, sub = jax.random.split(key)
        new_j, l_j, (op_j, fb_j, nov_j) = jax_step(cur, sub, p["params"], l_j,
                                                   jnp.int32(f_a), jnp.float32(1.0))
        new_t, l_t, (op_t, fb_t, nov_t) = step_t(to_port(cur), step_draws(sub, n_top, n_slots),
                                                 p["t_params"], l_t, torch.tensor(int(f_a)),
                                                 1.0)
        msg = f"{route} f_a={f_a}"
        assert (int(op_t), int(fb_t), int(nov_t)) == (int(op_j), int(fb_j), int(nov_j)), msg
        assert_states_equal(new_t, new_j, msg)
        rtol, atol = (DLL_RTOL, DLL_ATOL) if route == "banded" else (BAND_RTOL, BAND_ATOL)
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=rtol, atol=atol, err_msg=msg)
        moved += int(op_j) >= 0
        cur = new_j
    assert moved > 0
    assert (len(calls) > 0) == (route == "banded")


def drive(runner_kind, p):
    """One short run of a chr1-scale runner at the banded bucket."""
    runner = ScaleRunner(p["t_table"], p["t_sobs"], p["t_params"], nb=p["t_nb"])
    assert runner.w == p["w"]
    start = to_port(p["shuf"])
    if runner_kind == "run":
        runner.run(start, n_cycles=1, steps_per_cycle=8, f_max_min=F_MAX, chunk_steps=8,
                   progress=False)
    elif runner_kind == "run_chains":
        runner.run_chains(start, n_chains=2, n_cycles=1, steps_per_cycle=4, f_max_min=F_MAX,
                          chunk_steps=4, progress=False)
    else:
        runner.run_mtm(start, n_cycles=1, steps_per_cycle=4, f_max_min=F_MAX, chunk_steps=4,
                       progress=False)


@pytest.mark.parametrize("runner_kind", ["run", "run_chains", "run_mtm"])
def test_runners_route_through_their_device_rule(problem, monkeypatch, runner_kind):
    calls = count_banded(monkeypatch)
    drive(runner_kind, problem)
    assert len(calls) > 0                   # the CPU rule bands this bucket
    calls.clear()
    rule = td.effective_band_w
    monkeypatch.setattr(td, "effective_band_w",
                        lambda band_w, table, f_max, device=None: rule(band_w, table, f_max,
                                                                       device="cuda"))
    drive(runner_kind, problem)
    assert calls == []                      # the card's rule: the grid at every bucket
