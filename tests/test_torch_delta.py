"""Parity of graal_tpu_torch.core.delta with the JAX package.

- The mini-state machinery (extract_rows, extract_rows_union, gather_mini,
  scatter_mini) is integer indexing and must be bit-equal, overflow flags
  included.
- The delta scorer's dll is held to the JAX jnp path (grid_impl="jnp",
  obs_impl="einsum", the CPU oracle of tests/test_obsgrid.py) at rtol 1e-4,
  atol 1e-2: the port scores the mini grid in the kernel's formulation
  (log-space expectation, f64 sums, deltas in f64) where JAX sums f32
  grids. Candidates, rows and overflow flags must be bit-equal. Cases:
  dense and sparse observed maps, a circular contig, the banded mass path
  with band_w set literally, a genome with an inactive row, and contig ids
  above 2^24 (exact only as integers).
- EM steps and cycles on shared draws: the port is fed the uniforms and
  Gumbel noise the JAX step consumed, split from the JAX key as
  make_delta_em_cycle / make_delta_em_step split it. States must be
  bit-identical and the decisions equal; the carried likelihood agrees at
  rtol 1e-5.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import delta as jd
from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jm
from graal_tpu.core import sparse as js
from graal_tpu.core.candidates import build_candidates as j_build_candidates
from graal_tpu.core.state import GenomeState as JState
from graal_tpu.utils.synthetic import (bin_level_matrix, default_params, make_genome,
                                       simulate_contacts)
from graal_tpu_torch import convert
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.ops import mini_grid_cuda
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.core.state import check_invariants
from tests.conftest import make_random_state
from tests.test_torch_state import assert_states_equal, to_port

DLL_RTOL, DLL_ATOL = 1e-4, 1e-2
LL_RTOL = 1e-5
F_MAX = 16
DELTA = 4


@pytest.fixture(scope="module")
def problem():
    state, table = make_genome(n_bins=36, n_contigs=6, subs_per_bin=3, seed=4)
    params = default_params(fact=4000.0)
    obs = simulate_contacts(state, table, params, seed=4)
    n = state.n_frags
    nb = jm.build_neighbour_table(bin_level_matrix(obs, table), np.arange(n), n,
                                  blacklisted=[9])
    sobs = js.sparse_from_dense(obs)
    return dict(state=state, table=table, params=params, obs=obs, nb=nb, sobs=sobs,
                t_table=convert.table_from_numpy(table._asdict()),
                t_params=convert.params_from_numpy(params._asdict()),
                t_nb=convert.neighbour_table_from_numpy(nb._asdict()),
                t_sobs=convert.sparse_from_numpy(sobs._asdict()))


@pytest.fixture(scope="module")
def jax_scorers():
    """Compiled JAX scorers shared by the scorer cases, by kind."""
    return {}


def walked_state(state, seed=0, n_moves=6):
    """A state a few random mutations away from ``state`` (contigs of
    mixed sizes), JAX side."""
    rng = np.random.default_rng(seed)
    n = state.n_frags
    for _ in range(n_moves):
        state = jm.apply_mutation(state, int(rng.integers(n)), int(rng.integers(n)),
                                  int(rng.integers(13)))
    return state


def test_extract_rows_match():
    rng = np.random.default_rng(0)
    for trial in range(4):
        js_ = make_random_state(rng, 30, 5)
        ts_ = to_port(js_)
        f_a = int(rng.integers(30))
        ids = rng.integers(0, 30, 5).astype(np.int32)
        for f_max in (4, 8, 16, 30):
            want = jax.jit(jd.extract_rows_union, static_argnums=3)(js_, f_a, jnp.asarray(ids),
                                                                   f_max)
            got = td.extract_rows_union(ts_, torch.tensor(f_a), torch.as_tensor(ids), f_max)
            for g, w, name in zip(got, want, ("rows", "valid", "overflow")):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f"union {name} {trial} {f_max}")
            for i in range(5):
                want = jax.jit(jd.extract_rows, static_argnums=3)(js_, f_a, int(ids[i]), f_max)
                got = td.extract_rows(ts_, f_a, int(ids[i]), f_max)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gather_and_scatter_mini_match():
    rng = np.random.default_rng(1)
    js_ = make_random_state(rng, 26, 5, with_circ=True)
    ts_ = to_port(js_)
    for f_a, f_b in ((0, 7), (3, 3), (12, 25)):
        rows, valid, _ = jd.extract_rows(js_, f_a, f_b, 12)
        t_rows, t_valid = torch.as_tensor(np.array(rows)), torch.as_tensor(np.array(valid))
        mini_j = jd.gather_mini(js_, rows, valid)
        mini_t, = td.drop_chain(td.gather_mini(*td.lift_chain(ts_, t_rows, t_valid)))
        assert_states_equal(mini_t, mini_j, f"gather {f_a} {f_b}")
        lf_a = int(np.argmax(np.asarray(rows) == f_a))
        lf_b = int(np.argmax(np.asarray(rows) == f_b))
        cands = j_build_candidates(mini_j, lf_a, lf_b, max_id=jnp.max(js_.id_c))
        for op in (0, 3, 9, 12):
            cand = jax.tree.map(lambda x: x[op], cands)
            want = jd.scatter_mini(js_, cand, rows, valid)
            got, = td.drop_chain(td.scatter_mini(*td.lift_chain(ts_, to_port(cand), t_rows,
                                                                t_valid)))
            assert_states_equal(got, want, f"scatter {f_a} {f_b} op {op}")


def test_effective_band_w_and_mini_table(problem):
    tt = problem["t_table"]
    for band_w, f_max in ((6, 16), (16, 16), (600, 16), (None, 16), (40, 200)):
        assert td.effective_band_w(band_w, tt, f_max) == \
            jd.effective_band_w(band_w, problem["table"], f_max)
    want = jd.build_mini_table(problem["table"])
    got = td.build_mini_table(tt)
    np.testing.assert_array_equal(got.sub_start.numpy(), np.asarray(want.sub_start))
    np.testing.assert_array_equal(got.sub_count.numpy(), np.asarray(want.sub_count))
    assert (got.s_max, got.n_frags) == (want.s_max, want.n_frags)


def _case_states(problem, case):
    """The JAX state of one scorer case."""
    state = walked_state(problem["state"])
    if case == "circular":
        in0 = np.asarray(state.id_c) == np.asarray(state.id_c)[0]
        circ = np.asarray(state.circ).copy()
        circ[in0] = 1
        state = state._replace(circ=jnp.asarray(circ, jnp.int32))
    if case == "inactive":
        activ = np.asarray(state.activ).copy()
        activ[[2, 20]] = 0
        state = state._replace(activ=jnp.asarray(activ, jnp.int32))
    if case == "big_ids":
        # contig ids above 2^24: 2^24 and 2^24 + 1 are the same float32
        state = state._replace(id_c=state.id_c + jnp.int32(1 << 24))
    return state


@pytest.mark.parametrize("case", ["dense", "sparse", "circular", "banded",
                                  "banded_chunked", "inactive", "big_ids"])
def test_delta_scorer_matches_jax(problem, jax_scorers, monkeypatch, case):
    p = problem
    state = _case_states(p, case)
    kw = {}
    if case.startswith("banded"):
        kw["band_w"] = js.band_width(np.asarray(p["table"].len_kb), float(p["params"].d_max))
    if case == "banded":
        kw["_off_chunk"] = 4          # several band slabs, not dividing band_w
    if case == "banded_chunked":
        # a working-set bound of 3 genome grids: the obs term in chunks of
        # 3 genomes (not dividing 14), the band in slabs of 3r/14 offsets
        r = F_MAX * td.build_mini_table(p["t_table"]).s_max
        monkeypatch.setattr(mini_grid_cuda, "MAX_CELLS", 3 * r * r)
    sparse_obs = case not in ("dense", "banded", "banded_chunked")
    obs = None if sparse_obs else p["obs"]
    # the sparse cases share one compiled JAX scorer, as do the banded ones
    jax_key = "sparse" if sparse_obs else "banded" if case.startswith("banded") else case
    if jax_key not in jax_scorers:
        jax_scorers[jax_key] = jax.jit(jd.make_delta_scorer(
            p["table"], obs, F_MAX, sobs=p["sobs"] if sparse_obs else None,
            grid_impl="jnp", obs_impl="einsum", **kw))
    score_j = jax_scorers[jax_key]
    score_t = td.make_delta_scorer(p["t_table"], obs, F_MAX,
                                   sobs=p["t_sobs"] if sparse_obs else None, **kw)
    ts_ = to_port(state)
    max_id = jnp.max(state.id_c)
    rng = np.random.default_rng(7)
    n = state.n_frags
    pairs = [(int(rng.integers(n)), int(rng.integers(n))) for _ in range(3)]
    if case == "circular":
        members = np.nonzero(np.asarray(state.circ) == 1)[0]
        pairs.append((int(members[0]), int(np.nonzero(np.asarray(state.circ) == 0)[0][0])))
    for f_a, f_b in pairs:
        want = score_j(state, jnp.int32(f_a), jnp.int32(f_b), p["params"], max_id)
        got = score_t(ts_, f_a, f_b, p["t_params"], torch.tensor(int(max_id)))
        msg = f"{case} f_a={f_a} f_b={f_b}"
        assert bool(got[4]) == bool(want[4]), msg
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]), err_msg=msg)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]), err_msg=msg)
        assert_states_equal(got[1], want[1], msg)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=DLL_RTOL,
                                   atol=DLL_ATOL, err_msg=msg)
    if case == "big_ids":
        # ids only enter through equality: the same dll as the unshifted state
        plain = _case_states(p, "sparse")
        for f_a, f_b in pairs:
            a = score_t(ts_, f_a, f_b, p["t_params"], torch.tensor(int(max_id)))[0]
            b = score_t(to_port(plain), f_a, f_b, p["t_params"],
                        torch.tensor(int(jnp.max(plain.id_c))))[0]
            assert torch.equal(a, b)


def test_inactive_rows_masked_before_obs_term(problem):
    """An inactive row's observed counts must not reach the obs term: the
    deltas equal those of the same genome with the row's counts removed."""
    p = problem
    state = _case_states(p, "inactive")
    ts_ = to_port(state)
    obs_cut = p["obs"].copy()
    subs = np.nonzero(np.isin(np.asarray(p["table"].owner), [2, 20]))[0]
    obs_cut[subs, :] = 0.0
    obs_cut[:, subs] = 0.0
    full = td.make_delta_scorer(p["t_table"], p["obs"], F_MAX)
    cut = td.make_delta_scorer(p["t_table"], obs_cut, F_MAX)
    max_id = ts_.id_c.amax()
    for f_a, f_b in ((2, 5), (20, 30), (1, 2)):
        np.testing.assert_allclose(full(ts_, f_a, f_b, p["t_params"], max_id)[0].numpy(),
                                   cut(ts_, f_a, f_b, p["t_params"], max_id)[0].numpy(),
                                   rtol=0, atol=1e-6)


def windows_grid_masked(sobs, subs, sub_valid, act0, k_subs):
    """The observed grid as the delta scorer built it before the obs-grid
    kernel read the CSR map in place: the D rows' windows gathered into
    (m, R, row_cap) columns and counts (keys -1 on padding slots only),
    densified by the one-hot contraction, strict upper triangle, then
    masked by base activity."""
    nnz = sobs.cols.shape[0]
    rc = subs.clamp(0, k_subs - 1)
    start, end = sobs.row_start[rc], sobs.row_start[rc + 1]
    win = start[..., None] + torch.arange(sobs.row_cap)
    ok = (win < end[..., None]) & sub_valid[..., None]
    wc = win.clamp_max(nnz - 1)
    cols = torch.where(ok, sobs.cols[wc], -2)
    vals = torch.where(ok, sobs.vals[wc], 0.0)
    keys = torch.where(sub_valid, rc, -1)
    onehot = (cols[..., None] == keys[:, None, None, :]).float()
    grid = torch.einsum("mrw,mrwj->mrj", vals, onehot)
    r = subs.shape[1]
    upper = torch.ones((r, r), dtype=torch.bool).triu(1)
    return torch.where(upper & act0[:, :, None] & act0[:, None, :], grid, 0.0)


def test_activity_folded_into_obs_keys(problem):
    """inputs()' observed grid, with base activity folded into the keys
    (no mask pass afterwards), equals the grid of the windows gathered and
    densified as before and then masked by base activity, bit for bit, on
    a state with inactive rows (those of test_inactive_rows_masked_before_
    obs_term)."""
    p = problem
    state = _case_states(p, "inactive")
    ts_ = to_port(state)
    scorer = td.make_delta_scorer(p["t_table"], None, F_MAX, sobs=p["t_sobs"])
    max_id = ts_.id_c.amax()
    n_checked = 0
    for f_a, ids in ((2, [5, 20, 2, 30, 11]), (20, [21, 19, 3, 2, 20]), (1, [2, 7, 8, 9, 10])):
        ids = torch.as_tensor(ids)
        rows, valid, _ = td.extract_rows_union(ts_, torch.tensor(f_a), ids, scorer.f_max)
        _, vec, ob, _ = scorer.inputs(*td.lift_chain(ts_, torch.tensor(f_a), ids, rows,
                                                     valid), p["t_params"], max_id[None])
        subs, sub_valid = scorer.sub_rows(rows, valid)
        act0 = (ts_.activ[rows].repeat_interleave(scorer.s_max, -1) == 1) & sub_valid
        n_checked += int((sub_valid & ~act0).sum())
        want = windows_grid_masked(p["t_sobs"], subs, sub_valid, act0, scorer.k_subs)
        assert torch.equal(ob, want)
        assert ob.sum() > 0
        keys = vec.keys
        assert keys.dtype == torch.int32 and bool(((keys >= 0) == act0).all())
        assert torch.equal(keys[act0], subs[act0].int())
    assert n_checked > 0                   # inactive rows inside D were masked


def test_repeat_table_raises(problem):
    """A repeat table is refused by the plain delta scorer (the JAX
    package's build_mini_table asserts the same) and by make_delta_em_step
    without the genome's rep flags; with them the step routes it to the
    repeat engine v2 and runs."""
    from graal_tpu_torch.utils import synthetic_sparse as tss

    base, base_table = tss.make_scale_genome(20, 2, seed=3)
    state, tt, id_d = tss.add_scale_repeats(base, base_table, (3, 3, 7, 11))
    np.testing.assert_array_equal(id_d, np.concatenate([np.arange(20), [3, 3, 7, 11]]))
    assert tt.has_repeats
    obs = np.ones((20, 20), np.float32) - np.eye(20, dtype=np.float32)
    nb = tm.build_neighbour_table(obs, id_d, len(id_d))
    with pytest.raises(ValueError):
        td.make_delta_scorer(tt, obs, 8)
    with pytest.raises(ValueError, match="rep flags"):
        td.make_delta_em_step(tt, obs, nb, DELTA, 8)
    step = td.make_delta_em_step(tt, obs, nb, DELTA, 8, rep=state.rep)
    new, l_new, (op, fb, n_over) = step(state, torch.Generator().manual_seed(2),
                                        tss.scale_params(), torch.tensor(0.0),
                                        torch.tensor(21), 1.0)
    check_invariants(new)
    assert torch.isfinite(l_new) and -1 <= int(op) < 13


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def jax_delta_draws(key, n_steps, n_top, n_slots):
    """The draws of ``n_steps`` delta-cycle steps from ``key``, split as
    make_delta_em_cycle (key, sub = split(key)) and make_delta_em_step
    (k_nb, k_sel = split(sub)) split it."""
    def body(key, _):
        key, sub = jax.random.split(key)
        k_nb, k_sel = jax.random.split(sub)
        return key, (jax.random.uniform(k_nb, (n_top,)),
                     jax.random.gumbel(k_sel, (n_slots,)))
    return jax.lax.scan(body, key, None, length=n_steps)[1]


def step_draws(key, n_top, n_slots):
    k_nb, k_sel = jax.random.split(key)
    return tm.StepDraws(torch.as_tensor(np.array(jax.random.uniform(k_nb, (n_top,)))),
                        torch.as_tensor(np.array(jax.random.gumbel(k_sel, (n_slots,)))),
                        None, None, None)


@pytest.mark.parametrize("obs_kind", ["sparse", "dense"])
def test_delta_em_step_matches_jax(problem, obs_kind):
    p = problem
    sparse_obs = obs_kind == "sparse"
    obs = None if sparse_obs else p["obs"]
    step_j = jax.jit(jd.make_delta_em_step(p["table"], obs, p["nb"], DELTA, F_MAX,
                                           sobs=p["sobs"] if sparse_obs else None))
    step_t = td.make_delta_em_step(p["t_table"], obs, p["t_nb"], DELTA, F_MAX,
                                   sobs=p["t_sobs"] if sparse_obs else None)
    n_top = p["nb"].pk.shape[1]
    n_slots = tm.n_slots(p["t_nb"], DELTA)
    cur = walked_state(p["state"], seed=3)
    l_j = jnp.float32(-1000.0)
    l_t = torch.tensor(np.float32(-1000.0))
    key = jax.random.key(11)
    for f_a in (0, 7, 9, 13, 20, 31, 2):            # 9 is blacklisted
        key, sub = jax.random.split(key)
        new_j, l_j, (op_j, fb_j, nov_j) = step_j(cur, sub, p["params"], l_j,
                                                 jnp.int32(f_a), jnp.float32(1.0))
        new_t, l_t, (op_t, fb_t, nov_t) = step_t(to_port(cur), step_draws(sub, n_top, n_slots),
                                                 p["t_params"], l_t, torch.tensor(f_a), 1.0)
        msg = f"{obs_kind} f_a={f_a}"
        assert (int(op_t), int(fb_t), int(nov_t)) == (int(op_j), int(fb_j), int(nov_j)), msg
        assert_states_equal(new_t, new_j, msg)
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=LL_RTOL, err_msg=msg)
        if f_a == 9:
            assert int(op_t) == -1
        cur = new_j
    check_invariants(to_port(cur))


def test_delta_em_step_all_overflow_is_noop():
    state, table = make_genome(n_bins=12, n_contigs=3, subs_per_bin=3, seed=7)
    params = default_params(fact=2000.0)
    obs = simulate_contacts(state, table, params, seed=7)
    nb = tm.build_neighbour_table(bin_level_matrix(np.asarray(obs), table), np.arange(12), 12)
    tt = convert.table_from_numpy(table._asdict())
    step = td.make_delta_em_step(tt, obs, nb, delta=2, f_max=2)
    ts_ = to_port(state)
    new, l_new, (op, fb, n_over) = step(ts_, torch.Generator().manual_seed(1),
                                        convert.params_from_numpy(params._asdict()),
                                        torch.tensor(-100.0), torch.tensor(0), 1.0)
    assert int(n_over) > 0 and int(op) == -1
    assert all(torch.equal(a, b) for a, b in zip(new, ts_))
    assert float(l_new) == -100.0


def test_delta_cycles_match_jax(problem):
    """Two chunks of a sparse delta cycle (no internal re-anchor, as the
    scale runner drives it) on shared draws: bit-identical states, equal
    per-step decisions, carried likelihood at rtol 1e-5."""
    p = problem
    n = p["state"].n_frags
    cycle_j = jd.make_delta_em_cycle(p["table"], None, p["nb"], DELTA, F_MAX,
                                     sobs=p["sobs"], anchor_fn=False)
    cycle_t = td.make_delta_em_cycle(p["t_table"], None, p["t_nb"], DELTA, F_MAX,
                                     sobs=p["t_sobs"], anchor_fn=False)
    n_top = p["nb"].pk.shape[1]
    n_slots = tm.n_slots(p["t_nb"], DELTA)
    cur_j = jm.explode_genome(p["state"])
    cur_t = to_port(cur_j)
    l_j = jl.log_likelihood(cur_j, p["table"], p["obs"], p["params"])
    l_t = torch.tensor(np.float32(l_j))
    rng = np.random.default_rng(17)
    key = jax.random.key(21)
    for c in range(2):
        key, k_cycle = jax.random.split(key)
        order = rng.permutation(n)[:24].astype(np.int32)
        cur_j, l_j, out_j = cycle_j(cur_j, k_cycle, p["params"], jnp.asarray(order), l_j,
                                    jnp.float32(1.0))
        u_nb, gum = jax_delta_draws(k_cycle, len(order), n_top, n_slots)
        draws = tm.StepDraws(torch.as_tensor(np.array(u_nb)), torch.as_tensor(np.array(gum)),
                             None, None, None)
        cur_t, l_t, out_t = cycle_t(cur_t, draws, p["t_params"], torch.as_tensor(order),
                                    l_t, 1.0)
        for name, g, w in zip(("ops", "fbs", "overs", "ncs"), out_t[1:], out_j[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name} {c}")
        assert_states_equal(cur_t, cur_j, f"cycle {c}")
        np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), rtol=LL_RTOL)
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=LL_RTOL)
    check_invariants(cur_t)
    # the carried likelihood tracks a fresh evaluation (the JAX test's bound)
    fresh = float(jl.log_likelihood(cur_j, p["table"], p["obs"], p["params"]))
    np.testing.assert_allclose(float(l_t), fresh, rtol=5e-4, atol=1.0)


def test_generator_cycle_deterministic_and_anchored(problem):
    p = problem
    n = p["state"].n_frags
    cycle = td.make_delta_em_cycle(p["t_table"], p["obs"], p["t_nb"], DELTA, F_MAX)
    start = tm.explode_genome(to_port(p["state"]))
    l0 = torch.tensor(float(jl.log_likelihood(jm.explode_genome(p["state"]), p["table"],
                                              p["obs"], p["params"])))
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        outs.append(cycle(start, gen, p["t_params"], torch.randperm(n, generator=gen)[:20],
                          l0, 1.0))
    assert all(torch.equal(a, b) for a, b in zip(outs[0][0], outs[1][0]))
    assert torch.equal(outs[0][1], outs[1][1])
    final = outs[0][0]
    check_invariants(final)
    # anchor_fn=None re-anchors on the dense likelihood
    want = float(jl.log_likelihood(JState(**{k: jnp.asarray(v) for k, v in
                                             convert.to_numpy(final).items()}),
                                   p["table"], p["obs"], p["params"]))
    np.testing.assert_allclose(float(outs[0][1]), want, rtol=LL_RTOL)
    assert float(outs[0][1]) > float(l0)
    assert isinstance(final, TState)
