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


# ---- kernel B1's algebra (csrc/ll_dense.cu), transcribed in torch ----------

from graal_tpu.core.candidates import build_candidates as j_build_candidates  # noqa: E402
from graal_tpu_torch.ops import persistent  # noqa: E402
from graal_tpu_torch.ops.mini_grid_cuda import log_cis_plain  # noqa: E402
from tests.test_torch_persistent import RESIDENT, decode  # noqa: E402,F401  (fixture)

TB_REF = lp.TB      # the Pallas kernel's tile edge


@pytest.fixture(scope="module")
def b1_problem():
    """400 sub rows (7 row blocks of the port, a 2 x 2 tile grid of the
    Pallas kernel whose off-diagonal tile no fragment straddles, so the
    reference takes its tc path on the exploded start), 4 contigs. Uneven
    accumulation weights and a v_inter high enough that trans cells hold
    counts, so all three sums of the affine form matter."""
    state, table = make_genome(n_bins=200, n_contigs=4, subs_per_bin=2, seed=21)
    accu = np.random.default_rng(21).integers(1, 4, table.n_subs).astype(np.float32)
    table = table._replace(accu=jnp.asarray(accu),
                           n_frags_per_bins=float(np.float32(accu.mean()) ** 2))
    params = default_params(fact=5000.0)._replace(v_inter=jnp.float32(1.5))
    obs = simulate_contacts(state, table, params, seed=21)
    return state, table, params, obs


def b1_batches(state, seed):
    """The bases of the kernel check (true, exploded, circular), each with
    6 of the 13 candidates of a random (f_a, f_b): JAX states (B, n)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, base in (("true", state), ("exploded", jmcmc.explode_genome(state)),
                       ("circular", circularised(state))):
        n = base.n_frags
        cands = j_build_candidates(base, int(rng.integers(n)), int(rng.integers(n)))
        genomes = [base] + [jax_tree_take(cands, i) for i in (0, 2, 4, 7, 9, 12)]
        out[name] = JState(*[jnp.stack(xs) for xs in zip(*genomes)])
    return out


def jax_tree_take(batch, i):
    return JState(*[x[i] for x in batch])


def band_coords(t, n_rb):
    """csrc/scorer_common.cuh band_coords: upper-triangle tiles by diagonal
    offset, then by row."""
    d = 0
    while t >= n_rb - d:
        t -= n_rb - d
        d += 1
    return t, t + d


def kernel_b1(scorer, vecs, pvec, decode_fn, chunk_max=13):
    """ll_dense.cu in torch. Per (candidate, half tile): the exact
    pure-trans test (any row < K sharing a contig with any column < K), the
    affine form over the scorer's ``tc`` in f64 when it passes, else the
    sum of the half tile's cells u < v < K in the kernel's cell algebra
    (row factor v_inter accu_u / nfpb, column factor accu_v; only
    same-contig pairs inside (0, d_max) take exp of their log expectation).
    The partials are laid out by the items of the persistent schedule
    (``decode_fn``, the kernels' decode_item, tiles in
    band_coords' order) and summed in f64. Returns
    (scores (B,) f32, went cell by cell (B, n_tri * SLOTS) bool)."""
    mid, idc, circ, stot = vecs
    b, k = mid.shape
    tile, rows = persistent.TILE, persistent.TILE // persistent.HALVES
    n_rb = -(-k // tile)
    kp = n_rb * tile
    n_tri = n_rb * (n_rb + 1) // 2
    log_v, v_inter, d_max, log_nfpb = pvec[5], pvec[6], pvec[3], pvec[9]
    rt = v_inter * scorer.ra                               # staged per item row
    cst = torch.where(circ == 1.0, stot, -1.0)
    s = (mid[:, :, None] - mid[:, None, :]).abs()
    same = idc[:, :, None] == idc[:, None, :]
    cis = same & (s > 0.0) & (s < d_max)
    cst_u = cst[:, :, None].expand_as(s)
    la_pair = (scorer.la[:, None] + scorer.la[None, :]) - log_nfpb
    log_e = torch.where(cis, log_cis_plain(s, cst_u >= 0.0, cst_u, pvec) + la_pair,
                        log_v + la_pair)
    e = torch.where(cis, torch.exp(log_e), rt[:, None] * scorer.accu[None, :])
    upper = torch.ones((k, k), dtype=torch.bool).triu(1)
    cells = torch.where(upper, scorer.obs * log_e - e, 0.0)

    def halves(x):          # (B, K, K) -> (B, 2 n_rb, n_rb) blocks of 32 x 64
        x = torch.nn.functional.pad(x, (0, kp - k, 0, kp - k))
        return x.reshape(b, 2 * n_rb, rows, n_rb, tile)

    cell_sums = halves(cells).sum(dim=(2, 4), dtype=torch.float64).float()
    needs = halves(same.float()).amax(dim=(2, 4)) > 0
    tc = scorer.tc
    affine = (log_v.double() * tc[:, 0] + tc[:, 1] - v_inter.double() * tc[:, 2]).float()

    cs, _, n_items = persistent.plan(n_tri, b, 1, RESIDENT, chunk_max)
    n_chunks = -(-b // cs)
    partial = torch.full((b, n_tri * persistent.SLOTS), float("nan"))
    by_cells = torch.zeros((b, n_tri * persistent.SLOTS), dtype=torch.bool)
    for item in range(n_items):
        _, c0, t, half = decode_fn(item, 1, n_chunks, cs)
        bi, bj = band_coords(t, n_rb)
        slot = t * persistent.SLOTS + half
        for c in range(c0, min(c0 + cs, b)):
            cell = bool(needs[c, 2 * bi + half, bj])
            by_cells[c, slot] = cell
            partial[c, slot] = cell_sums[c, 2 * bi + half, bj] if cell else affine[slot]
    assert not torch.isnan(partial).any()
    return (partial.sum(dim=1, dtype=torch.float64) + scorer.obs_const).float(), by_cells


def reference_tc(table, obs):
    """The Pallas scorer's per-tile tc (likelihood_pallas.py:232-254)."""
    k_real = table.n_subs
    k_pad = -(-k_real // TB_REF) * TB_REF
    n_rb = k_pad // TB_REF
    tri = [(i, j) for i in range(n_rb) for j in range(i, n_rb)]
    nfpb = float(table.n_frags_per_bins)
    accu_pad = np.zeros(k_pad, np.float64)
    accu_pad[:k_real] = np.asarray(table.accu, np.float64)
    la_pad = np.zeros(k_pad, np.float64)
    la_pad[:k_real] = np.log(accu_pad[:k_real])
    obs64 = np.zeros((k_pad, k_pad), np.float64)
    obs64[:k_real, :k_real] = obs
    tc_np = np.zeros((len(tri), 3), np.float32)
    for t, (bi, bj) in enumerate(tri):
        rs = slice(bi * TB_REF, (bi + 1) * TB_REF)
        cs = slice(bj * TB_REF, (bj + 1) * TB_REF)
        rg = np.arange(bi * TB_REF, (bi + 1) * TB_REF)[:, None]
        cg = np.arange(bj * TB_REF, (bj + 1) * TB_REF)[None, :]
        m = (cg > rg) & (rg < k_real) & (cg < k_real)
        ob = obs64[rs, cs]
        lap = la_pad[rs][:, None] + la_pad[cs][None, :] - np.log(nfpb)
        acc = accu_pad[rs][:, None] * accu_pad[cs][None, :] / nfpb
        tc_np[t, 0] = (ob * m).sum()
        tc_np[t, 1] = (ob * np.where(m, lap, 0.0)).sum()
        tc_np[t, 2] = (acc * m).sum()
    return tri, tc_np


def test_trans_constants_match_the_reference_tc(b1_problem):
    """The port's half-tile sums, added up over the cells of each Pallas
    tile, give the reference's per-tile tc to f32 rounding."""
    state, table, params, obs = b1_problem
    _, tt, _ = port_problem(state, table, params)
    scorer = lc.make_dense_scorer(tt, obs, "cpu")
    k = tt.n_subs
    n_rb = -(-k // persistent.TILE)
    assert scorer.tc.dtype == torch.float64
    assert scorer.tc.shape == (n_rb * (n_rb + 1) // 2 * persistent.SLOTS, 3)
    tri, want = reference_tc(table, obs)
    got = np.zeros((len(tri), 3))
    per = TB_REF // persistent.TILE
    for t in range(n_rb * (n_rb + 1) // 2):
        bi, bj = band_coords(t, n_rb)
        ref_t = tri.index((bi // per, bj // per))
        got[ref_t] += scorer.tc[t * persistent.SLOTS:(t + 1) * persistent.SLOTS].sum(0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # and directly: a half tile's sums over its own cells
    t, half = 10, 1                               # tile (3, 4), rows 224-255
    bi, bj = band_coords(t, n_rb)
    assert (bi, bj) == (3, 4) and lc.band_tiles(n_rb)[t] == (bi, bj)
    r0, c0 = bi * persistent.TILE + half * 32, bj * persistent.TILE
    ob = np.asarray(obs, np.float64)[r0:r0 + 32, c0:c0 + 64]
    np.testing.assert_allclose(scorer.tc[t * persistent.SLOTS + half, 0].item(), ob.sum())


@pytest.mark.parametrize("base", ["true", "exploded", "circular"])
def test_kernel_b1_algebra_matches_pallas_and_plain(b1_problem, decode, base):
    state, table, params, obs = b1_problem
    _, tt, tp = port_problem(state, table, params)
    batch = b1_batches(state, seed=5)[base]
    scorer = lc.make_dense_scorer(tt, obs, "cpu")
    tb = stack_port([jax_tree_take(batch, i) for i in range(batch.pos.shape[0])])
    vecs = scorer.sub_vectors(tb)
    pvec = lc.params_vector(tp, scorer.log_nfpb)
    got, by_cells = kernel_b1(scorer, vecs, pvec, decode)
    plain = scorer.plain(*vecs, pvec)
    pallas = np.asarray(lp.make_pallas_scorer(table, obs, interpret=True)(batch, params))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=SCORER_RTOL)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=SCORER_RTOL)
    # both paths of the kernel ran: pure-trans half tiles and cell sums
    assert by_cells.any() and not by_cells.all()
    if base == "exploded":
        # the reference took its affine tc path too: its off-diagonal tile
        # holds no same-contig pair for some genome
        idc = np.asarray(batch.id_c)[:, np.asarray(table.owner)]
        off = idc[:, :TB_REF, None] == idc[:, None, TB_REF:]
        assert not off.any(axis=(1, 2)).all()
        # and the port's half tiles are pure-trans nearly everywhere off the
        # diagonal
        assert by_cells.float().mean() < 0.5


def test_kernel_b1_is_batch_invariant(b1_problem, decode):
    """A candidate's transcribed score is bit-identical alone and in its
    batch, and in a batch of another chunking."""
    state, table, params, obs = b1_problem
    _, tt, tp = port_problem(state, table, params)
    batch = b1_batches(state, seed=6)["true"]
    scorer = lc.make_dense_scorer(tt, obs, "cpu")
    tb = stack_port([jax_tree_take(batch, i) for i in range(batch.pos.shape[0])])
    vecs = scorer.sub_vectors(tb)
    pvec = lc.params_vector(tp, scorer.log_nfpb)
    whole, _ = kernel_b1(scorer, vecs, pvec, decode)
    chunked, _ = kernel_b1(scorer, vecs, pvec, decode, chunk_max=3)
    assert torch.equal(whole, chunked)
    for i in range(tb.pos.shape[0]):
        alone, _ = kernel_b1(scorer, [x[i:i + 1] for x in vecs], pvec, decode)
        assert alone.item() == whole[i].item()


def test_dense_scorer_on_the_cpu_makes_no_launch_counter(b1_problem):
    """The CPU path scores with the plain version and counts nothing: no
    launch counter comes into being, so every count reads 0."""
    state, table, params, obs = b1_problem
    ts, tt, tp = port_problem(state, table, params)
    scorer = lc.make_dense_scorer(tt, obs, "cpu")
    states = TState(*[torch.stack([x, x]) for x in ts])
    assert scorer(states, tp).shape == (2,)
    assert scorer.launches.counters == {} and not scorer.launch_shapes
    assert scorer.n_launches == 0
