"""Kernel B2's three classes of (half tile, candidate): empty, band-free and
band (graal_tpu_torch/csrc/ll_mini.cu, decided in plain torch by
``tile_classes_plain``).

The kernel's scoring is transcribed here in torch (:func:`kernel_tiles`):
an empty (half tile, candidate) adds 0, a band-free one its closed form
(sum_u (log_v + la_u - log nfpb) rowsum(u) + sum_v la_v colsum(v) - (sum_u
rt_u)(sum_v a_v), in f64, rounded to the f32 partial), a band one the cell
algebra of ``kernel_cells`` (tests/test_torch_mini_grid.py); the f32
partials are summed in f64. It must agree with ``mini_grid_plain`` and the
JAX package's Pallas mini-grid scorer in interpret mode at KERNEL_RTOL, its
deltas with the plain version's within a few f32 ulps of the largest
score (the atol of test_torch_mini_grid.py).

Inputs are mini grids as the delta engine builds them, at R = 384 and 512
(six and eight 64-row tiles): a live prefix of two contigs in row order
(each contig's rows in genome order), a padded tail, a few inactive rows
(dead in every genome, their counts zeroed), d_max small enough (~30
rows) that most off-diagonal tiles are band-free; candidates that move a
piece inside the other contig's band, flip, split, join or circularise a
contig, and one whose rows are dead where the base is live and counted
(the kernel's contract allows it: it must keep those tiles cell by cell).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core.model import RippeParams
from graal_tpu.ops.likelihood_pallas import make_mini_grid_scorer
from graal_tpu_torch import convert
from graal_tpu_torch.ops.likelihood_cuda import params_vector
from graal_tpu_torch.ops.mini_grid_cuda import (BAND, DEAD_LA, EMPTY, FREE, MiniGridScorer,
                                                log_cis_plain, mini_grid_plain,
                                                tile_classes_plain, tri_tiles)
from tests.test_torch_mini_grid import KERNEL_RTOL, NFPB
import tests.test_torch_state  # noqa: F401  (one torch thread per test worker)

C = 14
TILE = 64
D_MAX_KB = 150.0     # rows are ~5 kb: ~30 rows of band


def params(d_max=D_MAX_KB):
    return RippeParams.create(kuhn=1.0, lm=9.6, slope=-1.5, d=3.0, fact=4000.0,
                              d_max=d_max, v_inter=0.1)


def pvec_of(p):
    tp = convert.params_from_numpy(p._asdict())
    return params_vector(tp, torch.tensor(np.float32(np.log(NFPB))))


def contig_mids(lens):
    cum = np.cumsum(lens)
    return cum - lens / 2, cum[-1]


def tile_genomes(rng, m, r, n_live, with_circ=True, big_ids=False):
    """(mid, idc, circ, stot, la, ob) numpy arrays of m neighbours x C
    genomes on an r-row mini grid: the base (genome 0) holds contigs A and
    B in row order over the live prefix of n_live rows, then padding (la
    = -1e9, mid 0, id 0); genome 1 equals the base; 2 moves a piece of A
    inside B's band; 3 flips a piece of A; 4 splits A (a new id); 5
    circularises A (or, without circles, joins B after A); 6 joins B after
    A; 7 kills 40 rows of B that the base has live and counted; 8-13 move
    random pieces into random places of either contig."""
    shape = (m, C, r)
    mid = np.zeros(shape, np.float32)
    idc = np.zeros(shape, np.int32)
    circ = np.zeros(shape, np.float32)
    stot = np.ones(shape, np.float32)
    la = np.full(shape, DEAD_LA, np.float32)
    ob = np.zeros((m, r, r), np.float32)
    for a in range(m):
        lens = rng.uniform(1.0, 9.0, r).astype(np.float32)
        n_a = int(rng.integers(n_live // 3, 2 * n_live // 3))
        rows_a, rows_b = np.arange(n_a), np.arange(n_a, n_live)
        id_a, id_b = ((1 << 24) + 1 + 2 * a, (1 << 24) + 2 + 2 * a) if big_ids else (7 + a, 40 + a)
        b_mid, b_id, b_stot = np.zeros(r, np.float32), np.zeros(r, np.int32), np.ones(r, np.float32)
        for rows, cid in ((rows_a, id_a), (rows_b, id_b)):
            b_mid[rows], b_stot[rows] = contig_mids(lens[rows])
            b_id[rows] = cid
        live = np.zeros(r, bool)
        live[:n_live] = True
        live[rng.choice(n_live, 3, replace=False)] = False          # inactive rows
        b_la = np.where(live, np.log(rng.uniform(0.5, 2.0, r)), DEAD_LA).astype(np.float32)
        new_id = max(id_a, id_b) + 1
        for c in range(C):
            g_mid, g_id, g_circ, g_stot, g_la = (b_mid.copy(), b_id.copy(), np.zeros(r, np.float32),
                                                 b_stot.copy(), b_la.copy())
            if c == 2:                           # a piece of A lands inside B's band
                s = int(rng.integers(0, n_a - 6))
                at = int(rng.integers(n_a + 10, n_live - 10))
                g_id[s:s + 5] = id_b
                g_mid[s:s + 5] = b_mid[at] + np.arange(5) * 0.5
            elif c == 3:                         # a flipped piece of A
                s = int(rng.integers(0, n_a - 30))
                g_mid[s:s + 25] = g_mid[s:s + 25][::-1]
            elif c == 4:                         # A split in two
                s = int(rng.integers(20, n_a - 20))
                g_id[s:n_a] = new_id
                g_mid[s:n_a], g_stot[s:n_a] = contig_mids(lens[s:n_a])
                g_stot[:s] = contig_mids(lens[:s])[1]
            elif c == 5 and with_circ:           # A circularised
                g_circ[rows_a] = 1.0
            elif c in (5, 6):                    # B joined after A
                g_id[rows_b] = id_a
                g_mid[rows_b] += b_stot[0]
                g_stot[:n_live] = b_stot[0] + b_stot[n_a]
            elif c == 7:                         # rows the base has live die here
                s = int(rng.integers(n_a, n_live - 40))
                g_la[s:s + 40] = DEAD_LA
            elif c >= 8:                         # a random piece moved anywhere
                k = int(rng.integers(1, 12))
                s = int(rng.integers(0, n_live - k))
                at = int(rng.integers(0, n_live))
                g_id[s:s + k] = b_id[at]
                g_mid[s:s + k] = b_mid[at] + rng.uniform(-3.0, 3.0, k).astype(np.float32)
            mid[a, c], idc[a, c], circ[a, c], stot[a, c], la[a, c] = g_mid, g_id, g_circ, g_stot, g_la
        i, j = np.triu_indices(r, 1)
        lam = 3.0 * np.exp(-np.abs(b_mid[i] - b_mid[j]) / 60.0) * (b_id[i] == b_id[j]) + 0.05
        counts = rng.poisson(lam) * (live[i] & live[j])
        ob[a, i, j] = counts
    return mid, idc, circ, stot, la, ob


def as_torch(arrays):
    return [torch.as_tensor(x) for x in arrays]


def padded(x, rp, value=0.0):
    return torch.nn.functional.pad(x, (0, rp - x.shape[-1]), value=value)


def kernel_tiles(mid, idc, circ, stot, la, ob, pvec):
    """ll_mini.cu's scoring by classes in torch: (scores (M, C) f32, dll
    (M, C - 1) f32, the f32 partials (M, C, n_tri, 2) in the kernel's
    order)."""
    m_, c_, r = mid.shape
    pv = pvec.expand(m_, pvec.shape[-1])
    classes = tile_classes_plain(mid, idc, la, ob, pvec)
    n_rb = -(-r // TILE)
    rp, h_ = n_rb * TILE, 2 * n_rb
    bi, bj = tri_tiles(n_rb)
    inside = torch.arange(rp) < r
    upper = torch.ones((rp, rp), dtype=torch.bool).triu(1) & inside[:, None] & inside[None, :]
    parts = []
    for a in range(m_):
        p = pv[a]
        log_v, v_inter, log_nfpb = p[5], p[6], p[9]
        la_a = padded(la[a], rp, DEAD_LA)
        mid_a, idc_a, circ_a = padded(mid[a], rp), padded(idc[a], rp), padded(circ[a], rp)
        stot_a = padded(stot[a], rp, 1.0)
        ob_a = torch.nn.functional.pad(ob[a], (0, rp - r, 0, rp - r))
        # band: the cell algebra
        row_t = v_inter * torch.exp(la_a - log_nfpb)
        col_a = torch.exp(la_a)
        cst = torch.where(circ_a == 1.0, stot_a, -1.0)
        s = (mid_a[:, :, None] - mid_a[:, None, :]).abs()
        cst_u = cst[:, :, None].expand_as(s)
        log_cis = log_cis_plain(s, cst_u >= 0.0, cst_u, p)
        same = idc_a[:, :, None] == idc_a[:, None, :]
        la_pair = (la_a[:, :, None] + la_a[:, None, :]) - log_nfpb
        log_e = torch.where(same, log_cis + la_pair, log_v + la_pair)
        e = torch.where(same, torch.exp(log_e), row_t[:, :, None] * col_a[:, None, :])
        cell = torch.where(upper, ob_a * log_e - e, 0.0)
        band = cell.reshape(c_, h_, TILE // 2, n_rb, TILE).sum((2, 4), dtype=torch.float64).float()
        # band-free: the closed form over the tile's row and column sums
        rowsum = ob_a.reshape(rp, n_rb, TILE).sum(-1).double()
        colsum = ob_a.reshape(h_, TILE // 2, rp).sum(1).double()
        l_u = log_v.double() + la_a.double() - log_nfpb.double()
        t_ob = torch.einsum("chu,huj->chj", l_u.reshape(c_, h_, TILE // 2),
                            rowsum.reshape(h_, TILE // 2, n_rb)) \
            + torch.einsum("cjv,hjv->chj", la_a.double().reshape(c_, n_rb, TILE),
                           colsum.reshape(h_, n_rb, TILE))
        t_rt = row_t.double().reshape(c_, h_, TILE // 2).sum(-1)
        t_a = col_a.double().reshape(c_, n_rb, TILE).sum(-1)
        free = (t_ob - t_rt[:, :, None] * t_a[:, None, :]).float()

        def pick(x):
            return torch.stack([x[:, 2 * bi + half, bj] for half in range(2)], -1)
        cls = classes[a]
        parts.append(torch.where(cls == BAND, pick(band),
                                 torch.where(cls == FREE, pick(free), 0.0)))
    partials = torch.stack(parts)
    tot = partials.double().sum((2, 3))
    return tot.float(), (tot[:, 1:] - tot[:, :1]).float(), partials


def cell_needs(mid, idc, la, ob, pvec):
    """Per (M, C, n_tri, 2), by brute force over the cells u < v < R of each
    half tile: (some cell needs the cell loop: a live pair of one contig
    inside (0, d_max), or a dead end with a count; some cell is not exactly
    0: both ends live, or a count)."""
    m_, c_, r = mid.shape
    pv = pvec.expand(m_, pvec.shape[-1])
    n_rb = -(-r // TILE)
    rp, h_ = n_rb * TILE, 2 * n_rb
    bi, bj = tri_tiles(n_rb)
    inside = torch.arange(rp) < r
    upper = torch.ones((rp, rp), dtype=torch.bool).triu(1) & inside[:, None] & inside[None, :]
    need, nonzero = [], []
    for a in range(m_):
        live = padded(la[a], rp, DEAD_LA) > DEAD_LA
        mid_a, idc_a = padded(mid[a], rp), padded(idc[a], rp)
        counted = torch.nn.functional.pad(ob[a], (0, rp - r, 0, rp - r)) != 0
        s = (mid_a[:, :, None] - mid_a[:, None, :]).abs()
        both = live[:, :, None] & live[:, None, :]
        cis = both & (idc_a[:, :, None] == idc_a[:, None, :]) & (s > 0) & (s < pv[a, 3])
        outs = []
        for x in (upper & (cis | (~both & counted)), upper & (both | counted)):
            g = x.reshape(c_, h_, TILE // 2, n_rb, TILE).any(4).any(2)
            outs.append(torch.stack([g[:, 2 * bi + half, bj] for half in range(2)], -1))
        need.append(outs[0])
        nonzero.append(outs[1])
    return torch.stack(need), torch.stack(nonzero)


CASES = {
    # name: (r, n_live, with_circ, big_ids, d_max per neighbour slot)
    "linear": (384, 300, False, False, (D_MAX_KB,) * 2),
    "circular": (384, 300, True, False, (D_MAX_KB,) * 2),
    "ids_above_2_24": (384, 330, True, True, (D_MAX_KB,) * 2),
    "chains": (384, 280, True, False, (90.0, D_MAX_KB, 260.0)),
}


def case_inputs(name, seed=0):
    r, n_live, with_circ, big_ids, d_maxes = CASES[name]
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    arrays = tile_genomes(rng, len(d_maxes), r, n_live, with_circ, big_ids)
    pvec = torch.stack([pvec_of(params(d)) for d in d_maxes])
    if len(set(d_maxes)) == 1:
        pvec = pvec[0]                         # one vector, broadcast to every slot
    return as_torch(arrays), pvec


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_tiles_match_plain(name):
    args, pvec = case_inputs(name)
    scores, dll, _ = kernel_tiles(*args, pvec)
    p_scores, p_dll = mini_grid_plain(*args, pvec)
    np.testing.assert_allclose(scores.numpy(), p_scores.numpy(), rtol=KERNEL_RTOL)
    np.testing.assert_allclose(dll.numpy(), p_dll.numpy(), rtol=0,
                               atol=np.abs(p_scores.numpy()).max() * 1e-6)
    # every class is exercised
    n = torch.bincount(tile_classes_plain(*args[:2], args[4], args[5], pvec).flatten().long(),
                       minlength=3)
    assert int(n[EMPTY]) > 0 and int(n[BAND]) > 0 and int(n[FREE]) > 0


@pytest.mark.parametrize("with_circ", [True, False])
def test_kernel_tiles_match_pallas_interpret(with_circ):
    """At R = 512 (three Pallas tiles of 256) against the JAX package's
    scorer, one call per neighbour."""
    rng = np.random.default_rng(21 + int(with_circ))
    arrays = tile_genomes(rng, 2, 512, 420, with_circ)
    assert bool(arrays[2].any()) == with_circ
    p = params()
    pallas = make_mini_grid_scorer(512, float(np.log(NFPB)), with_circ=with_circ,
                                   interpret=True)
    want = np.stack([np.asarray(pallas(*[jnp.asarray(x[a]) for x in arrays], p))
                     for a in range(2)])
    args = as_torch(arrays)
    scores, dll, _ = kernel_tiles(*args, pvec_of(p))
    np.testing.assert_allclose(scores.numpy(), want, rtol=KERNEL_RTOL)
    p_scores, p_dll = mini_grid_plain(*args, pvec_of(p))
    np.testing.assert_allclose(dll.numpy(), p_dll.numpy(), rtol=0,
                               atol=np.abs(want).max() * 1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_classes_are_conservative(name):
    """No half tile is called band-free when one of its cells needs the cell
    loop, nor empty when one of its cells is not exactly 0."""
    args, pvec = case_inputs(name, seed=1)
    mid, idc, _, _, la, ob = args
    cls = tile_classes_plain(mid, idc, la, ob, pvec)
    need, nonzero = cell_needs(mid, idc, la, ob, pvec)
    assert not bool((need & (cls == FREE)).any())
    assert not bool((nonzero & (cls == EMPTY)).any())
    assert bool(need.any()) and bool((cls == FREE).any())


def test_dead_rows_with_counts_stay_cell_by_cell():
    """Genome 7's rows the base has live and counted are dead in it: every
    half tile that holds one of them with a count in the tile is neither
    empty nor band-free, though some of the same tiles are band-free in
    the base."""
    args, pvec = case_inputs("linear")
    mid, idc, _, _, la, ob = args
    cls = tile_classes_plain(mid, idc, la, ob, pvec)
    n_rb = -(-mid.shape[-1] // TILE)
    rp = n_rb * TILE
    bi, bj = tri_tiles(n_rb)
    for a in range(mid.shape[0]):
        killed = padded((la[a, 7] == DEAD_LA) & (la[a, 0] > DEAD_LA), rp, False)
        counted = torch.nn.functional.pad(ob[a], (0, rp - ob.shape[-1]) * 2) != 0
        by_row = (counted & killed[:, None]).reshape(2 * n_rb, TILE // 2, n_rb, TILE).any(3).any(1)
        by_col = (counted & killed[None, :]).reshape(2 * n_rb, TILE // 2, n_rb, TILE).any(3).any(1)
        hit = torch.stack([(by_row | by_col)[2 * bi + half, bj] for half in range(2)], -1)
        assert bool(hit.any())
        assert bool((cls[a, 7][hit] == BAND).all())
        assert bool((cls[a, 0][hit] == FREE).any())


def test_identical_tiles_give_identical_partials():
    """Genome 1 equals the base: every partial of it equals the base's bit
    for bit. Genome 3 flips a piece of A: its half tiles away from the
    piece's rows and columns keep the base's class and partial."""
    args, pvec = case_inputs("circular")
    _, _, partials = kernel_tiles(*args, pvec)
    cls = tile_classes_plain(*args[:2], args[4], args[5], pvec)
    assert torch.equal(partials[:, 1], partials[:, 0]) and torch.equal(cls[:, 1], cls[:, 0])
    mid = args[0]
    n_rb = -(-mid.shape[-1] // TILE)
    bi, bj = tri_tiles(n_rb)
    for a in range(mid.shape[0]):
        moved = torch.nonzero(mid[a, 3] != mid[a, 0])[:, 0]
        lo, hi = int(moved.min()) // TILE, int(moved.max()) // TILE
        away = ((bi < lo) | (bi > hi)) & ((bj < lo) | (bj > hi))
        assert bool(away.any())
        assert torch.equal(partials[a, 3][away], partials[a, 0][away])
        assert torch.equal(cls[a, 3][away], cls[a, 0][away])


def test_tri_tiles_order():
    """The kernel's partial order (tri_slot = bj (bj + 1) / 2 + bi): every
    upper tile once, and the tiles inside the first L row blocks are the
    first L (L + 1) / 2."""
    bi, bj = tri_tiles(7)
    assert torch.equal(bj * (bj + 1) // 2 + bi, torch.arange(28))
    assert bool((bi <= bj).all()) and len({(int(i), int(j)) for i, j in zip(bi, bj)}) == 28
    for n_live in range(8):
        assert bool((bj[:n_live * (n_live + 1) // 2] < n_live).all())
        assert bool((bj[n_live * (n_live + 1) // 2:] >= n_live).all())


def check_contract(args):
    """B2's arguments ``args`` (mid, idc, circ, stot, la, ob, pvec) as the
    delta engine built them: ob is zero on every row and column where the
    base's la is dead (some is), and the kernel's scoring by classes equals
    the plain version on them. Returns the band-free (half tile,
    candidate) pairs."""
    dead0 = args[4][:, 0] <= DEAD_LA                      # (M, R)
    assert bool(dead0.any())
    assert not bool(args[5][dead0[:, :, None].expand_as(args[5])].any())
    assert not bool(args[5][dead0[:, None, :].expand_as(args[5])].any())
    scores, dll, _ = kernel_tiles(*args[:6], args[6])
    p_scores, p_dll = mini_grid_plain(*args)
    np.testing.assert_allclose(scores.numpy(), p_scores.numpy(), rtol=KERNEL_RTOL)
    np.testing.assert_allclose(dll.numpy(), p_dll.numpy(), rtol=0,
                               atol=np.abs(p_scores.numpy()).max() * 1e-6)
    return int((tile_classes_plain(*args[:2], args[4], args[5], args[6]) == FREE).sum())


def test_engine_inputs_keep_the_contract():
    """The delta engine's B2 inputs (the port's ScaleRunner problem at 400
    fragments, f_max 256, one step's 5 neighbour slots, d_max cut to 60 kb
    so that band-free tiles occur at this size): ob is zero on every row
    and column where the base's la is dead, and the kernel's scoring by
    classes equals the plain version on them."""
    from graal_tpu_torch.core import delta, mcmc
    from graal_tpu_torch.entry import scale_problem
    from graal_tpu_torch.scale import ScaleRunner

    truth, shuf, table, p, sobs = scale_problem(400, n_contigs=2, n_pieces=10, device="cpu")
    nb = ScaleRunner(table, sobs, p).nb
    p = p._replace(d_max=torch.tensor(60.0))
    scorer = delta.make_delta_scorer(table, None, 256, sobs=sobs)
    gen = torch.Generator().manual_seed(3)
    n_free = 0
    for state, f_a in ((truth, 17), (shuf, 211)):
        f_a = torch.tensor(f_a)
        ids, _ = mcmc.sample_neighbours(gen, f_a, state, nb, 4)
        rows, valid, _ = delta.extract_rows_union(state, f_a, ids, scorer.f_max)
        _, vec, ob, pv = scorer.inputs(*delta.lift_chain(state, f_a, ids, rows, valid),
                                       p, state.id_c.amax()[None])
        n_free += check_contract(scorer.mini_grid_args(vec, ob, pv))
    assert n_free > 0


class SpyB2(MiniGridScorer):
    """B2's wrapper, keeping the arguments of every call."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return super().__call__(*args)


@pytest.mark.parametrize("engine", ["repeat_v2", "mh_catalogue", "chains", "delta_mtm_cycle"])
def test_engine_inputs_keep_the_contract_on(engine):
    """The same contract on what B2 is fed by the delta step's other
    engines (a captured step feeds B2 the same): the v2 repeat engine's
    single-copy majority (240 data bins, 6 duplicated, fA a repeat copy and
    another fragment), the MH catalogue (core.candidates.mh_candidates, as
    the delta MTM / MH samplers build their candidates), a chains axis
    (3 chains, one parameter row per slot, M = 15) and one step of the
    delta MTM cycle's scan body (core.mtm.make_delta_mtm_cycle with
    capture=False: the body its graph replays; both passes, M = 7), each at
    d_max 60 kb."""
    from graal_tpu_torch.core import delta, mcmc
    from graal_tpu_torch.core.candidates import mh_candidates
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import scale_problem, scale_repeat_problem
    from graal_tpu_torch.scale import ScaleRunner

    spy = SpyB2()
    gen = torch.Generator().manual_seed(5)
    if engine == "repeat_v2":
        truth, shuf, table, p, sobs, id_d = scale_repeat_problem(240, n_dups=6, device="cpu")
        nb = ScaleRunner(table, sobs, p, id_d=id_d).nb
        p = p._replace(d_max=torch.tensor(60.0))
        step = delta.make_delta_em_step(table, None, nb, 4, 256, sobs=sobs, rep=shuf.rep,
                                        mini_grid=spy)
        copy = int(torch.nonzero(shuf.rep == 1)[-1])
        for state, f_a in ((shuf, copy), (truth, 17)):
            step(state, gen, p, torch.tensor(0.0), torch.tensor(f_a), 1.0)
    else:
        truth, shuf, table, p, sobs = scale_problem(400, n_contigs=2, n_pieces=10,
                                                    device="cpu")
        nb = ScaleRunner(table, sobs, p).nb
        p = p._replace(d_max=torch.tensor(60.0))
        if engine == "mh_catalogue":
            scorer = delta.make_delta_scorer(table, None, 256, sobs=sobs, mini_grid=spy,
                                             catalogue=mh_candidates)
            for state, f_a in ((truth, 17), (shuf, 211)):
                f_a = torch.tensor(f_a)
                ids, _ = mcmc.sample_neighbours(gen, f_a, state, nb, 4)
                rows, valid, over = delta.extract_rows_union(state, f_a, ids, scorer.f_max)
                scorer.score(state, f_a, ids, rows, valid, over, p, state.id_c.amax())
        elif engine == "delta_mtm_cycle":
            from graal_tpu_torch.core.mtm import make_delta_mtm_cycle

            runner = ScaleRunner(table, sobs, p)
            cycle = make_delta_mtm_cycle(table, runner.jump_table(5, shuf.n_frags), 256, sobs,
                                         mini_grid=spy, rep=shuf.rep, capture=False)
            cycle(shuf, gen, p, torch.tensor([211]), runner.anchor_fn()(shuf, p), 1.0)
        else:
            states = GenomeState(*[torch.stack(xs) for xs in zip(
                truth, shuf, mcmc.explode_genome(shuf))])
            pc = type(p)(*[x * torch.tensor([1.0, 1.01, 0.99]) for x in p])
            step = delta.make_delta_em_step(table, None, nb, 4, 256, sobs=sobs, mini_grid=spy)
            step(states, gen, pc, torch.zeros(3), torch.tensor([17, 211, 5]),
                 torch.tensor([1.0, 2.0, 4.0]))
    assert len(spy.calls) == 2 if engine != "chains" else len(spy.calls) == 1
    for args in spy.calls:
        if engine == "chains":
            assert args[0].shape[0] == 15 and args[6].shape == (15, 10)
        if engine == "delta_mtm_cycle":
            assert args[0].shape[0] == 7
        check_contract(args)
