"""Kernel B2's plain version (graal_tpu_torch.ops.mini_grid_cuda) against
the JAX package's Pallas mini-grid scorer ``make_mini_grid_scorer`` in
interpret mode.

Inputs are per-neighbour batches of 14 genomes (base + 13 candidates) on
an R = 40 sub-row grid (one Pallas tile, so the interpreter stays fast):
two contigs per genome, padding rows and inactive rows (la = -1e9, their
observed counts zeroed, as the delta scorer hands them over). Both circular
specialisations of the Pallas kernel are covered: with_circ=True on genomes
with circular rows, with_circ=False on linear genomes. The absolute scores
agree at rtol 1e-4 (bench.py's scorer bound: the port sums in f64 where
the TPU kernel sums f32 tiles); the port's deltas are its f64 differences
of those scores.

The CUDA kernel's own cell algebra (csrc/ll_mini.cu) is transcribed here in
torch (:func:`kernel_cells`): a same-contig cell takes exp of its log
expectation, a trans cell the product of the row factor v_inter exp(la_u)
/ nfpb and the column factor exp(la_v), so a padding or inactive row
(la = -1e9) gives E = 0. It must agree with the plain version and the
Pallas interpreter to rtol 1e-5 (the two forms of a trans cell agree to
rounding), and its deltas with the plain version's to a few f32 ulps of
the largest score.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.ops.likelihood_pallas import make_mini_grid_scorer
from graal_tpu.utils.synthetic import default_params
from graal_tpu_torch import convert
from graal_tpu_torch.ops.likelihood_cuda import params_vector
from graal_tpu_torch.ops import mini_grid_cuda
from graal_tpu_torch.ops.mini_grid_cuda import MiniGridScorer, log_cis_plain, mini_grid_plain
import tests.test_torch_state  # noqa: F401  (one torch thread per test worker)

R = 40
C = 14
NFPB = 2.25
RTOL = 1e-4


def genomes(rng, m, with_circ, n_pad=4, inactive=(5, 17)):
    """(mid, idc, circ, stot, la, ob) of m neighbours x C genomes."""
    shape = (m, C, R)
    mid = np.zeros(shape, np.float32)
    idc = np.zeros(shape, np.int32)
    circ = np.zeros(shape, np.float32)
    stot = np.ones(shape, np.float32)
    for a in range(m):
        lens = rng.uniform(1.0, 9.0, R)
        for c in range(C):
            split = int(rng.integers(R // 4, 3 * R // 4))
            owner = np.where(rng.permutation(R) < split, 7 + a, 1 << 24)   # two contigs
            for cid in np.unique(owner):
                rows = rng.permutation(np.nonzero(owner == cid)[0])
                cum = np.cumsum(lens[rows])
                mid[a, c, rows] = cum - lens[rows] / 2
                stot[a, c, rows] = cum[-1]
                if with_circ and cid == 7 + a and c % 2 == 0:
                    circ[a, c, rows] = 1.0
            idc[a, c] = owner
    live = np.ones(R, bool)
    live[R - n_pad:] = False                   # padding rows
    live[list(inactive)] = False
    la = np.where(live, np.log(rng.uniform(0.5, 2.0, R)), -1e9).astype(np.float32)
    la = np.broadcast_to(la, shape).copy()
    ob = rng.poisson(3.0, (m, R, R)).astype(np.float32)
    ob = np.triu(ob, 1) * (live[:, None] & live[None, :])
    return mid, idc, circ, stot, la, ob.astype(np.float32)


@pytest.mark.parametrize("with_circ", [True, False])
def test_plain_matches_pallas_interpret(with_circ):
    rng = np.random.default_rng(int(with_circ))
    m = 2
    mid, idc, circ, stot, la, ob = genomes(rng, m, with_circ)
    assert bool(circ.any()) == with_circ
    params = default_params(fact=4000.0)
    pallas = make_mini_grid_scorer(R, float(np.log(NFPB)), with_circ=with_circ,
                                   interpret=True)
    want = np.stack([np.asarray(pallas(jnp.asarray(mid[a]), jnp.asarray(idc[a]),
                                       jnp.asarray(circ[a]), jnp.asarray(stot[a]),
                                       jnp.asarray(la[a]), jnp.asarray(ob[a]), params))
                     for a in range(m)])
    tp = convert.params_from_numpy(params._asdict())
    pvec = params_vector(tp, torch.tensor(np.float32(np.log(NFPB))))
    args = [torch.as_tensor(x) for x in (mid, idc, circ, stot, la, ob)]
    scores, dll = mini_grid_plain(*args, pvec)
    np.testing.assert_allclose(scores.numpy(), want, rtol=RTOL)
    # deltas: the f64 differences of the scores, rounded once
    np.testing.assert_allclose(dll.numpy(), (scores[:, 1:].double() - scores[:, :1].double()).numpy(),
                               rtol=0, atol=np.abs(want).max() * 2e-7)
    # a genome's score depends on its own inputs only: alone == in its batch
    one = mini_grid_plain(*[x[1:2, 3:4] for x in args[:5]], args[5][1:2], pvec)[0]
    assert one.item() == scores[1, 3].item()


def test_plain_chunked_equals_whole(monkeypatch):
    """Genomes taken in several chunks (3 per chunk, not dividing the 28)
    give the scores and deltas of one chunk, bit for bit."""
    rng = np.random.default_rng(3)
    args = [torch.as_tensor(x) for x in genomes(rng, 2, True)]
    tp = convert.params_from_numpy(default_params(fact=4000.0)._asdict())
    pvec = params_vector(tp, torch.tensor(np.float32(np.log(NFPB))))
    whole = mini_grid_plain(*args, pvec)
    monkeypatch.setattr(mini_grid_cuda, "MAX_CELLS", 3 * R * (R - 1) // 2)
    chunked = mini_grid_plain(*args, pvec)
    assert all(torch.equal(a, b) for a, b in zip(chunked, whole))


def test_wrapper_dispatch_on_cpu():
    rng = np.random.default_rng(5)
    args = [torch.as_tensor(x) for x in genomes(rng, 1, False)]
    tp = convert.params_from_numpy(default_params()._asdict())
    pvec = params_vector(tp, torch.tensor(np.float32(np.log(NFPB))))
    scorer = MiniGridScorer()
    got = scorer(*args, pvec)
    want = mini_grid_plain(*args, pvec)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert scorer.n_launches == 0
    with pytest.raises(ValueError):
        scorer.launch(*args, pvec)            # the kernel takes CUDA tensors only


KERNEL_RTOL = 1e-5


def kernel_cells(mid, idc, circ, stot, la, ob, pvec):
    """ll_mini.cu's per-cell algebra in torch over the pairs u < v:
    (scores (M, C) f32, dll (M, C - 1) f32), sums in f64."""
    log_v, v_inter, log_nfpb = pvec[5], pvec[6], pvec[9]
    r = mid.shape[-1]
    row_t = v_inter * torch.exp(la - log_nfpb)             # staged per row
    col_a = torch.exp(la)                                   # staged per column
    cst = torch.where(circ == 1.0, stot, -1.0)
    s = (mid[..., :, None] - mid[..., None, :]).abs()
    cst_u = cst[..., :, None].expand_as(s)
    log_cis = log_cis_plain(s, cst_u >= 0.0, cst_u, pvec)
    same = idc[..., :, None] == idc[..., None, :]
    la_pair = (la[..., :, None] + la[..., None, :]) - log_nfpb
    log_e = torch.where(same, log_cis + la_pair, log_v + la_pair)
    e = torch.where(same, torch.exp(log_e), row_t[..., :, None] * col_a[..., None, :])
    upper = torch.ones((r, r), dtype=torch.bool).triu(1)
    tot = torch.where(upper, ob[:, None] * log_e - e, 0.0).sum(dim=(2, 3), dtype=torch.float64)
    return tot.float(), (tot[:, 1:] - tot[:, :1]).float()


@pytest.mark.parametrize("with_circ", [True, False])
def test_kernel_cell_algebra_matches_plain_and_pallas(with_circ):
    rng = np.random.default_rng(11 + int(with_circ))
    m = 2
    mid, idc, circ, stot, la, ob = genomes(rng, m, with_circ)
    params = default_params(fact=4000.0)
    pallas = make_mini_grid_scorer(R, float(np.log(NFPB)), with_circ=with_circ, interpret=True)
    want = np.stack([np.asarray(pallas(*[jnp.asarray(x[a]) for x in (mid, idc, circ, stot, la, ob)],
                                       params)) for a in range(m)])
    tp = convert.params_from_numpy(params._asdict())
    pvec = params_vector(tp, torch.tensor(np.float32(np.log(NFPB))))
    args = [torch.as_tensor(x) for x in (mid, idc, circ, stot, la, ob)]
    assert bool((args[4] == -1e9).any())                 # padding and inactive rows
    scores, dll = kernel_cells(*args, pvec)
    p_scores, p_dll = mini_grid_plain(*args, pvec)
    np.testing.assert_allclose(scores.numpy(), p_scores.numpy(), rtol=KERNEL_RTOL)
    np.testing.assert_allclose(scores.numpy(), want, rtol=KERNEL_RTOL)
    np.testing.assert_allclose(dll.numpy(), p_dll.numpy(), rtol=0,
                               atol=np.abs(want).max() * 1e-6)


def test_kernel_cells_of_inactive_rows_add_nothing():
    """A row with la = -1e9 (and its zeroed ob) adds exactly 0 to every
    score: E = 0 on its trans cells through the factor exp(la) = 0."""
    rng = np.random.default_rng(4)
    mid, idc, circ, stot, la, ob = genomes(rng, 1, False, n_pad=0, inactive=())
    tp = convert.params_from_numpy(default_params()._asdict())
    pvec = params_vector(tp, torch.tensor(np.float32(np.log(NFPB))))
    args = [torch.as_tensor(x) for x in (mid, idc, circ, stot, la, ob)]
    dead = [torch.cat([x[..., :R], x[..., :3] * 0 + v], -1) for x, v in
            zip(args[:5], (0.0, -7, 0.0, 1.0, -1e9))]
    dead_ob = torch.zeros((1, R + 3, R + 3))
    dead_ob[:, :R, :R] = args[5]
    got = kernel_cells(*[x.contiguous() for x in dead], dead_ob, pvec)[0]
    want = kernel_cells(*args, pvec)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-7)
