"""Parity of graal_tpu_torch.core.model with the JAX package.

Device curves: both packages evaluate the same f32 expressions; XLA-CPU
and torch may take different libm paths for pow / exp / log, so the
curves are held to rtol 2e-6 (a few f32 ulps). Parameter construction and
the host-side numpy/scipy fit are the same arithmetic: exact equality.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import model as jm
from graal_tpu_torch.core import model as tm
from tests import test_torch_state  # noqa: F401  (one torch thread per worker)

CURVE_RTOL = 2e-6

ARGS = dict(kuhn=1.0, lm=9.6, slope=-1.5, d=3.0, fact=8000.0, d_max=900.0,
            v_inter=0.1)


def both_params(**kw):
    a = dict(ARGS, **kw)
    return jm.RippeParams.create(**a), tm.RippeParams.create(**a)


def test_params_create_bit_exact():
    for kw in ({}, dict(kuhn=1.3, lm=11.0, slope=-1.2, fact=5000.0)):
        jp, tp = both_params(**kw)
        for f in jm.RippeParams._fields:
            t = getattr(tp, f)
            assert t.dtype == torch.float32 and t.dim() == 0
            assert np.float32(t.item()) == np.float32(getattr(jp, f)), f
        assert tp.astuple_np() == jp.astuple_np()


@pytest.mark.parametrize("kw", [{}, dict(slope=-1.1, d_max=400.0)])
def test_rippe_curves(kw):
    jp, tp = both_params(**kw)
    s = np.concatenate([[0.0, 1e-3, 0.5], np.geomspace(0.01, 2000.0, 200)]
                       ).astype(np.float32)
    s_tot = np.full_like(s, 1500.0)
    np.testing.assert_allclose(
        tm.rippe_contacts(torch.as_tensor(s), tp).numpy(),
        np.asarray(jm.rippe_contacts(jnp.asarray(s), jp)), rtol=CURVE_RTOL)
    np.testing.assert_allclose(
        tm.rippe_contacts_circ(torch.as_tensor(s), torch.as_tensor(s_tot), tp).numpy(),
        np.asarray(jm.rippe_contacts_circ(jnp.asarray(s), jnp.asarray(s_tot), jp)),
        rtol=CURVE_RTOL)
    rng = np.random.default_rng(0)
    same = rng.random(s.shape) < 0.5
    circ = rng.random(s.shape) < 0.3
    na = rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
    np.testing.assert_allclose(
        tm.expected_contacts(torch.as_tensor(s), torch.as_tensor(same),
                             torch.as_tensor(circ), torch.as_tensor(s_tot),
                             torch.as_tensor(na), tp).numpy(),
        np.asarray(jm.expected_contacts(jnp.asarray(s), same, circ,
                                        jnp.asarray(s_tot), jnp.asarray(na), jp)),
        rtol=CURVE_RTOL)


def test_poisson_loglik_branches():
    rng = np.random.default_rng(1)
    ex = np.concatenate([[0.0, -1.0, 1e-3], rng.uniform(0.01, 50.0, 300)]
                        ).astype(np.float32)
    ob = np.concatenate([[3.0, 2.0, 0.0],
                         rng.integers(0, 40, 300)]).astype(np.float32)
    # every branch: ex == 0, ex < 0, ob == 0, 0 < ob < 10, 10 <= ob < 15, ob >= 15
    assert (ob == 0).any() and ((ob > 10) & (ob < 15)).any() and (ob >= 15).any()
    got = tm.poisson_loglik(torch.as_tensor(ex), torch.as_tensor(ob)).numpy()
    want = np.asarray(jm.poisson_loglik(jnp.asarray(ex), jnp.asarray(ob)))
    assert got[0] == 0.0 and got[1] == -np.inf
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL, atol=1e-5)


def test_host_fit_matches():
    rng = np.random.default_rng(2)
    x = np.geomspace(1.0, 500.0, 40)
    p = [1.2, 10.0, -1.4, 3.0, 9000.0]
    np.testing.assert_array_equal(tm.peval(x, p), jm.peval(x, p))
    y = np.log(jm.peval(x, p)) + rng.normal(0, 0.05, x.shape)
    np.testing.assert_array_equal(tm.log_residuals(p[:3] + [p[4]], y, x),
                                  jm.log_residuals(p[:3] + [p[4]], y, x))
    fit_t, est_t = tm.estimate_param_rippe(np.exp(y), x)
    fit_j, est_j = jm.estimate_param_rippe(np.exp(y), x)
    np.testing.assert_array_equal(fit_t, fit_j)
    np.testing.assert_array_equal(est_t, est_j)
    for v in (0.1, 1e-3, 50.0):
        assert tm.estimate_max_dist_intra(fit_t, v) == jm.estimate_max_dist_intra(fit_j, v)


def test_fit_rippe_from_matrix():
    from graal_tpu.utils.synthetic import (make_genome, simulate_contacts,
                                           default_params)
    state, table = make_genome(36, 3, subs_per_bin=1, seed=4)
    obs = simulate_contacts(state, table, default_params(fact=5000.0), seed=4)
    sub = {k: np.asarray(getattr(state, k)) for k in
           ("id_c", "start_bp", "len_bp", "pos")}
    bt = tm.bin_cis_contacts(obs, sub["id_c"], sub["start_bp"], sub["len_bp"],
                             sub["pos"], 120.0, 9.0)
    bj = jm.bin_cis_contacts(obs, sub["id_c"], sub["start_bp"], sub["len_bp"],
                             sub["pos"], 120.0, 9.0)
    np.testing.assert_array_equal(bt[0], bj[0])
    np.testing.assert_array_equal(bt[1], bj[1])
    pt, *rest_t = tm.fit_rippe_from_matrix(obs, sub, 0.1, 120.0, 9.0)
    pj, *rest_j = jm.fit_rippe_from_matrix(obs, sub, 0.1, 120.0, 9.0)
    assert pt.astuple_np() == pj.astuple_np()
    for a, b in zip(rest_t, rest_j):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def dataset_coo(tmp_path_factory):
    """Level-0 COO triplets and genome of a synthetic dataset (3 contigs)."""
    from graal_tpu.io import pyramid as jpyr
    from graal_tpu.utils.dataset import write_synthetic_dataset

    d = str(tmp_path_factory.mktemp("tmodel") / "ds")
    write_synthetic_dataset(d, n_bins=90, n_contigs=3, seed=2)
    lev = jpyr.build_and_filter(d, 2, 3).get_level(0)
    coo = lev.sparse.tocoo()
    return coo.row, coo.col, coo.data, lev.genome_soa(), np.asarray(lev.frags.chrom)


@pytest.mark.parametrize("symmetric", [False, True])
def test_coo_fits_match_jax(dataset_coo, symmetric):
    """bin_cis_contacts_coo, mean_value_trans_from_coo (several contigs and
    the single-contig fallback) and fit_rippe_from_coo equal the JAX ones
    exactly, on upper-triangular and on symmetric triplets."""
    rows, cols, vals, soa, chrom = dataset_coo
    if symmetric:
        rows, cols, vals = (np.concatenate([rows, cols]), np.concatenate([cols, rows]),
                            np.concatenate([vals, vals]))
    args = (rows, cols, vals, soa["id_c"], soa["start_bp"], soa["len_bp"], soa["pos"],
            6.0, 0.3)
    for a, b in zip(tm.bin_cis_contacts_coo(*args), jm.bin_cis_contacts_coo(*args)):
        np.testing.assert_array_equal(a, b)
    v_t = tm.mean_value_trans_from_coo(rows, cols, vals, chrom)
    assert v_t == jm.mean_value_trans_from_coo(rows, cols, vals, chrom) and v_t > 0
    one = np.zeros(len(chrom), np.int64)
    assert tm.mean_value_trans_from_coo(rows, cols, vals, one) == \
        jm.mean_value_trans_from_coo(rows, cols, vals, one)
    pt, *rest_t = tm.fit_rippe_from_coo(rows, cols, vals, soa, v_t, 6.0, 0.3)
    pj, *rest_j = jm.fit_rippe_from_coo(rows, cols, vals, soa, v_t, 6.0, 0.3)
    assert pt.astuple_np() == pj.astuple_np()
    for a, b in zip(rest_t, rest_j):
        np.testing.assert_array_equal(a, b)
