"""Rippe polymer contact model: device-side curve evaluation + host-side fit.

PyTorch counterpart of ``graal_tpu.core.model``: the expected cis contact
count vs genomic distance (linear and circular contigs), the per-pixel
Poisson log-pmf with the reference's Stirling branches, and the host-side
least-squares fit of (kuhn, lm, slope, A) with the cis/trans cross-over
solve, from a dense matrix or from COO triplets (the chr1-scale fit, never
densifying). Device code is plain f32 tensor math; the fit is numpy/scipy
at setup time.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

# Fixed exponent of the Rippe exponential term (the reference fits with d=3).
DEFAULT_D = 3.0

# Stirling cutoff for the Poisson log-pmf.
_STIRLING_LIM = 15.0
_LOG_FACT_TABLE = tuple(math.lgamma(n + 1) for n in range(10))


class RippeParams(NamedTuple):
    """Contact-model parameters, each a 0-d float32 tensor on the device, so
    a sampling loop reads them without a host sync."""

    kuhn: torch.Tensor
    lm: torch.Tensor
    c1: torch.Tensor
    slope: torch.Tensor
    d: torch.Tensor
    d_max: torch.Tensor
    fact: torch.Tensor
    v_inter: torch.Tensor

    @staticmethod
    def create(kuhn, lm, slope, d, fact, d_max, v_inter,
               device=None) -> "RippeParams":
        """Build params, deriving c1 = 0.53 (lm/kuhn)^slope kuhn^-3 in f64 on
        the host before rounding to f32."""
        c1 = (0.53 * np.power(lm / kuhn, slope)) * np.power(kuhn, -3.0)

        def f32(x):
            return torch.tensor(np.float32(x), device=device)

        return RippeParams(
            kuhn=f32(kuhn), lm=f32(lm), c1=f32(c1), slope=f32(slope),
            d=f32(d), d_max=f32(d_max), fact=f32(fact), v_inter=f32(v_inter))

    def astuple_np(self):
        return tuple(float(x) for x in self)


def rippe_contacts(s: torch.Tensor, p: RippeParams) -> torch.Tensor:
    """Expected cis contacts at genomic distance ``s`` (kb), linear contig.

    c1 * s^slope * exp((d-2) / ((s*lm/kuhn)^2 + d)) * fact for
    0 < s < d_max, else 0; clamped below by v_inter.
    """
    n = s * p.lm / p.kuhn
    val = p.c1 * torch.pow(s, p.slope) * torch.exp((p.d - 2.0) / (n * n + p.d)) * p.fact
    in_range = (s > 0.0) & (s < p.d_max)
    return torch.maximum(torch.where(in_range, val, 0.0), p.v_inter)


def rippe_contacts_circ(s: torch.Tensor, s_tot: torch.Tensor,
                        p: RippeParams) -> torch.Tensor:
    """Expected cis contacts on a circular contig of total length ``s_tot``
    kb: effective distance n = K*s*(s_tot-s)/s_tot with K = lm/kuhn,
    normalised by the linear/circular ratio at nmax = K."""
    K = p.lm / p.kuhn
    nmax = K * 1.0
    n = K * s * (s_tot - s) / s_tot
    kuhn_m3 = torch.pow(p.kuhn, -3.0)
    norm_lin = rippe_contacts(s, p)
    norm_circ = kuhn_m3 * torch.pow(nmax, p.slope) * torch.exp((p.d - 2.0) / (nmax * nmax + p.d)) * p.fact
    val = kuhn_m3 * torch.pow(n, p.slope) * torch.exp((p.d - 2.0) / (n * n + p.d)) * p.fact
    result = val * norm_lin / norm_circ
    in_range = (s > 0.0) & (s < p.d_max)
    return torch.maximum(torch.where(in_range, result, 0.0), p.v_inter)


def expected_contacts(s, same_contig, circ, s_tot, norm_accu, p: RippeParams):
    """Expected contacts for sub-fragment pairs: cis via Rippe (circular
    variant on circular contigs), trans via v_inter, weighted by norm_accu."""
    cis_lin = rippe_contacts(s, p)
    cis_circ = rippe_contacts_circ(s, s_tot, p)
    cis = torch.where(circ, cis_circ, cis_lin)
    return torch.where(same_contig, cis, p.v_inter) * norm_accu


@functools.cache
def _log_fact_table(device: torch.device) -> torch.Tensor:
    """The 10-entry lgamma table on ``device``, copied there once: a step
    captured into a CUDA graph may not copy from the host."""
    return torch.tensor(_LOG_FACT_TABLE, dtype=torch.float32, device=device)


def _log_factorial_ref(ob: torch.Tensor) -> torch.Tensor:
    """log(factorial(ob)) with the reference's split: floor the argument,
    exact for n < 10 (a 10-entry lgamma table), Stirling otherwise."""
    n = torch.floor(ob)
    exact = _log_fact_table(ob.device)[n.int().clamp(0, 9).long()]
    stirling = n * torch.log(n) - n + 0.5 * torch.log(2.0 * np.pi * n)
    return torch.where(n < 10.0, exact, stirling)


def poisson_loglik(ex: torch.Tensor, ob: torch.Tensor) -> torch.Tensor:
    """Poisson log-pmf log P(ob | ex) with the reference's branches: 0 when
    ex == 0; Stirling expansion of log(ob!) when ob >= 15; exact/Stirling
    factorial for 0 < ob < 15; -ex when ob == 0; -inf when ex < 0."""
    log_ex = torch.log(torch.where(ex > 0.0, ex, 1.0))
    safe_ob = torch.where(ob > 0.0, ob, 1.0)
    big = ob * log_ex - ex - (ob * torch.log(safe_ob) - ob + 0.5 * torch.log(safe_ob * 2.0 * np.pi))
    small = ob * log_ex - ex - _log_factorial_ref(safe_ob)
    res = torch.where(ob >= _STIRLING_LIM, big, torch.where(ob > 0.0, small, -ex))
    return torch.where(ex > 0.0, res,
                       torch.where(ex == 0.0, 0.0, -math.inf))


# ---------------------------------------------------------------------------
# Host-side parameter estimation (setup path; numpy/scipy)
# ---------------------------------------------------------------------------

def peval(x, param):
    """Rippe curve value for fit params [kuhn, lm, slope, d, A]."""
    kuhn, lm, slope, d, A = param
    n = lm * np.asarray(x, np.float64) / kuhn
    return A * (0.53 * kuhn ** -3.0 * np.power(n, slope) * np.exp((d - 2.0) / (n * n + d)))


def log_residuals(p, y, x, d=DEFAULT_D):
    """Log-space residuals of the 4-parameter Rippe fit."""
    kuhn, lm, slope, A = p
    rippe = (
        np.log(A)
        + np.log(0.53)
        - 3.0 * np.log(kuhn)
        + slope * (np.log(lm * x) - np.log(kuhn))
        + (d - 2.0) / (np.power(lm * x / kuhn, 2.0) + d)
    )
    return y - rippe


def estimate_param_rippe(y_meas, x_bins, d=DEFAULT_D):
    """Least-squares fit of (kuhn, lm, slope, A) on log contacts vs distance
    from the guess kuhn=1, lm=9.6, slope=-1.5, A=sum(y), falling back to the
    guess on NaN. Returns ([kuhn, lm, slope, d, A], y_estim)."""
    import warnings

    from scipy.optimize import leastsq

    y_meas = np.asarray(y_meas, np.float64)
    x_bins = np.asarray(x_bins, np.float64)
    kuhn, lm, slope = 1.0, 9.6, -1.5
    A = float(np.sum(y_meas))
    p0 = [kuhn, lm, slope, A]
    with warnings.catch_warnings():
        # the optimiser wanders through invalid regions (log of negatives);
        # the NaN fallback below handles failure
        warnings.simplefilter("ignore", RuntimeWarning)
        plsq = leastsq(log_residuals, p0, args=(np.log(y_meas), x_bins))
    kuhn_x, lm_x, slope_x, A_x = plsq[0]
    plsq_out = [kuhn_x, lm_x, slope_x, d, A_x]
    if np.any(np.isnan(np.array(plsq_out))):
        plsq_out = [kuhn, lm, slope, d, A]
    y_estim = peval(x_bins, plsq_out)
    return plsq_out, y_estim


def estimate_max_dist_intra(p, val_inter):
    """Solve rippe(s) == val_inter for the cis/trans cross-over distance
    (fsolve from s0=500), verified, with a log-space bisection fallback."""
    import warnings

    from scipy.optimize import fsolve

    def residual(x):
        return val_inter - peval(x, p)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        x = float(fsolve(residual, 500.0)[0])
    if np.isfinite(x) and x > 0 and abs(peval(x, p) - val_inter) <= 1e-3 * abs(val_inter):
        return x
    lo, hi = 1e-2, 1e7
    if peval(lo, p) < val_inter or peval(hi, p) > val_inter:
        return x  # no bracket; keep fsolve's answer (reference behaviour)
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        if peval(mid, p) > val_inter:
            lo = mid
        else:
            hi = mid
    return math.sqrt(lo * hi)


def bin_cis_contacts(hic_matrix, sub_id_c, sub_start_bp, sub_len_bp, sub_pos,
                     max_dist_kb, size_bin_kb):
    """Mean cis contact count per genomic-distance bin over same-contig
    sub-fragment pairs (midpoint distance in kb, floor-binned); empty or
    zero-mean bins fall back to 1e-10. Returns (bins, mean_contacts)."""
    hic_matrix = np.asarray(hic_matrix)
    id_c = np.asarray(sub_id_c)
    start = np.asarray(sub_start_bp, np.float64)
    length = np.asarray(sub_len_bp, np.float64)

    bins = np.arange(size_bin_kb, max_dist_kb + size_bin_kb, size_bin_kb)
    n = len(id_c)
    iu, ju = np.triu_indices(n, k=1)
    same = id_c[iu] == id_c[ju]
    iu, ju = iu[same], ju[same]
    mid = (start + length / 2.0) / 1000.0
    d = np.abs(mid[ju] - mid[iu])
    keep = d < max_dist_kb
    d = d[keep]
    counts = hic_matrix[iu[keep], ju[keep]]
    id_bin = (d / size_bin_kb).astype(np.int64)
    id_bin = np.clip(id_bin, 0, len(bins) - 1)
    sums = np.bincount(id_bin, weights=counts, minlength=len(bins))
    nums = np.bincount(id_bin, minlength=len(bins))
    mean_contacts = np.full(len(bins), 1e-10, np.float64)
    nz = nums > 0
    mean_contacts[nz] = sums[nz] / nums[nz]
    mean_contacts[mean_contacts == 0] = 1e-10
    return bins, mean_contacts


def fit_rippe_from_matrix(hic_matrix, sub_frags, mean_value_trans,
                          max_dist_kb, size_bin_kb, device=None):
    """Full parameter estimation: bin the cis contacts, fit the curve, solve
    the cross-over. ``sub_frags`` is a dict with id_c/start_bp/len_bp/pos
    arrays of the sub-level genome. Returns (RippeParams, bins,
    mean_contacts, y_estim)."""
    bins, mean_contacts = bin_cis_contacts(
        hic_matrix, sub_frags["id_c"], sub_frags["start_bp"], sub_frags["len_bp"],
        sub_frags["pos"], max_dist_kb, size_bin_kb)
    fit_param, y_estim = estimate_param_rippe(mean_contacts, bins)
    d_max = estimate_max_dist_intra(fit_param, mean_value_trans)
    kuhn, lm, slope, d, fact = fit_param
    params = RippeParams.create(kuhn=kuhn, lm=lm, slope=slope, d=d, fact=fact,
                                d_max=d_max, v_inter=mean_value_trans,
                                device=device)
    return params, bins, mean_contacts, y_estim


def bin_cis_contacts_coo(rows, cols, vals, sub_id_c, sub_start_bp,
                         sub_len_bp, sub_pos, max_dist_kb, size_bin_kb,
                         edge_chunk: int = 64):
    """Mean cis contact count per genomic-distance bin from COO triplets —
    :func:`bin_cis_contacts` without ever densifying (the chr1-scale fit
    path; a dense S x S matrix is ~10^12 cells at 500k sub-fragments).

    Numerator: observed counts binned directly from the nnz entries.
    Denominator (all same-contig pairs per distance bin, zero entries
    included — the reference's host double loop enumerates every pair,
    cuda_lib_gl.py:1242-1270): pairs within the ``max_dist_kb`` window
    are enumerated explicitly per contig over the sorted midpoints
    (window found by one searchsorted), in bounded chunks, with the SAME
    float expression as the numerator and the dense function — a
    cumulative-searchsorted count disagrees with floor binning at exact
    bin edges, which regular fragment sizes hit constantly.
    O(nnz + pairs-in-window), independent of the genome-squared size.

    ``rows/cols/vals`` may be upper-triangular or symmetric; both
    orientations of a pair are halved when present twice.

    Returns (bins, mean_contacts) identical to the dense function.
    """
    id_c = np.asarray(sub_id_c)
    start = np.asarray(sub_start_bp, np.float64)
    length = np.asarray(sub_len_bp, np.float64)
    mid = (start + length / 2.0) / 1000.0
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, np.float64)

    bins = np.arange(size_bin_kb, max_dist_kb + size_bin_kb, size_bin_kb)
    n_bins = len(bins)

    # ---- numerator: observed sums over nnz cis entries ---------------------
    upper = rows < cols      # one orientation (symmetric input stores both)
    r, c, v = rows[upper], cols[upper], vals[upper]
    cis = id_c[r] == id_c[c]
    r, c, v = r[cis], c[cis], v[cis]
    d = np.abs(mid[c] - mid[r])
    keep = d < max_dist_kb
    id_bin = np.clip((d[keep] / size_bin_kb).astype(np.int64), 0, n_bins - 1)
    sums = np.bincount(id_bin, weights=v[keep], minlength=n_bins)

    # ---- denominator: ALL cis pairs per distance bin ------------------------
    pair_chunk = edge_chunk * 1024 * 1024 // 16    # pairs per block
    nums = np.zeros(n_bins, np.float64)
    for cid in np.unique(id_c):
        m = np.sort(mid[id_c == cid])
        k = len(m)
        if k < 2:
            continue
        # window end per row (+1 ulp margin: the explicit d < max_dist
        # filter below is the authoritative cut)
        hi = np.searchsorted(m, m + max_dist_kb * (1.0 + 1e-12),
                             side="right")
        lens = np.maximum(hi - np.arange(1, k + 1, dtype=np.int64), 0)
        row_chunk = max(1, int(pair_chunk // max(int(lens.max()), 1)))
        for lo in range(0, k, row_chunk):
            ls = lens[lo:lo + row_chunk]
            tot = int(ls.sum())
            if tot == 0:
                continue
            i_rep = np.repeat(np.arange(lo, lo + len(ls)), ls)
            off = np.arange(tot) - np.repeat(np.cumsum(ls) - ls, ls)
            j = i_rep + 1 + off
            dp = np.abs(m[j] - m[i_rep])
            kp = dp < max_dist_kb
            bb = np.clip((dp[kp] / size_bin_kb).astype(np.int64),
                         0, n_bins - 1)
            nums += np.bincount(bb, minlength=n_bins)

    mean_contacts = np.full(n_bins, 1e-10, np.float64)
    nz = nums > 0
    mean_contacts[nz] = sums[nz] / nums[nz]
    mean_contacts[mean_contacts == 0] = 1e-10
    return bins, mean_contacts


def mean_value_trans_from_coo(rows, cols, vals, chrom) -> float:
    """Mean inter-contig contact value from COO triplets
    (pyramid_sparse.py:1350-1373 without densifying): trans sum over nnz
    entries divided by the ANALYTIC trans pair count (zero cells count).
    Single-chromosome fallback mirrors Level.mean_value_trans: the most
    distant decile of cis pairs approximates the background, floored at
    1e-6."""
    chrom = np.asarray(chrom)
    n = len(chrom)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, np.float64)
    upper = rows < cols
    r, c, v = rows[upper], cols[upper], vals[upper]
    _, counts = np.unique(chrom, return_counts=True)
    total_pairs = n * (n - 1) // 2
    cis_pairs = int(np.sum(counts * (counts - 1) // 2))
    trans_pairs = total_pairs - cis_pairs
    if trans_pairs > 0:
        trans_sum = float(v[chrom[r] != chrom[c]].sum())
        # dense counterpart averages over the full (asymmetric) trans block;
        # upper-triangle sum / upper-triangle count is the same ratio
        return trans_sum / trans_pairs
    k = max(1, int(0.9 * n))
    far_pairs = (n - k) * (n - k + 1) // 2
    far_sum = float(v[(c - r) >= k].sum())
    return float(max(far_sum / far_pairs if far_pairs else 0.0, 1e-6))


def fit_rippe_from_coo(rows, cols, vals, sub_frags, mean_value_trans,
                       max_dist_kb, size_bin_kb, device=None):
    """:func:`fit_rippe_from_matrix` from COO triplets (no densification)."""
    bins, mean_contacts = bin_cis_contacts_coo(
        rows, cols, vals, sub_frags["id_c"], sub_frags["start_bp"],
        sub_frags["len_bp"], sub_frags["pos"], max_dist_kb, size_bin_kb)
    fit_param, y_estim = estimate_param_rippe(mean_contacts, bins)
    d_max = estimate_max_dist_intra(fit_param, mean_value_trans)
    kuhn, lm, slope, d, fact = fit_param
    params = RippeParams.create(kuhn=kuhn, lm=lm, slope=slope, d=d, fact=fact,
                                d_max=d_max, v_inter=mean_value_trans,
                                device=device)
    return params, bins, mean_contacts, y_estim
