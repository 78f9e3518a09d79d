"""Alternative contact model: the 3-segment broken power law.

PyTorch counterpart of ``graal_tpu.core.model_hic``: segments
A s^alpha0 / s^alpha1 / s^alpha2, continuous at d0 and d1, gated to
(0, d_max) and clamped by v_inter; the host-side fit (numpy / scipy, as
the JAX package); and a batched likelihood scorer for the EM sampler
(no circular variant, no repeat tables, as in the JAX package).

The JAX package has no Pallas kernel for this model (its scorer is a
vmapped jnp function on every backend), so the scorer here is plain torch
on the run's device. It scores candidates in chunks so that its (B, K, K)
temporaries stay within a few GB at K ~ 3,000.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graal_tpu_torch.core.model import bin_cis_contacts, poisson_loglik
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.core.subfrags import SubFragTable

# cells of one candidate chunk of the scorer (a few f32 (chunk, K, K)
# temporaries live at once)
MAX_CELLS = 1 << 26


class HiCParams(NamedTuple):
    """param_simu_exp layout (cuda_lib_gl.py:139-142), each a 0-d float32
    tensor."""

    d0: torch.Tensor
    d1: torch.Tensor
    d_max: torch.Tensor
    alpha_0: torch.Tensor
    alpha_1: torch.Tensor
    alpha_2: torch.Tensor
    fact: torch.Tensor       # A
    v_inter: torch.Tensor

    @staticmethod
    def create(d0, d1, alpha_0, alpha_1, alpha_2, fact, d_max, v_inter,
               device=None) -> "HiCParams":
        return HiCParams(*[torch.tensor(np.float32(x), device=device) for x in
                           (d0, d1, d_max, alpha_0, alpha_1, alpha_2, fact, v_inter)])

    @property
    def slope(self):
        # the metric series' slope: the mid-range exponent
        return self.alpha_1


def hic_contacts(s, p: HiCParams) -> torch.Tensor:
    """Expected cis contacts: piecewise power law continuous at d0 and d1
    (optim_hic_curve.py:64-88), gated to (0, d_max), clamped by v_inter."""
    s = torch.as_tensor(s, dtype=torch.float32)
    safe = torch.clamp_min(s, 1e-9)
    lim0 = p.fact * torch.pow(p.d0, p.alpha_0 - p.alpha_1)
    lim1 = lim0 * torch.pow(p.d1, p.alpha_1 - p.alpha_2)
    seg0 = p.fact * torch.pow(safe, p.alpha_0)
    seg1 = lim0 * torch.pow(safe, p.alpha_1)
    seg2 = lim1 * torch.pow(safe, p.alpha_2)
    val = torch.where(s <= p.d0, seg0, torch.where(s <= p.d1, seg1, seg2))
    in_range = (s > 0.0) & (s < p.d_max)
    return torch.maximum(torch.where(in_range, val, 0.0), p.v_inter)


def peval(x, param):
    """Host curve for fit params [d0, d1, a0, a1, a2, A]
    (optim_hic_curve.py:64-88)."""
    d0, d1, a0, a1, a2, A = param
    x = np.asarray(x, np.float64)
    lim0 = A * np.power(d0, a0 - a1)
    lim1 = lim0 * np.power(d1, a1 - a2)
    out = np.where(x <= d0, A * np.power(np.maximum(x, 1e-12), a0),
                   np.where(x <= d1, lim0 * np.power(x, a1),
                            lim1 * np.power(x, a2)))
    return np.where(x <= 0, 0.0, out)


def estimate_param_hic(y_meas, x_bins):
    """leastsq fit of the log curve (optim_hic_curve.py:91-108): initial
    d0 = 20, d1 = 300, slopes -1.5, A = max(y) x0^1.5."""
    import warnings

    from scipy.optimize import leastsq

    y_meas = np.asarray(y_meas, np.float64)
    x_bins = np.asarray(x_bins, np.float64)
    x0 = x_bins.min()
    a0 = -1.5
    p0 = [20.0, 300.0, a0, -1.5, -1.5, float(np.max(y_meas) * x0 ** (-a0))]

    def log_residuals(p, y, x):
        with np.errstate(all="ignore"):
            lv = np.log(peval(x, p))
        lv = np.where(np.isfinite(lv), lv, -1e15)
        return y - lv

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        plsq = leastsq(log_residuals, p0, args=(np.log(y_meas), x_bins))
    fit = list(plsq[0])
    if np.any(np.isnan(fit)):
        fit = p0
    with np.errstate(over="ignore"):
        return fit, peval(x_bins, fit)


def estimate_max_dist_intra(p, val_inter):
    """Crossover solve peval(s) == v_inter from s0 = d1
    (optim_hic_curve.py:137-147), falling back to a log bisection when
    fsolve misses (the curve's overflow warnings silenced, as in the
    solve)."""
    import math
    import warnings

    from scipy.optimize import fsolve

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        x = float(fsolve(lambda s: val_inter - peval(s, p), p[1])[0])
        if np.isfinite(x) and x > 0 and abs(peval(x, p) - val_inter) <= 1e-3 * abs(val_inter):
            return x
        lo, hi = 1e-2, 1e7
        if peval(lo, p) < val_inter or peval(hi, p) > val_inter:
            return x
        for _ in range(200):
            mid = math.sqrt(lo * hi)
            if peval(mid, p) > val_inter:
                lo = mid
            else:
                hi = mid
    return math.sqrt(lo * hi)


def fit_hic_from_matrix(hic_matrix, sub_frags, mean_value_trans, max_dist_kb,
                        size_bin_kb, device=None) -> HiCParams:
    """Full estimation for the broken-power-law model
    (estimate_parameters_rv, cuda_lib_gl.py:1296-1352)."""
    bins, mean_contacts = bin_cis_contacts(
        hic_matrix, sub_frags["id_c"], sub_frags["start_bp"], sub_frags["len_bp"],
        sub_frags["pos"], max_dist_kb, size_bin_kb)
    fit, _ = estimate_param_hic(mean_contacts, bins)
    d_max = estimate_max_dist_intra(fit, mean_value_trans)
    d0, d1, a0, a1, a2, A = fit
    return HiCParams.create(d0=d0, d1=d1, alpha_0=a0, alpha_1=a1, alpha_2=a2, fact=A,
                            d_max=d_max, v_inter=mean_value_trans, device=device)


def log_likelihood_hic(states: GenomeState, table: SubFragTable, obs,
                       params: HiCParams) -> torch.Tensor:
    """Dense pair-grid likelihood under the broken power law of a genome
    (fields (n,), returns a 0-d tensor) or a batch (fields (B, n), returns
    (B,)); the structure of ``core.likelihood.log_likelihood``, repeat-free
    tables only."""
    if table.has_repeats:
        raise ValueError("the HiC model scores repeat-free tables only")
    obs = torch.as_tensor(obs, dtype=torch.float32, device=table.owner.device)
    own = table.owner.long()
    start_kb = states.start_bp[..., own].float() / 1000.0
    ori = states.ori[..., own]
    mid = start_kb + torch.where(ori == 1, table.prefix_kb, table.suffix_kb) \
        + table.len_kb * 0.5
    idc = states.id_c[..., own]
    act = states.activ[..., own] == 1

    s = torch.abs(mid[..., :, None] - mid[..., None, :])
    same = idc[..., :, None] == idc[..., None, :]
    active = act[..., :, None] & act[..., None, :]
    norm_accu = (table.accu[:, None] * table.accu[None, :]) / table.n_frags_per_bins
    e = torch.where(same, hic_contacts(s, params), params.v_inter) * norm_accu
    e = torch.where(active, e, 0.0)
    ll = poisson_loglik(e, obs)
    k = e.shape[-1]
    upper = torch.ones((k, k), dtype=torch.bool, device=e.device).triu(1)
    return torch.where(upper, ll, 0.0).sum((-2, -1))


def make_hic_scorer(table: SubFragTable, obs, max_cells: int = MAX_CELLS):
    """Batched scorer ``(states (B, n), params) -> (B,)`` pluggable into
    the EM sampler, in candidate chunks of about ``max_cells`` cells."""
    obs_t = torch.as_tensor(obs, dtype=torch.float32, device=table.owner.device)
    chunk = max(1, max_cells // (table.n_subs * table.n_subs))

    def score(states: GenomeState, params: HiCParams) -> torch.Tensor:
        b = states.pos.shape[0]
        return torch.cat([
            log_likelihood_hic(GenomeState(*[x[b0:b0 + chunk] for x in states]), table,
                               obs_t, params)
            for b0 in range(0, b, chunk)])

    return score
