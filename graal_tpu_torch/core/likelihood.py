"""Dense Poisson log-likelihood of a genome against the observed contacts.

PyTorch counterpart of ``graal_tpu.core.likelihood``. The likelihood is a
sum over all data-grid pairs (s < t) of the Poisson log-pmf of the observed
count given the expected count, and the expected count of a pair is a
closed form of each sub-fragment's genomic midpoint. Repeat copies are
summed onto the data grid by a scatter-add, skipped when no bin is
repeated.

Every function takes states of shape ``(..., n)`` and returns a result
with the same leading dimensions, so a batch of candidate genomes is
scored in one call. This is the plain dense oracle of the candidate
scorer in :mod:`graal_tpu_torch.ops.likelihood_cuda`.
"""

from __future__ import annotations

import numpy as np
import torch

from graal_tpu_torch.core.model import (RippeParams, poisson_loglik,
                                        rippe_contacts, rippe_contacts_circ)
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.core.subfrags import SubFragTable


def sub_frag_midpoints(state: GenomeState, table: SubFragTable) -> torch.Tensor:
    """Genomic midpoint (kb, within-contig) of every copy-expanded sub-frag:
    start_bp(owner)/1000 + (prefix if ori=+1 else suffix) + len/2."""
    own = table.owner.long()
    start_kb = state.start_bp[..., own].float() / 1000.0
    ori = state.ori[..., own]
    offset = torch.where(ori == 1, table.prefix_kb, table.suffix_kb)
    return start_kb + offset + table.len_kb * 0.5


def expected_copy_matrix(state: GenomeState, table: SubFragTable,
                         params: RippeParams) -> torch.Tensor:
    """(..., K, K) expected contacts between copy-expanded sub-fragment
    pairs: cis via Rippe (circular variant on circular contigs), trans via
    v_inter, both weighted by accu_u * accu_v / n_frags_per_bins. Inactive
    copies contribute zero."""
    mid = sub_frag_midpoints(state, table)
    own = table.owner.long()
    id_c = state.id_c[..., own]
    activ = state.activ[..., own]
    circ = state.circ[..., own]
    s_tot = state.l_cont_bp[..., own].float() / 1000.0

    s = torch.abs(mid[..., None, :] - mid[..., :, None])
    same = id_c[..., :, None] == id_c[..., None, :]
    act = (activ[..., :, None] == 1) & (activ[..., None, :] == 1)
    norm_accu = (table.accu[:, None] * table.accu[None, :]) / table.n_frags_per_bins

    cis_lin = rippe_contacts(s, params)
    cis_circ = rippe_contacts_circ(s, s_tot[..., :, None], params)
    cis = torch.where(circ[..., :, None] == 1, cis_circ, cis_lin)
    e = torch.where(same, cis, params.v_inter) * norm_accu
    return torch.where(act, e, 0.0)


def expected_data_matrix(state: GenomeState, table: SubFragTable,
                         params: RippeParams) -> torch.Tensor:
    """(..., S, S) expected contacts on the data grid (sum over repeat
    copies)."""
    e_copy = expected_copy_matrix(state, table, params)
    if not table.has_repeats:
        return e_copy
    s_dim = table.n_data_sub
    did = table.data_id.long()
    flat_idx = (did[:, None] * s_dim + did[None, :]).reshape(-1)
    lead = e_copy.shape[:-2]
    out = torch.zeros(lead + (s_dim * s_dim,), dtype=e_copy.dtype,
                      device=e_copy.device)
    out.index_add_(-1, flat_idx, e_copy.reshape(lead + (-1,)))
    return out.reshape(lead + (s_dim, s_dim))


def log_likelihood(state: GenomeState, table: SubFragTable, obs: torch.Tensor,
                   params: RippeParams, dtype=torch.float32) -> torch.Tensor:
    """Total log-likelihood: sum over data pairs s < t of
    log P(obs[s, t] | E[s, t]).

    ``obs`` is the (S, S) symmetric observed matrix with zeroed diagonal.
    Row partial sums are accumulated in f32 and combined in ``dtype``.
    """
    e = expected_data_matrix(state, table, params)
    s_dim = e.shape[-1]
    ll = poisson_loglik(e, obs)
    mask = torch.ones((s_dim, s_dim), dtype=torch.bool, device=e.device).triu(1)
    row_sums = torch.where(mask, ll, 0.0).sum(-1)
    return row_sums.to(dtype).sum(-1)


def log_likelihood_ref(state: GenomeState, table: SubFragTable, obs,
                       params: RippeParams) -> float:
    """Slow f64 numpy oracle with the reference's iteration structure: loop
    over copy pairs accumulating the expected data matrix, then the f64
    Poisson log-pmf over the strict upper triangle."""
    s_np = state.to_numpy()
    owner = table.owner.cpu().numpy()
    data_id = table.data_id.cpu().numpy()
    len_kb = table.len_kb.cpu().numpy().astype(np.float64)
    accu = table.accu.cpu().numpy().astype(np.float64)
    prefix = table.prefix_kb.cpu().numpy().astype(np.float64)
    suffix = table.suffix_kb.cpu().numpy().astype(np.float64)
    obs = np.asarray(torch.as_tensor(obs).cpu().numpy(), np.float64)
    kuhn, lm, c1, slope, d, d_max, fact, v_inter = params.astuple_np()

    def rippe(sv):
        if sv <= 0 or sv >= d_max:
            return max(0.0, v_inter)
        n = sv * lm / kuhn
        val = c1 * sv ** slope * np.exp((d - 2) / (n * n + d)) * fact
        return max(val, v_inter)

    def rippe_circ(sv, s_tot):
        if sv <= 0 or sv >= d_max:
            return max(0.0, v_inter)
        K = lm / kuhn
        n = K * sv * (s_tot - sv) / s_tot
        nmax = K
        norm_lin = rippe(sv)
        norm_circ = kuhn ** -3 * nmax ** slope * np.exp((d - 2) / (nmax ** 2 + d)) * fact
        val = kuhn ** -3 * n ** slope * np.exp((d - 2) / (n * n + d)) * fact
        return max(val * norm_lin / norm_circ, v_inter)

    def logpmf(ex, ob):
        if ex == 0:
            return 0.0
        if ob >= 15:
            return ob * np.log(ex) - ex - (ob * np.log(ob) - ob + np.log(np.sqrt(ob * 2 * np.pi)))
        if ob > 0:
            nn = np.floor(ob)
            if nn < 10:
                f = 1.0
                for c in range(1, int(nn) + 1):
                    f *= c
            else:
                f = nn ** nn * np.exp(-nn) * np.sqrt(2 * np.pi * nn)
            return ob * np.log(ex) - ex - np.log(f)
        return -ex

    mids = np.zeros(len(owner))
    for k in range(len(owner)):
        f = owner[k]
        off = prefix[k] if s_np["ori"][f] == 1 else suffix[k]
        mids[k] = s_np["start_bp"][f] / 1000.0 + off + len_kb[k] / 2.0

    e_data = np.zeros((table.n_data_sub, table.n_data_sub))
    for u in range(len(owner)):
        fu = owner[u]
        if s_np["activ"][fu] != 1:
            continue
        for v in range(len(owner)):
            fv = owner[v]
            if s_np["activ"][fv] != 1:
                continue
            na = accu[u] * accu[v] / table.n_frags_per_bins
            if s_np["id_c"][fu] == s_np["id_c"][fv]:
                sv = abs(mids[u] - mids[v])
                if s_np["circ"][fu] == 1:
                    e = rippe_circ(sv, s_np["l_cont_bp"][fu] / 1000.0) * na
                else:
                    e = rippe(sv) * na
            else:
                e = v_inter * na
            e_data[data_id[u], data_id[v]] += e

    total = 0.0
    for si in range(table.n_data_sub):
        for ti in range(si + 1, table.n_data_sub):
            total += logpmf(e_data[si, ti], obs[si, ti])
    return total
