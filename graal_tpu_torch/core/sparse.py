"""Sparse observed contacts and the chr1-scale likelihood.

PyTorch counterpart of ``graal_tpu.core.sparse``. A dense S x S observed
matrix is out of reach at chr1 scale (~10^10 cells at 100k bins), so the
observed map is kept as symmetric CSR triplets and the full Poisson
log-likelihood is evaluated without a pair grid:

    L = 0.5 * sum_{sym nnz} ob * log e        (observed pairs only)
        - sum_{s<t} e                          (expected mass)
        + logfact_const                        (data constant)

The expected mass splits into an analytic trans term plus a banded cis
correction over the genome-sorted sub order (offsets 1..w): the Rippe
curve is exactly v_inter outside (0, d_max), so only same-contig pairs
within d_max differ from the trans floor.

The JAX package walks the band one offset at a time (a ``fori_loop``);
here the offsets are taken in (K, chunk) slabs, a few launches per slab
instead of ~15 per offset. Elementwise math is f32 as in the JAX package;
every sum is taken in f64 and the result rounded to f32 once, so the port
agrees with JAX to f32 summation error (rtol 1e-5 in the tests).

Copy-expanded (repeat) tables evaluate the same decomposition with the
expectation of each observed data pair summed over its copy pairs, and
same-data-bin copy pairs left out of the mass (:func:`make_sparse_loglik`
routes them).

The TPU-only ``packed`` window storage of the JAX ``SparseObs`` is not
carried over: CSR windows are read from ``cols`` / ``vals`` directly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from graal_tpu_torch.core.model import RippeParams, expected_contacts
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.core.subfrags import SubFragTable


class SparseObs(NamedTuple):
    """Symmetric sparse observed matrix (both (u, v) and (v, u) stored),
    sorted by (row, col), CSR-indexable through ``row_start``."""

    rows: torch.Tensor       # (nnz_sym,) int32
    cols: torch.Tensor       # (nnz_sym,) int32
    vals: torch.Tensor       # (nnz_sym,) float32
    row_start: torch.Tensor  # (K + 1,) int64 indptr
    row_cap: int             # max entries of any row (static window width)
    n: int                   # K data subs
    logfact_const: float     # -sum_{s<t} log(ob!)


def logfact_entries(vals: np.ndarray) -> np.ndarray:
    """Per-entry log(ob!) with the reference's factorial branches: Stirling
    expansion for ob >= 15, floor + exact factorial < 10, floor + Stirling
    10..14. Zero counts map to 0."""
    ob = np.asarray(vals, np.float64)
    out = np.zeros_like(ob)
    pos = ob > 0
    big = pos & (ob >= 15)
    out[big] = (ob[big] * np.log(ob[big]) - ob[big]
                + np.log(np.sqrt(ob[big] * 2 * np.pi)))
    mid = pos & (ob >= 10) & ~big
    nn = np.floor(ob[mid])
    out[mid] = nn * np.log(nn) - nn + 0.5 * np.log(2 * np.pi * nn)
    small = pos & (ob < 10)
    # a 10-entry lgamma table (the JAX package evaluates the same values
    # with math.lgamma entry by entry)
    table = np.array([math.lgamma(k + 1) for k in range(10)])
    out[small] = table[np.floor(ob[small]).astype(np.int64)]
    return out


def sparse_from_coo(rows, cols, vals, n: int, device=None) -> SparseObs:
    """Build from upper-triangular (or unordered) COO triplets; duplicates
    are summed, the diagonal is dropped, and the matrix is symmetrised."""
    import scipy.sparse as sp

    m = sp.coo_matrix((np.asarray(vals, np.float64),
                       (np.asarray(rows), np.asarray(cols))), shape=(n, n))
    m = m.tocsr()
    m.sum_duplicates()
    m.setdiag(0)
    m.eliminate_zeros()
    upper = sp.triu(m, k=1) + sp.triu(m.T, k=1)
    sym = (upper + upper.T).tocsr()
    sym.sort_indices()
    counts = np.diff(sym.indptr)
    coo = sym.tocoo()

    def t(x, dt):
        return torch.as_tensor(np.asarray(x).astype(dt), device=device)

    return SparseObs(
        rows=t(coo.row, np.int32), cols=t(coo.col, np.int32),
        vals=t(coo.data, np.float32), row_start=t(sym.indptr, np.int64),
        row_cap=int(counts.max()) if len(counts) else 1, n=n,
        logfact_const=float(-logfact_entries(sp.triu(sym, k=1).tocoo().data).sum()))


def sparse_directed(rows, cols, vals, n: int, device=None) -> SparseObs:
    """Directed (one-orientation) CSR windows in the SparseObs layout: the
    entries are kept as given (sorted by (row, col), duplicates summed, no
    symmetrisation; the caller keeps the diagonal out). The repeat delta
    engine's mixed-pair side table, where each (single-copy, multi-copy)
    observed pair is listed once from its single-copy end.
    ``logfact_const`` is not meaningful here (0)."""
    import scipy.sparse as sp

    m = sp.coo_matrix((np.asarray(vals, np.float64),
                       (np.asarray(rows), np.asarray(cols))), shape=(n, n)).tocsr()
    m.sum_duplicates()
    m.sort_indices()
    counts = np.diff(m.indptr)
    coo = m.tocoo()

    def t(x, dt):
        return torch.as_tensor(np.asarray(x).astype(dt), device=device)

    return SparseObs(
        rows=t(coo.row, np.int32), cols=t(coo.col, np.int32),
        vals=t(coo.data, np.float32), row_start=t(m.indptr, np.int64),
        row_cap=max(int(counts.max()) if counts.size else 1, 1), n=n, logfact_const=0.0)


def sparse_from_dense(obs, device=None) -> SparseObs:
    obs = np.asarray(obs)
    iu, ju = np.nonzero(np.triu(obs, 1))
    return sparse_from_coo(iu, ju, obs[iu, ju], obs.shape[0], device=device)


def subsample_sparse(sobs: SparseObs, fact: float, seed: int = 0) -> SparseObs:
    """Poisson sub-sampling of the observed map: every upper-triangular
    count is redrawn as Poisson(fact * ob), then re-symmetrised."""
    rng = np.random.default_rng(seed)
    r = sobs.rows.cpu().numpy()
    c = sobs.cols.cpu().numpy()
    v = sobs.vals.cpu().numpy().astype(np.float64)
    up = r < c
    drawn = rng.poisson(np.maximum(v[up] * fact, 0.0)).astype(np.float64)
    return sparse_from_coo(r[up], c[up], drawn, sobs.n, device=sobs.rows.device)


def band_width(len_kb, d_max: float, margin: float = 2.0, w_min: int = 8) -> int:
    """Band width covering every same-contig pair within ``d_max`` kb: any
    window of ``margin * d_max`` kb holds at most w + 1 subs."""
    if isinstance(len_kb, torch.Tensor):
        len_kb = len_kb.cpu().numpy()
    lens = np.sort(np.asarray(len_kb, np.float64))
    cum = np.cumsum(lens)
    p = int(np.searchsorted(cum, margin * d_max)) + 1
    return max(w_min, min(p + 2, len(lens) - 1))


def lexsort2(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Indices sorting the last axis by (primary, secondary), ties by index:
    ``np.lexsort((secondary, primary))`` as two stable sorts."""
    o1 = torch.sort(secondary, dim=-1, stable=True).indices
    o2 = torch.sort(primary.gather(-1, o1), dim=-1, stable=True).indices
    return o1.gather(-1, o2)


def genome_sort_order(state: GenomeState, table: SubFragTable):
    """Sub rows sorted by (contig, genomic midpoint) under the current
    genome (the band enumeration order), and the midpoints; with a chains
    axis (fields (C, n)) one order per chain, (C, K)."""
    own = table.owner.long()
    start_kb = state.start_bp[..., own].float() / 1000.0
    ori = state.ori[..., own]
    mid = start_kb + torch.where(ori == 1, table.prefix_kb, table.suffix_kb) \
        + table.len_kb * 0.5
    return lexsort2(state.id_c[..., own], mid), mid


def _chain_params(params, cell_dims: int):
    """Parameters shaped to broadcast over a chain's cells: shared (0-d)
    fields stay, one-per-chain (C,) fields become (C, 1, ...)."""
    return type(params)(*[x.reshape(x.shape + (1,) * cell_dims) if x.dim() else x
                          for x in params])


def _span(lo_hi, total: int):
    lo, hi = lo_hi if lo_hi is not None else (0, total)
    return max(0, min(lo, total)), max(0, min(hi, total))


def sparse_loglik_parts(table: SubFragTable, sobs: SparseObs, w: int,
                        max_cells: int = 1 << 24, entries=None, left_ends=None):
    """The two sums of the sparse likelihood that grow with the map, over a
    part of it, and what completes them.

    Returns ``(parts, finish)``: ``parts(states, params) -> (term1, cis)``,
    f64 (C,), the observed-pair term over the symmetric entries
    ``entries = (lo, hi)`` and the banded cis correction over the band
    left ends ``left_ends = (lo, hi)`` of the genome-sorted order (all of
    each by default); ``finish(states, params, term1, cis) -> (C,) f32``
    adds the terms that do not grow with the map (the analytic trans mass,
    the log-factorial constant) to the sums of every part. ``states`` has
    a chains axis (fields (C, n)); params are shared or one set per chain,
    fields (C,). A row-sharded likelihood sums ``parts`` over disjoint
    spans and calls ``finish`` once (``parallel.sharding``). Repeat tables
    take the copy-summing form (see :func:`make_sparse_loglik`)."""
    if table.has_repeats:
        return _sparse_parts_repeats(table, sobs, w, max_cells, entries, left_ends)
    k = table.n_subs
    if sobs.n != k:
        raise ValueError(f"sparse map has {sobs.n} rows, table has {k} subs")
    owner = table.owner.long()
    accu = table.accu
    nfpb = float(np.float32(table.n_frags_per_bins))
    e0, e1 = _span(entries, sobs.vals.shape[0])
    u_idx = sobs.rows[e0:e1].long()
    v_idx = sobs.cols[e0:e1].long()
    vals = sobs.vals[e0:e1]
    lo, hi = _span(left_ends, k)
    accu64 = accu.double()
    a_sum = accu64.sum()
    a_sq = (accu64 * accu64).sum()
    dev = accu.device
    rows_i = torch.arange(lo, hi, device=dev)[:, None]

    def parts(states: GenomeState, params: RippeParams):
        c = states.pos.shape[0]
        order, mid = genome_sort_order(states, table)
        idc = states.id_c[:, owner]
        circ = states.circ[:, owner]
        stot = states.l_cont_bp[:, owner].float() / 1000.0

        # ---- observed pairs ----
        p1 = _chain_params(params, 1)
        s = torch.abs(mid[:, u_idx] - mid[:, v_idx])
        same = idc[:, u_idx] == idc[:, v_idx]
        na = accu[u_idx] * accu[v_idx] / nfpb
        e_obs = expected_contacts(s, same, circ[:, u_idx] == 1, stot[:, u_idx], na, p1)
        term1 = 0.5 * (vals * torch.log(e_obs)).sum(-1, dtype=torch.float64)

        # ---- banded cis correction over the left ends, (C, L, chunk) slabs ----
        p2 = _chain_params(params, 2)
        mid_s, idc_s = mid.gather(1, order), idc.gather(1, order)
        circ_s, stot_s = circ.gather(1, order), stot.gather(1, order)
        accu_s = accu[order]
        chunk = max(1, min(w, max_cells // max((hi - lo) * c, 1)))
        cis_corr = torch.zeros(c, dtype=torch.float64, device=dev)
        for off0 in range(1, w + 1, chunk):
            offs = torch.arange(off0, min(off0 + chunk, w + 1), device=dev)
            j = rows_i + offs[None, :]
            valid = j < k
            jc = j.clamp_max(k - 1)
            s = torch.abs(mid_s[:, lo:hi, None] - mid_s[:, jc])
            same = (idc_s[:, lo:hi, None] == idc_s[:, jc]) & valid
            na = accu_s[:, lo:hi, None] * accu_s[:, jc] / nfpb
            e_cis = expected_contacts(s, same, (circ_s[:, lo:hi] == 1)[:, :, None],
                                      stot_s[:, lo:hi, None], na, p2)
            corr = torch.where(same, e_cis - p2.v_inter * na, 0.0)
            cis_corr = cis_corr + corr.sum(dim=(1, 2), dtype=torch.float64)
        return term1, cis_corr

    def finish(states: GenomeState, params: RippeParams, term1, cis_corr):
        trans_mass = params.v_inter.double() * (a_sum * a_sum - a_sq) * 0.5 / nfpb
        return (term1 - (trans_mass + cis_corr) + sobs.logfact_const).float()

    return parts, finish


def make_sparse_loglik(table: SubFragTable, sobs: SparseObs, w: int,
                       max_cells: int = 1 << 24):
    """Build ``fn(state, params) -> 0-d f32`` - the full Poisson
    log-likelihood, sparse and banded, equal to the dense
    ``core.likelihood.log_likelihood``. Repeat tables route to the
    copy-summing variant (:func:`_sparse_parts_repeats`): the expectation of
    an observed data pair sums over its active copy pairs; the expected
    mass stays pairwise over copy rows with same-data-bin pairs left out
    (they feed the data-grid diagonal, which the likelihood masks), and
    each entry's log(ob!) sits inside the E > 0 indicator, since a state can
    drive a pair's expectation to zero (every copy inactive).

    With a chains axis (``state`` fields (C, n); params shared or one set
    per chain, fields (C,)) every chain is evaluated at once and ``fn``
    returns (C,): the JAX package's ``jax.vmap(anchor)``. ``max_cells``
    bounds each band slab (chains x left ends x offsets)."""
    parts, finish = sparse_loglik_parts(table, sobs, w, max_cells)

    def fn(state: GenomeState, params: RippeParams):
        single = state.pos.dim() == 1
        states = GenomeState(*[x[None] for x in state]) if single else state
        out = finish(states, params, *parts(states, params))
        return out[0] if single else out

    return fn


def _sparse_parts_repeats(table: SubFragTable, sobs: SparseObs, w: int, max_cells: int,
                          entries, left_ends):
    """:func:`sparse_loglik_parts` of a copy-expanded table: the observed
    term copy-summed (c_max x c_max blocks per entry, in chunks of about
    ``max_cells`` pairs) with each entry's log(ob!) inside the E > 0
    indicator, the banded cis correction without same-data-bin pairs, and
    the analytic trans mass (activity-dependent) in ``finish``."""
    from graal_tpu_torch.core.delta_repeats import build_copy_table

    ct = build_copy_table(table)
    k = table.n_subs
    s_dim = table.n_data_sub
    if sobs.n != s_dim:
        raise ValueError(f"sparse map has {sobs.n} rows, the data grid {s_dim}")
    owner = table.owner.long()
    accu = table.accu
    data_id = table.data_id.long()
    nfpb = float(np.float32(table.n_frags_per_bins))
    dev = accu.device
    ci = torch.arange(ct.c_max, device=dev)

    def copies_of(bins):
        b0 = ct.copy_start[bins]
        rows = ct.copy_rows[(b0[..., None] + ci).clamp(0, k - 1)]
        return rows, ci < (ct.copy_start[bins + 1] - b0)[..., None]

    e0, e1 = _span(entries, sobs.vals.shape[0])
    u_rows, u_ok = copies_of(sobs.rows[e0:e1].long())
    v_rows, v_ok = copies_of(sobs.cols[e0:e1].long())
    vals = sobs.vals[e0:e1]
    lf = torch.as_tensor(logfact_entries(vals.cpu().numpy()).astype(np.float32), device=dev)
    b_rows, b_ok = copies_of(torch.arange(s_dim, device=dev))
    nnz = vals.shape[0]
    lo, hi = _span(left_ends, k)
    rows_i = torch.arange(lo, hi, device=dev)[:, None]

    def parts(states: GenomeState, params: RippeParams):
        c = states.pos.shape[0]
        order, mid = genome_sort_order(states, table)
        idc = states.id_c[:, owner]
        circ = states.circ[:, owner]
        stot = states.l_cont_bp[:, owner].float() / 1000.0
        a = torch.where(states.activ[:, owner] == 1, accu, 0.0)

        # ---- observed pairs, copy-summed ----
        p3 = _chain_params(params, 3)
        e_chunk = max(1, max_cells // (ct.c_max * ct.c_max * c))
        term1 = torch.zeros(c, dtype=torch.float64, device=dev)
        for q0 in range(0, nnz, e_chunk):
            sl = slice(q0, q0 + e_chunk)
            ur, vr = u_rows[sl], v_rows[sl]
            s = torch.abs(mid[:, ur][..., :, None] - mid[:, vr][..., None, :])
            same = idc[:, ur][..., :, None] == idc[:, vr][..., None, :]
            na = a[:, ur][..., :, None] * a[:, vr][..., None, :] / nfpb
            e = expected_contacts(s, same, (circ[:, ur] == 1)[..., :, None],
                                  stot[:, ur][..., :, None], na, p3)
            ok = u_ok[sl][:, :, None] & v_ok[sl][:, None, :]
            e_data = torch.where(ok, e, 0.0).sum(dim=(2, 3))
            term = vals[sl] * torch.log(torch.where(e_data > 0.0, e_data, 1.0)) - lf[sl]
            term1 = term1 + torch.where(e_data > 0.0, term, 0.0).sum(-1, dtype=torch.float64)
        term1 = 0.5 * term1

        # ---- banded cis correction over the left ends, same-bin pairs excluded ----
        p2 = _chain_params(params, 2)
        mid_s, idc_s = mid.gather(1, order), idc.gather(1, order)
        circ_s, stot_s, a_s = circ.gather(1, order), stot.gather(1, order), a.gather(1, order)
        db_s = data_id[order]
        chunk = max(1, min(w, max_cells // max((hi - lo) * c, 1)))
        cis_corr = torch.zeros(c, dtype=torch.float64, device=dev)
        for off0 in range(1, w + 1, chunk):
            offs = torch.arange(off0, min(off0 + chunk, w + 1), device=dev)
            j = rows_i + offs[None, :]
            jc = j.clamp_max(k - 1)
            s = torch.abs(mid_s[:, lo:hi, None] - mid_s[:, jc])
            same = (idc_s[:, lo:hi, None] == idc_s[:, jc]) & (j < k) \
                & (db_s[:, lo:hi, None] != db_s[:, jc])
            na = a_s[:, lo:hi, None] * a_s[:, jc] / nfpb
            e_cis = expected_contacts(s, same, (circ_s[:, lo:hi] == 1)[:, :, None],
                                      stot_s[:, lo:hi, None], na, p2)
            corr = torch.where(same, e_cis - p2.v_inter * na, 0.0)
            cis_corr = cis_corr + corr.sum(dim=(1, 2), dtype=torch.float64)
        return term1, cis_corr

    def finish(states: GenomeState, params: RippeParams, term1, cis_corr):
        # analytic trans mass, same-bin pairs excluded (activity-dependent)
        a64 = torch.where(states.activ[:, owner] == 1, accu, 0.0).double()
        a_sum, a_sq = a64.sum(-1), (a64 * a64).sum(-1)
        b_sums = torch.where(b_ok, a64[:, b_rows], 0.0).sum(-1)
        same_bin = ((b_sums * b_sums).sum(-1) - a_sq) * 0.5
        trans_mass = params.v_inter.double() / nfpb * ((a_sum * a_sum - a_sq) * 0.5 - same_bin)
        return (term1 - (trans_mass + cis_corr)).float()

    return parts, finish


def make_sparse_obs_fn(sobs: SparseObs, r_max: int):
    """Dense (R, R) observed-count gather for a set of sub rows, built from
    the symmetric CSR windows (a scatter over the windows). The oracle of
    the delta scorer's window machinery."""
    cap = sobs.row_cap
    nnz = sobs.cols.shape[0]

    def obs_fn(sub_rows):
        r = sub_rows.shape[0]
        dev = sub_rows.device
        rc = sub_rows.long().clamp(0, sobs.n - 1)
        start = sobs.row_start[rc]
        end = sobs.row_start[rc + 1]
        win = start[:, None] + torch.arange(cap, device=dev)[None, :]
        win_valid = win < end[:, None]
        win = win.clamp(0, nnz - 1)
        cols = torch.where(win_valid, sobs.cols[win].long(), sobs.n)
        vals = torch.where(win_valid, sobs.vals[win], 0.0)
        # membership: global sub id -> local slot (0 = absent)
        slotmap = torch.zeros(sobs.n + 1, dtype=torch.int64, device=dev)
        slotmap[sub_rows.long().clamp(0, sobs.n)] = torch.arange(1, r + 1, device=dev)
        slot = slotmap[cols]
        tgt = torch.where(slot > 0, slot - 1, r)
        ob = torch.zeros((r, r + 1), dtype=torch.float32, device=dev)
        ob.scatter_add_(1, tgt, vals)
        return ob[:, :r]

    return obs_fn
