"""Incremental (delta) candidate scoring of repeat (copy-expanded) tables.

PyTorch counterpart of the v2 engine of ``graal_tpu.core.delta_repeats``
(``make_repeat_delta_scorer_v2``; the JAX package's v1 engine stays there
as a test oracle and is not ported). With repeated bins the observed count
lives on the data grid and its expectation sums over active copy pairs,

    E_data(s, t) = sum_{u in copies(s), v in copies(t)} E(u, v),

including copies in contigs the mutation never touches. v2 splits the
observed pairs by whether an end's bin is multi-copy:

- (single, single), the great majority: both bins have one copy, so
  E_data is the one copy pair's E. These entries go through the plain
  delta scorer (:class:`core.delta.DeltaScorer` with ``data_keys``), and
  so through kernels I1 / I2 (the slots' inputs, the sub-row vectors and
  the window keys by data bin), B4 (window obs grid) and B2 (mini-grid
  scorer); I2 also writes the activity, circ and accu of the sub rows
  that the copy corrections read.
- (single, multi): listed once from the single-copy end in a directed side
  table; the multi end's in-D copies take candidate geometry, its frozen
  copies (other contigs) add an analytic trans term (a D contig id is
  never a non-D id, so such pairs are always trans).
- (multi, multi): a short static list, with full copy-pair enumeration;
  frozen x frozen blocks use the base geometry.
- fA's own multi-copy bins against frozen single-copy partners (part 4):
  only swap_activity changes that expectation, and it toggles fA alone.

The expected mass is the plain scorer's D x D mass, minus the same-data-bin
copy pairs (the data-grid diagonal), plus an activity cross-term for
swap_activity's trans mass against the frozen genome.

Exactness contract: every data bin of a rep-flagged fragment is
multi-copy, so single-copy rows never change activity. The production
constructions (``pipeline.extend_with_repeats``,
``utils.synthetic_sparse.add_scale_repeats``) keep it; the engine checks it
when it is built and raises ValueError otherwise.

Everything is batched over the m neighbours of a step and the 14 genomes
(base + 13 candidates) of each; correction sums are taken in f64. On a
card the corrections of every chain and neighbour of a scoring call are one
launch pair, kernels F1 / F2 (:mod:`graal_tpu_torch.ops.repeat_corr_cuda`);
elsewhere the plain version takes them chain by chain. Nothing reads a
device value on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graal_tpu_torch.core.delta import DeltaScorer, extract_rows, geometry_of, lift_chain
from graal_tpu_torch.core.mcmc import _take
from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.sparse import (SparseObs, logfact_entries, sparse_directed,
                                         sparse_from_coo)
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.core.subfrags import SubFragTable, copy_csr
from graal_tpu_torch.ops.mini_grid_cuda import log_cis_plain
from graal_tpu_torch.ops.repeat_corr_cuda import CORR, make_tables


class CopyTable(NamedTuple):
    """Static data bin -> copy sub rows CSR (the reference's dispatcher
    direction)."""

    copy_start: torch.Tensor   # (S + 1,) int64 indptr over data bins
    copy_rows: torch.Tensor    # (K,) int64 sub rows sorted by data_id
    c_max: int                 # most copies of any data bin


def build_copy_table(table: SubFragTable) -> CopyTable:
    start, order, c_max = copy_csr(table.data_id.cpu().numpy(), table.n_data_sub)
    dev = table.owner.device
    return CopyTable(copy_start=torch.as_tensor(start, dtype=torch.int64, device=dev),
                     copy_rows=torch.as_tensor(order, dtype=torch.int64, device=dev),
                     c_max=c_max)


def _pair_e(gu, gv, ok, pvec, nfpb: float):
    """Linear expected contacts of copy pairs (broadcast shapes) from the
    geometry dicts ``gu``, ``gv`` (mid, idc, circ, stot, a); the circular
    variant follows the u row, as in the JAX package."""
    s = torch.abs(gu["mid"] - gv["mid"])
    log_cis = log_cis_plain(s, gu["circ"] == 1, gu["stot"], pvec)
    e = torch.where(gu["idc"] == gv["idc"], torch.exp(log_cis), pvec[6]) \
        * gu["a"] * gv["a"] / nfpb
    return torch.where(ok, e, 0.0)


def split_observed_for_repeats(table: SubFragTable, sobs: SparseObs):
    """Host-side split of the symmetric data-grid contacts by repeat
    involvement. Returns (dup (S,) numpy bool, sobs_single, mixed,
    (dd_s, dd_t, dd_ob, dd_lf)): the single-single contacts, the directed
    (single-copy row, multi-copy column) table, and the upper multi-multi
    entries with their log(ob!)."""
    s_dim = table.n_data_sub
    dev = sobs.rows.device
    dup = np.bincount(table.data_id.cpu().numpy(), minlength=s_dim) >= 2
    r, c = sobs.rows.cpu().numpy(), sobs.cols.cpu().numpy()
    v = sobs.vals.cpu().numpy()
    up = r < c
    r, c, v = r[up], c[up], v[up]
    m_r, m_c = dup[r], dup[c]
    none = ~(m_r | m_c)
    both = m_r & m_c
    one = (m_r | m_c) & ~both
    sobs_single = sparse_from_coo(r[none], c[none], v[none], s_dim, device=dev)
    sr = np.where(m_r[one], c[one], r[one])
    sc = np.where(m_r[one], r[one], c[one])
    mixed = sparse_directed(sr, sc, v[one], s_dim, device=dev)

    def t(x, dt):
        return torch.as_tensor(np.asarray(x).astype(dt), device=dev)

    dd = (t(r[both], np.int64), t(c[both], np.int64), t(v[both], np.float32),
          t(logfact_entries(v[both]), np.float32))
    return dup, sobs_single, mixed, dd


def check_exactness_contract(table: SubFragTable, rep, dup=None):
    """Raise ValueError unless every data bin of a rep-flagged fragment is
    multi-copy (``rep``: the genome's (n_frags,) repeat flags)."""
    rep = rep.cpu().numpy() if isinstance(rep, torch.Tensor) else np.asarray(rep)
    owner = table.owner.cpu().numpy()
    data_id = table.data_id.cpu().numpy()
    if dup is None:
        dup = np.bincount(data_id, minlength=table.n_data_sub) >= 2
    if rep.shape != (int(owner.max()) + 1,):
        raise ValueError(f"rep has shape {rep.shape}, the table {int(owner.max()) + 1} "
                         "fragments")
    bad = np.nonzero((rep[owner] == 1) & ~dup[data_id])[0]
    if len(bad):
        raise ValueError(
            f"fragment {owner[bad[0]]} is flagged as a repeat (rep == 1) but its data "
            f"sub {data_id[bad[0]]} has a single copy: the repeat delta engine needs "
            "every data bin of a rep-flagged fragment to be multi-copy")


def _sum64(x, dims):
    return x.sum(dim=dims, dtype=torch.float64)


def _copy_sum(x):
    """The f32 sum over the last (copy) axis as a left fold, x[..., 0] +
    x[..., 1] + ...: an order stated here, which kernels F1 / F2 take for
    any number of copies (torch's own reduction order depends on the
    device, the shape and the version)."""
    acc = x[..., 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c]
    return acc


class RepeatDeltaScorer:
    """The repeat-aware delta scorer v2, with the contract of
    :class:`core.delta.DeltaScorer`: ``score`` scores the m neighbours of a
    step, ``__call__`` one neighbour; dll is log_likelihood(candidate) -
    log_likelihood(base) whenever overflow is False.

    ``sobs``: the observed map on the data grid. ``rep``: the genome's
    repeat flags, against which the exactness contract is checked.
    ``obs_grid`` / ``mini_grid``: the kernel wrappers of the single-copy
    majority (see :class:`DeltaScorer`). ``catalogue``: the 13-candidate
    builder, as :class:`DeltaScorer` takes it (EM by default)."""

    def __init__(self, table: SubFragTable, f_max: int, sobs: SparseObs, rep,
                 obs_grid=None, mini_grid=None, catalogue=None):
        if rep is None:
            raise ValueError("the repeat delta engine needs the genome's rep flags "
                             "to check its exactness contract")
        dup, sobs_single, mixed, dd = split_observed_for_repeats(table, sobs)
        check_exactness_contract(table, rep, dup)
        self.plain = DeltaScorer(table, None, f_max, sobs=sobs_single, obs_grid=obs_grid,
                                 mini_grid=mini_grid, data_keys=table.data_id,
                                 catalogue=catalogue)
        self.f_max = self.plain.f_max
        self.mt = self.plain.mt
        self.r_max = self.plain.r_max
        dev = table.owner.device
        self.ct = build_copy_table(table)
        self.k_subs = table.n_subs
        self.s_dim = table.n_data_sub
        self.dup = torch.as_tensor(dup, device=dev)
        self.mixed, self.sobs = mixed, sobs
        self.mixed_lf = torch.as_tensor(logfact_entries(mixed.vals.cpu().numpy())
                                        .astype(np.float32), device=dev)
        self.sobs_lf = torch.as_tensor(logfact_entries(sobs.vals.cpu().numpy())
                                       .astype(np.float32), device=dev)
        self.dd_ob, self.dd_lf = dd[2], dd[3]
        self.ddu_rows, self.ddu_ok = self.copy_rows_of(dd[0])
        self.ddv_rows, self.ddv_ok = self.copy_rows_of(dd[1])
        self.owner = table.owner.long()
        self.data_id = table.data_id.long()
        self.accu = table.accu
        self.pre, self.suf = table.prefix_kb, table.suffix_kb
        self.half = table.len_kb * 0.5
        self.nfpb = float(np.float32(table.n_frags_per_bins))
        self.corr_tables = make_tables(table, self.mt, self.ct, self.dup, mixed, self.mixed_lf,
                                       sobs, self.sobs_lf, self.dd_ob, self.dd_lf,
                                       (self.ddu_rows, self.ddu_ok),
                                       (self.ddv_rows, self.ddv_ok))

    # ---- candidate-independent routing --------------------------------------
    def copy_rows_of(self, bins):
        """(..., c_max) copy sub rows of data bins, and which are real."""
        ct = self.ct
        b = bins.clamp(0, self.s_dim - 1)
        ci = torch.arange(ct.c_max, device=b.device)
        v0 = ct.copy_start[b]
        rows = ct.copy_rows[(v0[..., None] + ci).clamp(0, self.k_subs - 1)]
        return rows, ci < (ct.copy_start[b + 1] - v0)[..., None]

    def route(self, inv_f, krows, shared: bool):
        """(in_d, mini_row) of copy sub rows per neighbour: ``inv_f`` (m, n)
        is each neighbour's fragment -> mini slot map (-1 outside D);
        ``krows`` is (m, ...) or, when ``shared``, the same rows for all."""
        m = inv_f.shape[0]
        g = self.owner[krows]
        if shared:
            slot = inv_f[:, g.reshape(-1)].reshape((m,) + tuple(g.shape))
        else:
            slot = inv_f.gather(1, g.reshape(m, -1)).reshape(g.shape)
        mrow = slot.clamp_min(0) * self.mt.s_max + (krows - self.mt.sub_start[g])
        return slot >= 0, mrow.clamp(0, self.r_max - 1)

    def frozen(self, smat, krows):
        """Base-state geometry of copy rows (one gather of the stacked
        (n, 6) state fields ``smat``)."""
        got = smat[self.owner[krows]]
        return dict(mid=got[..., 0].float() / 1000.0
                    + torch.where(got[..., 1] == 1, self.pre[krows], self.suf[krows])
                    + self.half[krows],
                    idc=got[..., 2], circ=got[..., 3],
                    stot=got[..., 4].float() / 1000.0,
                    a=torch.where(got[..., 5] == 1, self.accu[krows], 0.0))

    def frozen_a(self, smat, krows):
        return torch.where(smat[self.owner[krows], 5] == 1, self.accu[krows], 0.0)

    # ---- scoring ------------------------------------------------------------
    def score(self, state: GenomeState, f_a, ids, rows, valid, overflow,
              params: RippeParams, max_id):
        """Score the m neighbours ``ids`` of ``f_a`` on their member rows
        (:func:`core.delta.extract_rows_each`). Returns (dll (m, 13),
        candidates (m, 13, f_max), rows, valid, overflow).

        With a chains axis (as :meth:`core.delta.DeltaScorer.score` takes
        it) the single-copy part of every chain's neighbours goes through
        one obs-grid and one mini-grid launch, and their copy corrections
        through one :meth:`corrections` call. dll and the candidates come
        back as (C, m, 13) and (C, m, 13, f_max)."""
        p = self.plain
        f_a = torch.as_tensor(f_a, device=rows.device)
        args = (state, f_a, ids, rows, valid, max_id)
        if ids.dim() == 1:      # one chain: a chains axis of one
            args = lift_chain(*args)
        st, fa, ids_c, rows_c, valid_c = args[:5]
        cands, vec, ob, pvec = p.inputs(*args[:5], params, args[5])
        _, dll1 = p.mini_grid(*p.mini_grid_args(vec, ob, pvec))
        _, _, dll = self.corrections(st, fa.long(), rows_c, valid_c, geometry_of(vec),
                                     vec.accu_sub, pvec, dll1)
        lead = ids.shape
        return (dll.reshape(lead + dll.shape[1:]),
                GenomeState(*[x.reshape(lead + x.shape[1:]) for x in cands]),
                rows, valid, overflow)

    def corrections(self, state: GenomeState, f_a, rows, valid, geo, accu_sub, pvec, dll1):
        """The copy corrections of a scoring call's C x m neighbour slots
        (M = C x m) on top of their single-copy deltas ``dll1`` (M, 13):
        (corr (M, 14) f64 of every genome, cross (M, 13) f64, dll (M, 13)
        f32). ``state`` fields (C, n), ``f_a`` (C,), ``rows`` / ``valid``
        (C, m, f_max) (:func:`core.delta.extract_rows_each`), ``geo`` the
        slots' 14 genomes (M, 14, R), ``accu_sub`` (M, R), ``pvec`` (M,
        10). By kernels F1 / F2 (one launch pair) when the rows lie on a
        card, else :meth:`corrections_plain`."""
        if rows.device.type != "cuda":
            return self.corrections_plain(state, f_a, rows, valid, geo, accu_sub, pvec, dll1)
        return self._corrections_on_card(state, f_a, rows, valid, geo, accu_sub, pvec, dll1)

    def _corrections_on_card(self, state, f_a, rows, valid, geo, accu_sub, pvec, dll1):
        return CORR.corrections(self.corr_tables, state, f_a, rows, valid, geo, accu_sub, pvec,
                                dll1)

    def corrections_plain(self, state: GenomeState, f_a, rows, valid, geo, accu_sub, pvec,
                          dll1):
        """:meth:`corrections` in plain torch, chain by chain
        (:meth:`_corrections`)."""
        n_ch, m = rows.shape[:2]
        parts = []
        for k in range(n_ch):
            sl = slice(k * m, (k + 1) * m)
            parts.append(self._corrections(
                GenomeState(*[x[k] for x in state]), f_a[k], rows[k], valid[k],
                type(geo)(*[x[sl] for x in geo]), accu_sub[sl], pvec[k * m]))
        corr, cross = (torch.cat(x) for x in zip(*parts))
        dll = dll1.double() + (corr[:, 1:] - corr[:, :1]) - cross
        return corr, cross, dll.float()

    def _corrections(self, state: GenomeState, f_a, rows, valid, geo, accu_sub, pvec):
        """The copy corrections of one chain's m neighbours on top of the
        single-copy scores: (corr (m, 14) f64 of every genome, cross (m,
        13) f64, swap_activity's trans mass against the frozen genome)."""
        p = self.plain
        m, n_gen, r = geo.mid.shape
        n = state.n_frags
        dev = rows.device
        nfpb = self.nfpb
        vn = pvec[6] / nfpb                    # v_inter / nfpb
        s_max = self.mt.s_max

        subs, sub_valid = p.sub_rows(rows, valid)
        db = self.data_id[subs.clamp(0, self.k_subs - 1)]             # (m, R)
        db_dup = self.dup[db] & sub_valid
        inv_f = torch.full((m, n + 1), -1, dtype=torch.int64, device=dev)
        inv_f.scatter_(1, torch.where(valid, rows, n),
                       torch.arange(rows.shape[1], device=dev).expand_as(rows))
        inv_f = inv_f[:, :n]
        smat = torch.stack([state.start_bp, state.ori, state.id_c, state.circ,
                            state.l_cont_bp, state.activ], dim=1)

        # the 14 genomes' mini geometry, and picks of it at mini rows
        a_g = torch.where(geo.act, accu_sub[:, None, :], 0.0)           # (m, C, R)
        g = dict(mid=geo.mid, idc=geo.idc, circ=geo.circ, stot=geo.stot, a=a_g)
        gm = torch.stack([geo.mid, geo.circ.float(), geo.stot, a_g], dim=-1)

        def pick(idx):
            shape = (m, n_gen) + tuple(idx.shape[1:])
            flat = idx.reshape(m, 1, -1).expand(m, n_gen, -1)
            got = gm.gather(2, flat[..., None].expand(-1, -1, -1, 4)).reshape(shape + (4,))
            return dict(mid=got[..., 0], circ=got[..., 1], stot=got[..., 2], a=got[..., 3],
                        idc=geo.idc.gather(2, flat).reshape(shape))

        corr = torch.zeros((m, n_gen), dtype=torch.float64, device=dev)

        # ---- mixed (single, multi) windows of the single-copy D rows -------
        mx = self.mixed
        if mx.vals.numel():
            start, end = mx.row_start[db], mx.row_start[db + 1]
            win = start[..., None] + torch.arange(mx.row_cap, device=dev)
            mwin = (win < end[..., None]) & (sub_valid & ~db_dup)[..., None]
            wc = win.clamp_max(mx.vals.shape[0] - 1)
            t_bin = torch.where(mwin, mx.cols[wc].long(), 0)            # (m, R, capm)
            ob_m = torch.where(mwin, mx.vals[wc], 0.0)
            lf_m = torch.where(mwin, self.mixed_lf[wc], 0.0)
            v_rows, v_ok = self.copy_rows_of(t_bin)                     # (m, R, capm, c)
            v_in, v_mini = self.route(inv_f, v_rows, shared=False)
            v_ok = v_ok & mwin[..., None]
            a_out_t = _copy_sum(torch.where(v_ok & ~v_in, self.frozen_a(smat, v_rows), 0.0))
            gu = {k: x[..., None, None] for k, x in g.items()}
            e_in = _copy_sum(_pair_e(gu, pick(v_mini), (v_in & v_ok)[:, None], pvec, nfpb))
            e_mix = e_in + vn * a_g[..., None] * a_out_t[:, None]       # (m, C, R, capm)
            term = ob_m[:, None] * torch.log(torch.where(e_mix > 0.0, e_mix, 1.0)) \
                - lf_m[:, None]
            corr = corr + _sum64(torch.where(mwin[:, None] & (e_mix > 0.0), term, 0.0),
                                 (2, 3))

        # ---- multi-multi entries -------------------------------------------
        if self.dd_ob.numel():
            ddu_in, ddu_mini = self.route(inv_f, self.ddu_rows, shared=True)  # (m, ndd, c)
            ddv_in, ddv_mini = self.route(inv_f, self.ddv_rows, shared=True)
            gu_f = self.frozen(smat, self.ddu_rows)                       # (ndd, c)
            gv_f = self.frozen(smat, self.ddv_rows)
            ff_ok = (self.ddu_ok & ~ddu_in)[..., :, None] & (self.ddv_ok & ~ddv_in)[..., None, :]
            e_ff = _copy_sum(_copy_sum(_pair_e({k: x[:, :, None] for k, x in gu_f.items()},
                                               {k: x[:, None, :] for k, x in gv_f.items()},
                                               ff_ok, pvec, nfpb)))        # (m, ndd)
            a_u_out = _copy_sum(torch.where(self.ddu_ok & ~ddu_in, gu_f["a"], 0.0))
            a_v_out = _copy_sum(torch.where(self.ddv_ok & ~ddv_in, gv_f["a"], 0.0))
            gu_in, gv_in = pick(ddu_mini), pick(ddv_mini)                 # (m, C, ndd, c)
            u_in_ok = (self.ddu_ok & ddu_in)[:, None]
            v_in_ok = (self.ddv_ok & ddv_in)[:, None]
            e_ii = _copy_sum(_copy_sum(_pair_e(
                {k: x[..., :, None] for k, x in gu_in.items()},
                {k: x[..., None, :] for k, x in gv_in.items()},
                u_in_ok[..., :, None] & v_in_ok[..., None, :], pvec, nfpb)))  # (m, C, ndd)
            e_dd = e_ff[:, None] + e_ii + vn * (
                _copy_sum(torch.where(u_in_ok, gu_in["a"], 0.0)) * a_v_out[:, None]
                + a_u_out[:, None] * _copy_sum(torch.where(v_in_ok, gv_in["a"], 0.0)))
            term = self.dd_ob * torch.log(torch.where(e_dd > 0.0, e_dd, 1.0)) - self.dd_lf
            corr = corr + _sum64(torch.where(e_dd > 0.0, term, 0.0), (2,))

        # ---- part 4: fA's multi-copy bins x frozen single-copy partners -----
        so = self.sobs
        if so.vals.numel():
            fa = torch.as_tensor(f_a, device=dev).long()
            slot_a = torch.arange(s_max, device=dev)
            subs_a = (_take(self.mt.sub_start, fa) + slot_a).clamp(0, self.k_subs - 1)
            dba = self.data_id[subs_a]                                    # (s_max,)
            a_dup = self.dup[dba] & (slot_a < _take(self.mt.sub_count, fa))
            start, end = so.row_start[dba], so.row_start[dba + 1]
            win = start[:, None] + torch.arange(so.row_cap, device=dev)
            dwin = (win < end[:, None]) & a_dup[:, None]
            wc = win.clamp_max(so.vals.shape[0] - 1)
            t4 = torch.where(dwin, so.cols[wc].long(), 0)                 # (s_max, capd)
            ob4 = torch.where(dwin, so.vals[wc], 0.0)
            lf4 = torch.where(dwin, self.sobs_lf[wc], 0.0)
            t4_row = self.ct.copy_rows[self.ct.copy_start[t4].clamp_max(self.k_subs - 1)]
            t4_in, _ = self.route(inv_f, t4_row, shared=True)             # (m, s_max, capd)
            g_t4 = self.frozen(smat, t4_row)
            valid4 = dwin & ~self.dup[t4] & ~t4_in
            ca_rows, ca_ok = self.copy_rows_of(dba)                       # (s_max, c)
            ca_in, ca_mini = self.route(inv_f, ca_rows, shared=True)      # (m, s_max, c)
            g_u4 = self.frozen(smat, ca_rows)
            u4_ok = (ca_ok & ~ca_in)[:, :, None, :] & valid4[..., None]
            c_frozen4 = _copy_sum(_pair_e({k: x[:, None, :] for k, x in g_u4.items()},
                                          {k: x[:, :, None] for k, x in g_t4.items()},
                                          u4_ok, pvec, nfpb))             # (m, s_max, capd)
            coef4 = torch.where(valid4, vn * g_t4["a"], 0.0)
            a_in_d = _copy_sum(torch.where((ca_in & ca_ok)[:, None], pick(ca_mini)["a"], 0.0))
            e4 = c_frozen4[:, None] + coef4[:, None] * a_in_d[..., None]  # (m, C, s_max, capd)
            term = ob4 * torch.log(torch.where(e4 > 0.0, e4, 1.0)) - lf4
            corr = corr + _sum64(torch.where(valid4[:, None] & (e4 > 0.0), term, 0.0), (2, 3))

        # ---- same-data-bin pairs: out of the plain part's mass -------------
        sb_rows, sb_ok = self.copy_rows_of(db)                            # (m, R, c)
        sb_in, sb_mini = self.route(inv_f, sb_rows, shared=False)
        sb_use = sb_in & sb_ok & db_dup[..., None] \
            & (sb_mini > torch.arange(r, device=dev)[:, None])
        e_sb = _pair_e({k: x[..., None] for k, x in g.items()}, pick(sb_mini),
                       sb_use[:, None], pvec, nfpb)
        corr = corr + _sum64(e_sb, (2, 3))

        # ---- swap_activity's trans mass against the frozen genome ----------
        o_same = _copy_sum(torch.where(sb_ok & ~sb_in, self.frozen_a(smat, sb_rows), 0.0))
        w_all = torch.where(state.activ[self.owner] == 1, self.accu, 0.0) \
            .sum(dtype=torch.float64)
        a_base = a_g[:, 0]
        w_out = w_all - a_base.sum(-1, dtype=torch.float64)               # (m,)
        cross = vn.double() * ((a_g[:, 1:] - a_base[:, None]).double()
                               * (w_out[:, None] - o_same.double())[:, None]).sum(-1)
        return corr, cross

    def __call__(self, state: GenomeState, f_a, f_b, params: RippeParams, max_id):
        dev = state.pos.device
        f_b = torch.as_tensor(f_b, device=dev)
        rows, valid, overflow = extract_rows(state, f_a, f_b, self.f_max)
        dll, cands, *_ = self.score(state, f_a, f_b.reshape(1), rows[None], valid[None],
                                    overflow[None], params, max_id)
        return dll[0], GenomeState(*[x[0] for x in cands]), rows, valid, overflow


def make_repeat_delta_scorer_v2(table: SubFragTable, f_max: int, sobs: SparseObs, rep,
                                obs_grid=None, mini_grid=None,
                                catalogue=None) -> RepeatDeltaScorer:
    """Build the repeat-aware delta scorer (see :class:`RepeatDeltaScorer`)."""
    return RepeatDeltaScorer(table, f_max, sobs, rep, obs_grid=obs_grid,
                             mini_grid=mini_grid, catalogue=catalogue)
