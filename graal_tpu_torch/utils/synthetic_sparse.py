"""Sparse synthetic problems at chr1 scale (100k-1M bins).

PyTorch counterpart of ``graal_tpu.utils.synthetic_sparse``. Contacts are
sampled in numpy without a dense grid: every same-contig pair within the
genome-order band is drawn Poisson(e_rippe), and the remaining trans and
beyond-band mass is one Poisson draw scattered over uniformly random
pairs. Everything is made from a seed in numpy, so both packages build
identical problems from the same arguments. Geometry is one sub-fragment
per bin.
"""

from __future__ import annotations

import numpy as np
import torch

from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.sparse import SparseObs, band_width, sparse_from_coo
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.core.subfrags import SubFragTable


def scale_params(device=None) -> RippeParams:
    """Deep-coverage Rippe parameters: near-diagonal expectations ~20
    counts, trans expectation 1e-3 per pair."""
    return RippeParams.create(kuhn=1.0, lm=9.6, slope=-1.5, d=3.0,
                              fact=6000.0, d_max=900.0, v_inter=1e-3,
                              device=device)


def make_scale_genome(n_bins: int, n_contigs: int, mean_len_bp: int = 3000,
                      seed: int = 0, device=None):
    """Ground-truth genome and its one-sub-per-bin table."""
    rng = np.random.default_rng(seed)
    sizes = np.full(n_contigs, n_bins // n_contigs)
    sizes[: n_bins - sizes.sum()] += 1
    len_bp = rng.integers(int(mean_len_bp * 0.6), int(mean_len_bp * 1.4),
                          n_bins).astype(np.int64)
    id_c = np.repeat(np.arange(n_contigs), sizes)
    starts_of = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    pos = np.arange(n_bins) - starts_of[id_c]
    cum = np.cumsum(len_bp) - len_bp
    start_bp = cum - cum[starts_of][id_c]
    tot_bp = np.add.reduceat(len_bp, starts_of)
    state = GenomeState.from_soa(dict(
        pos=pos, id_c=id_c, start_bp=start_bp, len_bp=len_bp,
        circ=np.zeros(n_bins), l_cont=sizes[id_c], l_cont_bp=tot_bp[id_c],
        ori=np.ones(n_bins), rep=np.zeros(n_bins), activ=np.ones(n_bins),
        id_d=np.arange(n_bins)), device=device)

    def t(x, dt):
        return torch.as_tensor(np.asarray(x, dt), device=device)

    table = SubFragTable(
        owner=t(np.arange(n_bins), np.int32),
        data_id=t(np.arange(n_bins), np.int32),
        len_kb=t(len_bp / 1000.0, np.float32),
        accu=t(np.ones(n_bins), np.float32),
        prefix_kb=t(np.zeros(n_bins), np.float32),
        suffix_kb=t(np.zeros(n_bins), np.float32),
        n_data_sub=n_bins, n_frags_per_bins=1.0, has_repeats=False)
    return state, table


def _rippe_np(s, p: RippeParams):
    kuhn, lm, c1, slope, d, d_max, fact, v_inter = p.astuple_np()
    with np.errstate(all="ignore"):
        n = s * lm / kuhn
        val = c1 * np.power(s, slope) * np.exp((d - 2.0) / (n * n + d)) * fact
    val = np.where((s > 0) & (s < d_max), val, 0.0)
    return np.maximum(val, v_inter)


def thin_coverage(params: RippeParams, coverage: float) -> RippeParams:
    """Scale the model to a lower sequencing coverage: expectations are
    linear in (fact, v_inter), so thinning multiplies both."""
    dev = params.fact.device
    return params._replace(
        fact=torch.tensor(np.float32(float(params.fact) * coverage), device=dev),
        v_inter=torch.tensor(np.float32(float(params.v_inter) * coverage), device=dev))


def simulate_sparse_contacts(state: GenomeState, table: SubFragTable,
                             params: RippeParams, seed: int = 0) -> SparseObs:
    """Poisson contact map as sparse triplets on the table's device;
    O(K * w) work and memory."""
    rng = np.random.default_rng(seed)
    s_np = state.to_numpy()
    owner = table.owner.cpu().numpy()
    len_kb = table.len_kb.cpu().numpy()
    mid = (s_np["start_bp"][owner] / 1000.0
           + np.asarray(len_kb, np.float64) * 0.5)
    idc = s_np["id_c"][owner]
    k = len(owner)
    w = band_width(len_kb, float(params.d_max), margin=1.0)

    rows_acc, cols_acc, vals_acc = [], [], []
    band_pairs = 0
    # genome order is construction order (id_c, pos ascending)
    for off in range(1, w + 1):
        u = np.arange(k - off)
        v = u + off
        same = idc[u] == idc[v]
        band_pairs += int(np.sum(same))
        u, v = u[same], v[same]
        s = np.abs(mid[u] - mid[v])
        cnt = rng.poisson(_rippe_np(s, params))
        nz = cnt > 0
        rows_acc.append(u[nz])
        cols_acc.append(v[nz])
        vals_acc.append(cnt[nz])

    # remaining mass: total pairs minus band same-contig pairs, each v_inter
    lam_rest = float(params.v_inter) * (k * (k - 1) // 2 - band_pairs)
    n_rest = rng.poisson(lam_rest)
    if n_rest > 0:
        ru = rng.integers(0, k, n_rest)
        rv = rng.integers(0, k, n_rest)
        keep = ru != rv
        rows_acc.append(np.minimum(ru[keep], rv[keep]))
        cols_acc.append(np.maximum(ru[keep], rv[keep]))
        vals_acc.append(np.ones(int(keep.sum()), np.int64))

    return sparse_from_coo(np.concatenate(rows_acc), np.concatenate(cols_acc),
                           np.concatenate(vals_acc).astype(np.float64), k,
                           device=table.owner.device)


def add_scale_repeats(state: GenomeState, table: SubFragTable, dup_bins):
    """Append one repeat copy of each bin of ``dup_bins`` as a fresh
    singleton contig (originals flagged as repeats too) and rebuild the
    one-sub-per-bin table copy-expanded. Returns (state, table, id_d)."""
    s = state.to_numpy()
    n = len(s["pos"])
    dup = np.asarray(dup_bins, np.int64).reshape(-1)
    m = len(dup)
    ones = np.ones(m, np.int64)
    ext = dict(pos=0 * ones, id_c=int(s["id_c"].max()) + 1 + np.arange(m),
               start_bp=0 * ones, len_bp=s["len_bp"][dup], circ=0 * ones, l_cont=ones,
               l_cont_bp=s["len_bp"][dup], ori=ones, rep=ones, activ=ones, id_d=dup)
    soa = {k: np.concatenate([s[k].astype(np.int64), ext[k]]) for k in s}
    soa["rep"][dup] = 1
    id_d = soa["id_d"]
    n_frags = len(id_d)
    dev = table.owner.device

    def t(x, dt):
        return torch.as_tensor(np.asarray(x, dt), device=dev)

    table2 = SubFragTable(
        owner=t(np.arange(n_frags), np.int32), data_id=t(id_d, np.int32),
        len_kb=t(table.len_kb.cpu().numpy()[id_d], np.float32),
        accu=t(np.ones(n_frags), np.float32), prefix_kb=t(np.zeros(n_frags), np.float32),
        suffix_kb=t(np.zeros(n_frags), np.float32),
        n_data_sub=n, n_frags_per_bins=1.0, has_repeats=True)
    return GenomeState.from_soa(soa, device=state.pos.device), table2, id_d


def shuffle_genome(state: GenomeState, n_pieces: int, seed: int = 0) -> GenomeState:
    """Scramble the ground truth into ``n_pieces`` random contigs of
    shuffled, randomly oriented chunks (chunks keep local order)."""
    rng = np.random.default_rng(seed)
    n = state.n_frags
    len_bp = state.len_bp.cpu().numpy()
    cuts = np.sort(rng.choice(np.arange(1, n), n_pieces - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    chunks = [np.arange(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
    order = rng.permutation(len(chunks))
    id_c = np.zeros(n, np.int64)
    pos = np.zeros(n, np.int64)
    start_bp = np.zeros(n, np.int64)
    l_cont = np.zeros(n, np.int64)
    l_cont_bp = np.zeros(n, np.int64)
    ori = np.ones(n, np.int64)
    for new_c, ci in enumerate(order):
        frags = chunks[ci]
        if rng.random() < 0.5:
            frags = frags[::-1]
            ori[frags] = -1
        id_c[frags] = new_c
        pos[frags] = np.arange(len(frags))
        lens = len_bp[frags]
        start_bp[frags] = np.cumsum(lens) - lens
        l_cont[frags] = len(frags)
        l_cont_bp[frags] = lens.sum()
    dev = state.pos.device

    def t(x):
        return torch.as_tensor(x.astype(np.int32), device=dev)

    return state._replace(pos=t(pos), id_c=t(id_c), start_bp=t(start_bp),
                          l_cont=t(l_cont), l_cont_bp=t(l_cont_bp), ori=t(ori),
                          circ=torch.zeros(n, dtype=torch.int32, device=dev))
