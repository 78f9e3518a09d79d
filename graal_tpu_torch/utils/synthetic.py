"""Synthetic problem generation: ground-truth genomes + Poisson contact maps.

PyTorch counterpart of ``graal_tpu.utils.synthetic``. Genomes and contact
maps are made in numpy from a seed, so both packages build identical
problems from the same arguments; states and tables land on ``device``.
"""

from __future__ import annotations

import numpy as np

from graal_tpu_torch.core.likelihood import expected_data_matrix
from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.core.subfrags import SubFragTable, build_sub_frag_table


def default_params(fact=8000.0, device=None) -> RippeParams:
    return RippeParams.create(kuhn=1.0, lm=9.6, slope=-1.5, d=3.0,
                              fact=fact, d_max=900.0, v_inter=0.1,
                              device=device)


def make_genome(n_bins: int, n_contigs: int, mean_len_bp: int = 9000,
                subs_per_bin: int = 3, seed: int = 0, device=None):
    """A ground-truth genome of ``n_bins`` bins over ``n_contigs`` contigs,
    each bin split into ``subs_per_bin`` sub-fragments."""
    rng = np.random.default_rng(seed)
    sizes = np.full(n_contigs, n_bins // n_contigs)
    sizes[: n_bins - sizes.sum()] += 1
    len_bp = rng.integers(int(mean_len_bp * 0.6), int(mean_len_bp * 1.4),
                          n_bins).astype(np.int64)

    pos, id_c, start = np.zeros(n_bins, np.int64), np.zeros(n_bins, np.int64), \
        np.zeros(n_bins, np.int64)
    l_cont, l_cont_bp = np.zeros(n_bins, np.int64), np.zeros(n_bins, np.int64)
    f = 0
    for c, size in enumerate(sizes):
        off = 0
        first = f
        for p in range(size):
            pos[f], id_c[f], start[f] = p, c, off
            off += len_bp[f]
            f += 1
        l_cont[first:f] = size
        l_cont_bp[first:f] = off

    state = GenomeState.from_soa(dict(
        pos=pos, id_c=id_c, start_bp=start, len_bp=len_bp,
        circ=np.zeros(n_bins), l_cont=l_cont, l_cont_bp=l_cont_bp,
        ori=np.ones(n_bins), rep=np.zeros(n_bins), activ=np.ones(n_bins),
        id_d=np.arange(n_bins)), device=device)

    # sub-fragment geometry: random splits of each bin
    sub_ids = np.zeros((n_bins, 4), np.int64)
    sub_len = np.zeros((n_bins, 3))
    sub_acc = np.zeros((n_bins, 3))
    nxt = 0
    for b in range(n_bins):
        w = subs_per_bin if subs_per_bin > 0 else int(rng.integers(1, 4))
        sub_ids[b, 3] = w
        cuts = np.sort(rng.random(w - 1)) if w > 1 else np.empty(0)
        parts = np.diff(np.concatenate([[0.0], cuts, [1.0]])) * len_bp[b] / 1000.0
        for slot in range(w):
            sub_ids[b, slot] = nxt
            sub_len[b, slot] = parts[slot]
            sub_acc[b, slot] = 1.0
            nxt += 1
    table = build_sub_frag_table(sub_ids, sub_len, sub_acc, np.arange(n_bins),
                                 device=device)
    return state, table


def _expected_matrix_host(state: GenomeState, table: SubFragTable,
                          params: RippeParams) -> np.ndarray:
    """Repeat-free expected matrix in f64 numpy."""
    s_np = state.to_numpy()
    owner = table.owner.cpu().numpy()
    mid = (s_np["start_bp"][owner] / 1000.0
           + np.where(s_np["ori"][owner] == 1, table.prefix_kb.cpu().numpy(),
                      table.suffix_kb.cpu().numpy())
           + table.len_kb.cpu().numpy() * 0.5)
    kuhn, lm, c1, slope, d, d_max, fact, v_inter = params.astuple_np()
    s = np.abs(mid[:, None] - mid[None, :])
    same = s_np["id_c"][owner][:, None] == s_np["id_c"][owner][None, :]
    with np.errstate(all="ignore"):
        n = s * lm / kuhn
        cis = c1 * np.power(s, slope) * np.exp((d - 2.0) / (n * n + d)) * fact
    cis = np.where((s > 0) & (s < d_max), cis, 0.0)
    cis = np.maximum(cis, v_inter)
    accu = table.accu.cpu().numpy().astype(np.float64)
    na = accu[:, None] * accu[None, :] / table.n_frags_per_bins
    return np.where(same, cis, v_inter) * na


def simulate_contacts(state: GenomeState, table: SubFragTable,
                      params: RippeParams, seed: int = 0) -> np.ndarray:
    """Poisson-sample an observed data-grid matrix (numpy f32, symmetric,
    zero diagonal) from the model expectation."""
    rng = np.random.default_rng(seed)
    if not table.has_repeats and not bool(state.circ.any()):
        e = _expected_matrix_host(state, table, params)
    else:
        e = expected_data_matrix(state, table, params).cpu().numpy().astype(np.float64)
    obs = rng.poisson(np.maximum(np.triu(e, 1), 0.0)).astype(np.float32)
    return obs + obs.T


def bin_level_matrix(obs: np.ndarray, table: SubFragTable) -> np.ndarray:
    """Aggregate a data-grid matrix to the bin level (the neighbour
    proposal distribution is drawn from the bin-level matrix)."""
    data_id = table.data_id.cpu().numpy()
    owner = table.owner.cpu().numpy()
    n_bins = int(owner.max()) + 1
    # map data sub -> bin (no repeats: owner is the bin); bins own contiguous
    # sub ranges, so the group sums are two reduceat passes.
    sub_bin = np.zeros(obs.shape[0], np.int64)
    sub_bin[data_id] = owner
    starts = np.searchsorted(sub_bin, np.arange(n_bins))
    rows = np.add.reduceat(np.asarray(obs, np.float64), starts, axis=0)
    out = np.add.reduceat(rows, starts, axis=1).astype(np.float32)
    np.fill_diagonal(out, 0.0)
    return out
