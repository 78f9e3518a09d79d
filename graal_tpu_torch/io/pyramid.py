"""Multiscale contact-map pyramid: build, filter, persist, load.

Counterpart of ``graal_tpu.io.pyramid`` (host numpy, the same algorithms).
Starting from a raw dataset directory containing

- ``abs_fragments_contacts_weighted.txt`` (raw contact pairs),
- ``fragments_list.txt`` (restriction fragments),
- ``info_contigs.txt`` (source contigs),

it builds ``size_pyramid`` levels, each binning ``factor`` collinear
fragments of the level below, after removing low-coverage fragments
(threshold mean - 1.01 sd of per-fragment sparsity,
remove_problematic_fragments pyramid_sparse.py:573-848).

Every level is persisted as text: ``level_{lv}/{lv}_fragments_list.txt``,
``{lv}_contig_info.txt`` and the COO triplets ``{lv}_abs_frag_contacts.txt``
(the files the JAX package writes beside its HDF5 copy). The port writes
and reads no HDF5: :class:`Pyramid` loads each level from those text files
through the native parser. A folder built by either package opens in the
other (the JAX package rebuilds its HDF5 from the text files). The build
is idempotent: a level whose files exist is read, not rebuilt.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

from graal_tpu_torch.io import formats, native_io
from graal_tpu_torch.io.formats import FragmentTable


def _level_dir(pyramid_folder, level):
    d = os.path.join(pyramid_folder, f"level_{level}")
    os.makedirs(d, exist_ok=True)
    return d


def _sparsity_filter_threshold(coverage_nnz, n_frags):
    """Per-fragment sparsity threshold (pyramid_sparse.py:591-618)."""
    spars = coverage_nnz.astype(np.float32) / np.float32(n_frags)
    return spars, spars.mean() - 1.01 * spars.std()


def filter_fragments(frags: FragmentTable, contig_names, rows, cols, counts,
                     ref_quirks: bool = False):
    """Remove low-coverage fragments, merging each run of removed fragments
    forward into the next kept fragment of the same contig; trailing runs
    at a contig end are destroyed (pyramid_sparse.py:639-756).

    ``ref_quirks`` replicates an upstream defect for bit-exact parity
    runs: the reference resets size/gc/span but NOT the accumulated
    ``accu_frag`` at a contig boundary (pyramid_sparse.py:744 vs :714), so
    a destroyed run at a contig's tail leaks its accu count into the next
    contig's first kept fragment. Off by default (sane semantics).

    The frag_start/frag_end columns of the filtered list hold the new
    fragment's contig-relative id (both ends; pyramid_sparse.py:735-736) —
    higher pyramid levels derive their accu counts from spans of these.

    Returns (new_frags, old_to_new (0-based, -1 destroyed), kept contig
    info arrays, remapped COO).
    """
    n = frags.n_frags
    full = sp.csr_matrix((counts, (rows, cols)), shape=(n, n))
    full = full + full.T
    nnz_per_row = np.diff(full.indptr)
    spars, thresh = _sparsity_filter_threshold(nnz_per_row, n)
    bad = (spars <= thresh) | (frags.size <= 1)

    chrom_arr = np.asarray(frags.chrom)
    old_to_new = np.full(n, -1, np.int64)
    keep_idx = []          # index of the kept (anchor) fragment per new frag
    merged_size, merged_accu, merged_gc, merged_start = [], [], [], []
    merged_ifs, merged_ife = [], []
    new_rel, new_chrom = [], []

    new_id = 0
    i = 0
    accu_carry = 0            # reference quirk: leaks across contig ends
    while i < n:
        c = chrom_arr[i]
        j = i
        run = []              # pending bad run + its terminating good frag
        rel = 1
        while j < n and chrom_arr[j] == c:
            run.append(j)
            if not bad[j]:
                # merge the run into one fragment anchored at j
                for m in run:
                    old_to_new[m] = new_id
                first = run[0]
                keep_idx.append(j)
                merged_start.append(frags.start_pos[first])
                merged_size.append(frags.end_pos[j] - frags.start_pos[first])
                merged_accu.append(int(np.sum(frags.accu_frag[run]))
                                   + accu_carry)
                accu_carry = 0
                merged_gc.append(float(np.mean(frags.gc_content[run])))
                merged_ifs.append(rel)
                merged_ife.append(rel)
                new_rel.append(rel)
                new_chrom.append(c)
                rel += 1
                new_id += 1
                run = []
            j += 1
        # trailing bad run at the contig end: destroyed (old_to_new stays -1)
        if ref_quirks and run:
            accu_carry += int(np.sum(frags.accu_frag[run]))
        i = j

    new_frags = FragmentTable(
        rel_id=np.asarray(new_rel), chrom=new_chrom,
        start_pos=np.asarray(merged_start),
        end_pos=frags.end_pos[np.asarray(keep_idx, np.int64)]
        if keep_idx else np.zeros(0, np.int64),
        size=np.asarray(merged_size, np.int64),
        gc_content=np.asarray(merged_gc),
        accu_frag=np.asarray(merged_accu, np.int64),
        init_frag_start=np.asarray(merged_ifs, np.int64),
        init_frag_end=np.asarray(merged_ife, np.int64),
        sub_frag_start=np.asarray(new_rel, np.int64),
        sub_frag_end=np.asarray(new_rel, np.int64))

    # contig info for kept contigs
    names, lkb, nfr, cum = [], [], [], []
    cumul = 0
    for c in dict.fromkeys(new_chrom):
        sel = [k for k in range(new_frags.n_frags) if new_frags.chrom[k] == c]
        names.append(c)
        lkb.append(int(np.sum(new_frags.size[sel])))
        nfr.append(len(sel))
        cum.append(cumul)
        cumul += len(sel)

    nr, nc, nv = formats.remap_coo(rows, cols, counts, old_to_new,
                                   max(new_frags.n_frags, 1))
    return new_frags, old_to_new, (names, lkb, nfr, cum), (nr, nc, nv)


def subsample_level(frags: FragmentTable, contig_n_frags: dict, factor: int,
                    rows, cols, counts, min_bin_per_contig: int = 1,
                    ref_quirks: bool = False):
    """Bin ``factor`` collinear fragments per new bin
    (subsample_data_set, pyramid_sparse.py:358-569).

    Contigs with fewer than factor * min_bin_per_contig fragments keep their
    fragments unbinned. Returns (new_frags, old_to_new 0-based, contig info,
    COO).

    ``ref_quirks``: the reference's contact rewrite consumes the header
    with readline() and then ALSO starts its loop at line 1
    (pyramid_sparse.py:526-530), silently dropping the first contact entry
    of every level — replicated here for bit-exact parity runs only.
    """
    if ref_quirks and len(rows):
        first = np.lexsort((cols, rows))[0]
        keep = np.ones(len(rows), bool)
        keep[first] = False
        rows, cols, counts = rows[keep], cols[keep], counts[keep]
    n = frags.n_frags
    chrom_arr = np.asarray(frags.chrom)
    old_to_new = np.full(n, -1, np.int64)

    new_rel, new_chrom = [], []
    sp_, ep_, size_, gc_, accu_ = [], [], [], [], []
    ifs_, ife_, sfs_, sfe_ = [], [], [], []
    names, lkb_out, nfr_out, cum_out = [], [], [], []

    new_id = 0
    cumul = 0
    i = 0
    while i < n:
        c = chrom_arr[i]
        members = []
        j = i
        while j < n and chrom_arr[j] == c:
            members.append(j)
            j += 1
        n_in = len(members)
        do_bin = (n_in / np.float32(factor)) >= min_bin_per_contig and factor > 1
        rel = 1
        group = factor if do_bin else 1
        k = 0
        first_new = new_id
        while k < n_in:
            chunk = members[k: k + group]
            old_to_new[chunk] = new_id
            first, last = chunk[0], chunk[-1]
            new_rel.append(rel)
            new_chrom.append(c)
            sp_.append(frags.start_pos[first])
            ep_.append(frags.end_pos[last])
            size_.append(frags.end_pos[last] - frags.start_pos[first])
            gc_.append(float(np.mean(frags.gc_content[chunk])))
            # accu = span of the children's init_frag ids == number of
            # post-filter level-0 fragments under this bin
            # (subsample_data_set, pyramid_sparse.py:509-510)
            accu_.append(int(frags.init_frag_end[last]
                             - frags.init_frag_start[first] + 1))
            ifs_.append(int(frags.init_frag_start[first]))
            ife_.append(int(frags.init_frag_end[last]))
            sfs_.append(first + 1)   # 1-based sub-level absolute ids
            sfe_.append(last + 1)
            rel += 1
            new_id += 1
            k += group
        names.append(c)
        lkb_out.append(int(np.sum(frags.size[members])))
        nfr_out.append(new_id - first_new)
        cum_out.append(cumul)
        cumul += new_id - first_new
        i = j

    new_frags = FragmentTable(
        rel_id=np.asarray(new_rel), chrom=new_chrom,
        start_pos=np.asarray(sp_), end_pos=np.asarray(ep_),
        size=np.asarray(size_), gc_content=np.asarray(gc_),
        accu_frag=np.asarray(accu_), init_frag_start=np.asarray(ifs_),
        init_frag_end=np.asarray(ife_), sub_frag_start=np.asarray(sfs_),
        sub_frag_end=np.asarray(sfe_))
    nr, nc, nv = formats.remap_coo(rows, cols, counts, old_to_new,
                                   max(new_frags.n_frags, 1))
    return new_frags, old_to_new, (names, lkb_out, nfr_out, cum_out), (nr, nc, nv)


class Level:
    """One pyramid level: fragments + sparse contact matrix + the genome
    struct-of-arrays (pyramid_sparse.level, :1176-1488)."""

    def __init__(self, level: int, frags: FragmentTable, rows, cols, counts):
        self.level = level
        self.frags = frags
        self.n_frags = frags.n_frags
        n = self.n_frags
        self.sparse = sp.csr_matrix(
            (counts, (rows, cols)), shape=(n, n))

    def dense_matrix(self) -> np.ndarray:
        """Symmetric dense observed matrix (simulation_loader.py:81-82)."""
        m = np.asarray((self.sparse + self.sparse.T).todense(), np.float32)
        return m

    def genome_soa(self) -> dict:
        """Initial genome state arrays: one contig per source contig,
        fragments in file order (pyramid_sparse.py:1245-1348)."""
        f = self.frags
        n = f.n_frags
        chrom_arr = np.asarray(f.chrom)
        pos = np.zeros(n, np.int64)
        id_c = np.zeros(n, np.int64)
        start_bp = np.zeros(n, np.int64)
        l_cont = np.zeros(n, np.int64)
        l_cont_bp = np.zeros(n, np.int64)
        cid = 0
        i = 0
        while i < n:
            c = chrom_arr[i]
            j = i
            off = 0
            while j < n and chrom_arr[j] == c:
                pos[j] = j - i
                id_c[j] = cid
                start_bp[j] = off
                off += f.size[j]
                j += 1
            l_cont[i:j] = j - i
            l_cont_bp[i:j] = off
            cid += 1
            i = j
        return dict(pos=pos, id_c=id_c, start_bp=start_bp, len_bp=f.size,
                    circ=np.zeros(n, np.int64), l_cont=l_cont,
                    l_cont_bp=l_cont_bp, n_accu=f.accu_frag,
                    ori=np.ones(n, np.int64), rep=np.zeros(n, np.int64),
                    activ=np.ones(n, np.int64), id_d=np.arange(n))

    def mean_value_trans(self) -> float:
        """Mean inter-contig contact value (pyramid_sparse.py:1350-1373).

        Hardening over the reference: with a single source contig there are
        no trans pairs and the reference computes 0/0; here the background
        rate falls back to the mean of the most distant decile of cis pairs
        (far-cis contacts approximate the background), floored at 1e-6 —
        a zero v_inter would zero out every trans term of the likelihood
        and make the sampler fragment the genome.
        """
        m = self.dense_matrix()
        chrom_arr = np.asarray(self.frags.chrom)
        same = chrom_arr[:, None] == chrom_arr[None, :]
        trans = m[~same]
        if trans.size:
            return float(trans.sum() / trans.size)
        n = m.shape[0]
        iu, ju = np.triu_indices(n, k=max(1, int(0.9 * n)))
        far = m[iu, ju]
        return float(max(far.mean() if far.size else 0.0, 1e-6))


class Pyramid:
    """Pyramid handle: all levels + zoom maps (pyramid_sparse.pyramid),
    loaded from the level folders' text files."""

    def __init__(self, pyramid_folder: str, n_levels: int):
        self.folder = pyramid_folder
        self.n_levels = n_levels
        self.levels = {}
        for lv in range(n_levels):
            d = os.path.join(pyramid_folder, f"level_{lv}")
            frags = formats.read_fragments_list(
                os.path.join(d, f"{lv}_fragments_list.txt"))
            rows, cols, counts = native_io.read_coo(
                os.path.join(d, f"{lv}_abs_frag_contacts.txt"))
            self.levels[lv] = Level(lv, frags, rows, cols, counts)

    def get_level(self, level: int) -> Level:
        return self.levels[level]

    def sampling_level(self, level: int | None = None):
        """(level, sub level, bin_to_subs) of a run that samples at
        ``level`` (default and cap: the top level): the sub level holds the
        data sub-fragments of the level's bins, ``bin_to_subs`` their
        inclusive index range per bin (level 0 is its own sub level)."""
        lvl = self.n_levels - 1 if level is None else min(level, self.n_levels - 1)
        lev = self.levels[lvl]
        if lvl == 0:
            return lev, lev, np.stack([np.arange(lev.n_frags)] * 2, axis=1)
        return lev, self.levels[lvl - 1], self.sub_ranges(lvl)

    def sub_ranges(self, level: int) -> np.ndarray:
        """(n_bins, 2) inclusive 0-based [low, high] sub-level index ranges
        per bin of ``level`` (sub_low_index/sub_high_index,
        simulation_loader.py:681-688)."""
        f = self.levels[level].frags
        return np.stack([f.sub_frag_start - 1, f.sub_frag_end - 1], axis=1)


def build_and_filter(base_folder: str, size_pyramid: int, factor: int,
                     min_bin_per_contig: int = 1,
                     ref_quirks: bool = False) -> Pyramid:
    """Full pyramid build with fragment filtering — the reference pipeline
    (build_and_filter, pyramid_sparse.py:25-136), idempotent on re-runs.
    """
    pyramid_folder = os.path.join(base_folder, "pyramids",
                                  f"pyramid_{size_pyramid}_thresh_auto")
    os.makedirs(pyramid_folder, exist_ok=True)

    lv0_dir = _level_dir(pyramid_folder, 0)
    lv0_frag_file = os.path.join(lv0_dir, "0_fragments_list.txt")
    lv0_contig_file = os.path.join(lv0_dir, "0_contig_info.txt")
    lv0_coo_file = os.path.join(lv0_dir, "0_abs_frag_contacts.txt")

    if not (os.path.exists(lv0_frag_file) and os.path.exists(lv0_coo_file)):
        # raw inputs
        pairs = os.path.join(base_folder, "abs_fragments_contacts_weighted.txt")
        raw_frags = formats.read_fragments_list(
            os.path.join(base_folder, "fragments_list.txt"))
        contig_names, lkb, nfr, cum = formats.read_contig_info(
            os.path.join(base_folder, "info_contigs.txt"))
        rows, cols, counts = native_io.raw_pairs_to_coo(pairs)

        frags, old_to_new, cinfo, coo = filter_fragments(
            raw_frags, contig_names, rows, cols, counts,
            ref_quirks=ref_quirks)
        formats.write_fragments_list(lv0_frag_file, frags, with_sub=False)
        formats.write_contig_info(lv0_contig_file, *cinfo)
        formats.write_coo(lv0_coo_file, *coo)

    # iterate levels
    frags = formats.read_fragments_list(lv0_frag_file)
    rows, cols, counts = native_io.read_coo(lv0_coo_file)

    for lv in range(1, size_pyramid):
        d = _level_dir(pyramid_folder, lv)
        frag_file = os.path.join(d, f"{lv}_fragments_list.txt")
        contig_file = os.path.join(d, f"{lv}_contig_info.txt")
        coo_file = os.path.join(d, f"{lv}_abs_frag_contacts.txt")
        if os.path.exists(frag_file) and os.path.exists(coo_file):
            frags = formats.read_fragments_list(frag_file)
            rows, cols, counts = native_io.read_coo(coo_file)
        else:
            frags, old_to_new, cinfo, (rows, cols, counts) = subsample_level(
                frags, {}, factor, rows, cols, counts, min_bin_per_contig,
                ref_quirks=ref_quirks)
            formats.write_fragments_list(frag_file, frags, with_sub=True)
            formats.write_contig_info(contig_file, *cinfo)
            formats.write_coo(coo_file, rows, cols, counts)

    return Pyramid(pyramid_folder, size_pyramid)
