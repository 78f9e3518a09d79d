"""GRAAL dataset file formats: parsers and writers.

Counterpart of ``graal_tpu.io.formats`` (pure numpy, the same code): the
on-disk interchange formats follow the reference exactly, so a dataset
or pyramid folder written by either package is read by the other. The
numpy ``raw_pairs_to_coo`` / ``read_coo`` here are the plain version of
the native parser (:mod:`graal_tpu_torch.io.native_io`).

- ``info_contigs.txt``: tab-separated, header
  ``contig  length_kb  n_frags  cumul_length``.
- ``fragments_list.txt``: tab-separated, header
  ``id  chrom  start_pos  end_pos  size  gc_content [accu_frag
  init_frag_start init_frag_end [sub_frag_start sub_frag_end]]``
  (6 columns raw input; 9 after level-0 init, init_frag_list
  pyramid_sparse.py:328-355; 11 at levels > 0, subsample_data_set
  :487-512). ``id`` is 1-based within its contig.
- ``abs_fragments_contacts_weighted.txt``: one line per sequenced contact
  pair, 1-based absolute fragment ids (columns 0 and 1; extra columns
  ignored).
- COO contact files (``*_abs_frag_contacts.txt``): header
  ``id_frag_a  id_frag_b  n_contact``, 0-based, a <= b, sorted
  (abs_contact_2_coo_file pyramid_sparse.py:222-264).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class FragmentTable:
    """Per-fragment records of one pyramid level (columns as numpy arrays)."""

    rel_id: np.ndarray        # 1-based id within contig
    chrom: list               # contig name per fragment
    start_pos: np.ndarray     # bp start within source contig
    end_pos: np.ndarray       # bp end
    size: np.ndarray          # bp length
    gc_content: np.ndarray
    accu_frag: np.ndarray     # number of level-0 fragments accumulated
    init_frag_start: np.ndarray  # level-0 coordinate range
    init_frag_end: np.ndarray
    sub_frag_start: np.ndarray   # sub-level (level-1) absolute ids (1-based)
    sub_frag_end: np.ndarray

    @property
    def n_frags(self) -> int:
        return len(self.rel_id)


def read_fragments_list(path: str) -> FragmentTable:
    rel_id, chrom, sp, ep, size, gc = [], [], [], [], [], []
    accu, ifs, ife, sfs, sfe = [], [], [], [], []
    with open(path) as fh:
        fh.readline()
        for i, line in enumerate(fh):
            d = line.rstrip("\n").split("\t")
            rel_id.append(int(d[0]))
            chrom.append(d[1])
            sp.append(int(d[2]))
            ep.append(int(d[3]))
            size.append(int(float(d[4])))
            gc.append(float(d[5]))
            accu.append(int(float(d[6])) if len(d) > 6 else 1)
            ifs.append(int(d[7]) if len(d) > 7 else i + 1)
            ife.append(int(d[8]) if len(d) > 8 else i + 1)
            sfs.append(int(d[9]) if len(d) > 9 else i + 1)
            sfe.append(int(d[10]) if len(d) > 10 else i + 1)
    return FragmentTable(
        rel_id=np.asarray(rel_id), chrom=chrom, start_pos=np.asarray(sp),
        end_pos=np.asarray(ep), size=np.asarray(size),
        gc_content=np.asarray(gc), accu_frag=np.asarray(accu),
        init_frag_start=np.asarray(ifs), init_frag_end=np.asarray(ife),
        sub_frag_start=np.asarray(sfs), sub_frag_end=np.asarray(sfe))


def write_fragments_list(path: str, table: FragmentTable, with_sub: bool):
    """Write a 9-column (level 0) or 11-column (levels > 0) fragments list."""
    with open(path, "w") as fh:
        cols = ["id", "chrom", "start_pos", "end_pos", "size", "gc_content",
                "accu_frag", "init_frag_start", "init_frag_end"]
        if with_sub:
            cols += ["sub_frag_start", "sub_frag_end"]
        fh.write("\t".join(cols) + "\n")
        for i in range(table.n_frags):
            row = [table.rel_id[i], table.chrom[i], table.start_pos[i],
                   table.end_pos[i], table.size[i], table.gc_content[i],
                   table.accu_frag[i], table.init_frag_start[i],
                   table.init_frag_end[i]]
            if with_sub:
                row += [table.sub_frag_start[i], table.sub_frag_end[i]]
            fh.write("\t".join(str(x) for x in row) + "\n")


def read_contig_info(path: str):
    """-> (names, length_kb, n_frags, cumul_length) lists/arrays."""
    names, length_kb, n_frags, cumul = [], [], [], []
    with open(path) as fh:
        fh.readline()
        for line in fh:
            d = line.rstrip("\n").split("\t")
            names.append(d[0])
            length_kb.append(float(d[1]))
            n_frags.append(int(d[2]))
            cumul.append(int(d[3]))
    return names, np.asarray(length_kb), np.asarray(n_frags), np.asarray(cumul)


def write_contig_info(path: str, names, length_kb, n_frags, cumul):
    with open(path, "w") as fh:
        fh.write("contig\tlength_kb\tn_frags\tcumul_length\n")
        for i in range(len(names)):
            fh.write(f"{names[i]}\t{length_kb[i]}\t{n_frags[i]}\t{cumul[i]}\n")


def raw_pairs_to_coo(pairs_path: str, coo_path: str | None = None):
    """Aggregate a raw 1-based contact-pair list into a 0-based sorted COO
    triplet array (abs_contact_2_coo_file, pyramid_sparse.py:222-264).

    Returns (rows, cols, counts) with rows <= cols; optionally writes the
    COO text file.
    """
    data = np.loadtxt(pairs_path, dtype=np.int64, skiprows=1, usecols=(0, 1),
                      ndmin=2)
    if data.size == 0:
        rows = cols = counts = np.zeros(0, np.int64)
    else:
        a = data.min(axis=1) - 1
        b = data.max(axis=1) - 1
        n = max(int(b.max()) + 1, 1)
        lin = a * n + b
        uniq, counts = np.unique(lin, return_counts=True)
        rows, cols = uniq // n, uniq % n
    if coo_path is not None:
        write_coo(coo_path, rows, cols, counts)
    return rows, cols, counts


def read_coo(path: str):
    data = np.loadtxt(path, dtype=np.int64, skiprows=1, ndmin=2)
    if data.size == 0:
        return (np.zeros(0, np.int64),) * 3
    return data[:, 0], data[:, 1], data[:, 2]


def write_coo(path: str, rows, cols, counts):
    with open(path, "w") as fh:
        fh.write("id_frag_a\tid_frag_b\tn_contact\n")
        for r, c, v in zip(rows, cols, counts):
            fh.write(f"{r}\t{c}\t{v}\n")


def remap_coo(rows, cols, counts, old_to_new, n_new: int):
    """Map COO triplets through an old->new fragment index map (entries < 0
    are destroyed), re-aggregate duplicates, keep a <= b ordering."""
    na = old_to_new[rows]
    nb = old_to_new[cols]
    keep = (na >= 0) & (nb >= 0)
    na, nb, counts = na[keep], nb[keep], counts[keep]
    a = np.minimum(na, nb)
    b = np.maximum(na, nb)
    lin = a * n_new + b
    order = np.argsort(lin, kind="stable")
    lin, counts = lin[order], counts[order]
    uniq, start = np.unique(lin, return_index=True)
    sums = np.add.reduceat(counts, start) if len(counts) else counts
    return uniq // n_new, uniq % n_new, sums
