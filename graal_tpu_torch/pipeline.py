"""Repeat detection and copy extension of the assembly pipeline.

PyTorch counterpart of the repeat half of ``graal_tpu.pipeline``: the
coverage-outlier repeat detection and the copy extension that turns a
genome into a copy-expanded one (every duplicated bin gains fresh
singleton copies). Both are host numpy on struct-of-arrays dicts, so the
two packages give identical results on the same input.

The assembly run itself (``Runner``: data layer, blacklist, parameter fit,
the EM loop and its logs) arrives with ROADMAP A7.
"""

from __future__ import annotations

import numpy as np


def detect_repeats_coverage(coverage: np.ndarray, allow_repeats: bool):
    """Coverage-outlier repeat detection: bins with coverage above
    mean + 3 sd are repeats with max(1, round(cov / threshold) - 1) extra
    copies. Scale-invariant in ``coverage``, so any proportional coverage
    vector works. Returns [(bin, n_extra_copies), ...]."""
    if not allow_repeats:
        return []
    coverage = np.asarray(coverage, np.float64)
    thresh = coverage.mean() + 3 * coverage.std()
    out = []
    for b in np.nonzero(coverage > thresh)[0]:
        n_dup = int(max(1, round(coverage[b] / thresh) - 1))
        out.append((int(b), n_dup))
    return out


def detect_repeats(bin_matrix: np.ndarray, allow_repeats: bool):
    """Dense entry point: coverage = column sums + row sums."""
    if not allow_repeats:
        return []
    return detect_repeats_coverage(
        bin_matrix.sum(axis=0) + bin_matrix.sum(axis=1), allow_repeats)


def extend_with_repeats(soa: dict, duplications):
    """Append the repeat copies of ``duplications`` ([(bin, n_copies)])
    as fresh singleton contigs, and flag the originals of duplicated bins
    as repeats too. ``soa`` holds the genome fields plus ``n_accu``."""
    if not duplications:
        return soa
    soa = {k: np.asarray(v) for k, v in soa.items()}
    bins = np.repeat([b for b, _ in duplications],
                     [d for _, d in duplications]).astype(np.int64)
    m = len(bins)
    max_c = int(soa["id_c"].max()) + 1
    ext = {
        "pos": np.zeros(m, np.int64),
        "id_c": max_c + np.arange(m, dtype=np.int64),
        "start_bp": np.zeros(m, np.int64),
        "len_bp": soa["len_bp"][bins],
        "circ": np.zeros(m, np.int64),
        "l_cont": np.ones(m, np.int64),
        "l_cont_bp": soa["len_bp"][bins],
        "n_accu": soa["n_accu"][bins],
        "ori": np.ones(m, np.int64),
        "rep": np.ones(m, np.int64),
        "activ": np.ones(m, np.int64),
        "id_d": bins,
    }
    out = {k: np.concatenate([soa[k], np.asarray(ext[k], soa[k].dtype)])
           for k in soa}
    out["rep"][np.asarray([b for b, _ in duplications])] = 1
    return out
