"""Sub-fragment tables: the static geometry linking bins to the data grid.

PyTorch counterpart of ``graal_tpu.core.subfrags``. One row per
copy-expanded sub-fragment (K rows): owner copy-fragment, data-grid index,
length (kb), accumulated-fragment count, and orientation prefix/suffix
lengths. Built on the host in numpy (f64), stored as device tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SubFragTable(NamedTuple):
    """Static per-level sub-fragment geometry (tensors of length K)."""

    owner: torch.Tensor      # (K,) int32: copy-fragment index owning this sub
    data_id: torch.Tensor    # (K,) int32: index into the observed data grid
    len_kb: torch.Tensor     # (K,) float32: sub-fragment length in kb
    accu: torch.Tensor       # (K,) float32: n of level-0 frags accumulated
    prefix_kb: torch.Tensor  # (K,) float32: sum of earlier-slot lengths in bin
    suffix_kb: torch.Tensor  # (K,) float32: sum of later-slot lengths in bin
    n_data_sub: int          # S: size of the data grid
    n_frags_per_bins: float  # (mean accu)^2 normaliser
    has_repeats: bool        # True when K > S (copy expansion non-trivial)

    @property
    def n_subs(self) -> int:
        return self.owner.shape[0]


def copy_csr(data_id, n_data_sub: int):
    """The data sub -> copy rows CSR of a table (the reference's dispatcher
    direction): (copy_start (S + 1,), copy_rows (K,), c_max) as numpy, the
    copy rows sorted by data sub (stable: a sub's copies keep row order),
    c_max the most copies of any data sub."""
    data_id = np.asarray(data_id)
    counts = np.bincount(data_id, minlength=n_data_sub)
    return (np.concatenate([[0], np.cumsum(counts)]), np.argsort(data_id, kind="stable"),
            int(counts.max()) if len(counts) else 1)


def build_sub_frag_table(sub_ids, sub_len_kb, sub_accu, id_d,
                         device=None) -> SubFragTable:
    """Build the flattened table.

    - ``sub_ids``: (n_bins, 4) int — data-grid indices of each bin's subs in
      slots 0..2, slot 3 = sub count w.
    - ``sub_len_kb``: (n_bins, 3) float — per-slot lengths in kb.
    - ``sub_accu``: (n_bins, 3) int — per-slot accumulated-fragment counts.
    - ``id_d``: (n_copy_frags,) int — data bin of each copy-fragment
      (identity when there are no repeats).
    """
    sub_ids = np.asarray(sub_ids)
    sub_len_kb = np.asarray(sub_len_kb, np.float64)
    sub_accu = np.asarray(sub_accu, np.float64)
    id_d = np.asarray(id_d)

    # slot prefixes/suffixes as explicit <=3-term left-to-right sums
    w = sub_ids[id_d, 3].astype(np.int64)                   # (F,) copies
    owner = np.repeat(np.arange(len(id_d), dtype=np.int64), w)
    row0 = np.cumsum(w) - w
    slot = np.arange(int(w.sum()), dtype=np.int64) - np.repeat(row0, w)
    b = np.repeat(id_d, w)                                   # bin per row
    w_r = np.repeat(w, w)
    data_ids = sub_ids[b, slot]
    lens = sub_len_kb[b, slot]
    accus = sub_accu[b, slot]
    l0 = sub_len_kb[b, 0]
    l1 = np.where(w_r >= 2, sub_len_kb[b, 1], 0.0)
    l2 = np.where(w_r >= 3, sub_len_kb[b, 2], 0.0)
    c1 = l0 + l1
    total = c1 + l2
    pres = np.choose(slot, [np.zeros_like(l0), l0, c1])
    cums = np.choose(slot, [l0, c1, total])
    sufs = total - cums

    n_data_sub = int(sub_ids[:, :3].max()) + 1
    sl3 = np.arange(3)[None, :]
    bin_mask = sl3 < sub_ids[:, 3][:, None]                  # (n_bins, 3)
    all_accu = sub_accu[:, :3][bin_mask].astype(np.float32)
    n_frags_per_bins = float(np.float32(np.mean(all_accu)) ** 2)

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x, dtype), device=device)

    return SubFragTable(
        owner=t(owner, np.int32),
        data_id=t(data_ids, np.int32),
        len_kb=t(lens, np.float32),
        accu=t(accus, np.float32),
        prefix_kb=t(pres, np.float32),
        suffix_kb=t(sufs, np.float32),
        n_data_sub=n_data_sub,
        n_frags_per_bins=n_frags_per_bins,
        has_repeats=len(owner) != n_data_sub,
    )


def table_from_level(level_frags: dict, sub_level_frags: dict,
                     bin_to_subs: np.ndarray, id_d=None,
                     device=None) -> SubFragTable:
    """Build the table from level struct-of-arrays.

    ``bin_to_subs``: (n_bins, 2) inclusive [low, high] data-sub index ranges
    per bin (at most 3 subs per bin).
    """
    n_bins = bin_to_subs.shape[0]
    sub_len_bp = np.asarray(sub_level_frags["len_bp"], np.float64)
    sub_accu_src = np.asarray(sub_level_frags["n_accu"], np.float64)
    lo = np.asarray(bin_to_subs[:, 0], np.int64)
    w = np.asarray(bin_to_subs[:, 1], np.int64) - lo + 1
    if np.any(w > 3):
        b = int(np.argmax(w > 3))
        raise ValueError(f"bin {b} has {int(w[b])} > 3 sub-fragments")
    sl = np.arange(3)[None, :]
    valid = sl < w[:, None]
    idx = np.where(valid, lo[:, None] + sl, 0)
    sub_ids = np.concatenate(
        [np.where(valid, idx, 0), w[:, None]], axis=1)
    sub_len = np.where(valid, sub_len_bp[idx] / 1000.0, 0.0)
    sub_acc = np.where(valid, sub_accu_src[idx], 0.0)
    if id_d is None:
        id_d = np.arange(n_bins)
    return build_sub_frag_table(sub_ids, sub_len, sub_acc, id_d, device=device)


def trivial_table(len_bp, n_accu=None, device=None) -> SubFragTable:
    """One sub-fragment per bin (the coarsest useful geometry)."""
    len_bp = np.asarray(len_bp, np.float64)
    n = len(len_bp)
    if n_accu is None:
        n_accu = np.ones(n)
    sub_ids = np.zeros((n, 4), np.int64)
    sub_ids[:, 0] = np.arange(n)
    sub_ids[:, 3] = 1
    sub_len = np.zeros((n, 3))
    sub_len[:, 0] = len_bp / 1000.0
    sub_acc = np.zeros((n, 3))
    sub_acc[:, 0] = np.asarray(n_accu, np.float64)
    return build_sub_frag_table(sub_ids, sub_len, sub_acc, np.arange(n),
                                device=device)
