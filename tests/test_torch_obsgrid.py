"""Kernel B4's plain version (graal_tpu_torch.ops.obsgrid_cuda) against the
JAX package's window obs grid: ``window_obs_grid_reference`` (the one-hot
einsum) and the Pallas kernel ``make_window_obs_grid`` in interpret mode,
as tests/test_obsgrid.py runs it.

The port reads the CSR map in place: a slot's window is the CSR row of its
key. The JAX side takes the windows gathered beforehand, here as the JAX
delta engine gathers them (``window_cols_vals`` of graal_tpu/core/delta.py:
the packed 8-entry storage rows of the same ``SparseObs``, masked to the
window), or, for a synthetic CSR with repeated columns in a row (which a
``SparseObs`` never holds), each row's run of entries. The port returns
the strict upper triangle (j > r), the part the delta scorer reads, so it
is compared with the upper triangle of the JAX grids. Counts are integers
held in f32, so every sum is exact in any order and the comparison is
exact (the CUDA kernel relies on the same fact).

The kernel's key -> slot table (csrc/obsgrid.cu) is transcribed here
(:func:`table_grid`: multiplicative hash, linear probing, a repeated key
keeping its smallest slot) and held to the plain version on keys that
collide in the table and on repeated keys, and the launch plan is checked
at the tiers' shapes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import sparse as js
from graal_tpu.ops.obsgrid_pallas import make_window_obs_grid, window_obs_grid_reference
from graal_tpu_torch import convert
from graal_tpu_torch.ops import obsgrid_cuda
from graal_tpu_torch.ops.obsgrid_cuda import WindowObsGrid, obs_grid_plain
import tests.test_torch_state  # noqa: F401  (one torch thread per test worker)


def sparse_map(rng, n, density=0.05):
    """A symmetric observed map of integer counts on n rows: the JAX
    ``SparseObs`` and the port's."""
    ob = rng.poisson(3.0, (n, n)) * (rng.random((n, n)) < density)
    ob = np.triu(ob, 1)
    sobs = js.sparse_from_dense((ob + ob.T).astype(np.float32))
    return sobs, convert.sparse_from_numpy(sobs._asdict())


def jax_windows(sobs, keys):
    """The JAX delta engine's windows of ``keys`` (-1: none), built as its
    ``window_cols_vals`` builds them (graal_tpu/core/delta.py:489-522):
    (cols (R, capw), masked vals (R, capw))."""
    nnz = sobs.cols.shape[0]
    n_ch = (sobs.row_cap + 14) // 8
    valid = keys >= 0
    rc = jnp.clip(keys, 0, sobs.n - 1)
    start = jnp.minimum(sobs.row_start[rc], nnz)
    end = sobs.row_start[rc + 1]
    base = start >> 3
    rows_w = base[:, None] + jnp.arange(n_ch, dtype=jnp.int32)
    pk = sobs.packed[rows_w.reshape(-1)].reshape((-1, n_ch, 8, 2))
    g = rows_w[:, :, None] * 8 + jnp.arange(8, dtype=jnp.int32)[None, None, :]
    win_valid = (g >= start[:, None, None]) & (g < end[:, None, None]) & valid[:, None, None]
    cols = pk[..., 0].reshape((-1, n_ch * 8))
    vals = jnp.where(win_valid, jax.lax.bitcast_convert_type(pk[..., 1], jnp.float32),
                     0.0).reshape((-1, n_ch * 8))
    return cols, vals


def csr_windows(row_start, cols, vals, keys):
    """Each key's CSR run as a padded window (-2 / 0 on unused slots)."""
    ks = np.maximum(keys, 0)
    length = np.where(keys >= 0, row_start[ks + 1] - row_start[ks], 0)
    cap = max(int(length.max()), 1)
    w_cols = np.full((keys.shape[0], cap), -2, np.int32)
    w_vals = np.zeros((keys.shape[0], cap), np.float32)
    for r, k in enumerate(keys):
        if k >= 0:
            run = slice(row_start[k], row_start[k + 1])
            w_cols[r, :length[r]] = cols[run]
            w_vals[r, :length[r]] = vals[run]
    return w_cols, w_vals


def jax_grids(w_cols, w_vals, keys):
    """The reference one-hot grid and the Pallas kernel's, upper triangle."""
    r, cap = w_cols.shape
    ref = window_obs_grid_reference(jnp.asarray(w_cols), jnp.asarray(w_vals), jnp.asarray(keys))
    pallas = make_window_obs_grid(r, cap, interpret=True)(
        jnp.asarray(w_cols), jnp.asarray(w_vals), jnp.asarray(keys))
    return np.triu(np.asarray(ref), 1), np.triu(np.asarray(pallas), 1)


def random_keys(rng, r, n, frac_valid=0.5):
    """R slots, about ``frac_valid`` of them holding distinct CSR rows."""
    keys = np.full(r, -1, np.int32)
    k = max(int(r * frac_valid), 1)
    keys[rng.permutation(r)[:k]] = rng.choice(n, k, replace=False).astype(np.int32)
    return keys


def colliding_keys(rng, r, n):
    """R distinct keys of which most share a few table buckets of the
    kernel's table for R (long probe runs), the rest random."""
    buckets = obsgrid_cuda.bucket(np.arange(n, dtype=np.int64), obsgrid_cuda.log2_capacity(r))
    crowded = np.argsort(-np.bincount(buckets), kind="stable")[:4]
    keys = np.concatenate([np.nonzero(buckets == b)[0] for b in crowded])[: r // 2]
    rest = np.setdiff1d(np.arange(n), keys)
    keys = np.concatenate([keys, rng.choice(rest, r - len(keys), replace=False)])
    return rng.permutation(keys).astype(np.int32)


CASES = ["ragged_r130", "dup_cols", "all_keys_invalid", "batch3", "dup_keys", "collisions"]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_reference_and_pallas(case):
    rng = np.random.default_rng(CASES.index(case))
    n = 2000 if case == "collisions" else 600     # many keys a bucket of the table
    sobs, tsobs = sparse_map(rng, n)
    row_start, cols, vals = (np.asarray(sobs.row_start), np.asarray(sobs.cols),
                             np.asarray(sobs.vals))
    if case == "ragged_r130":      # R not a multiple of the 256 TPU tile
        keys = [random_keys(rng, 130, n)]
    elif case == "dup_cols":       # the same column twice in one CSR row
        row_start, cols, vals = duplicate_columns(rng, row_start, cols, vals)
        keys = [random_keys(rng, 64, n)]
    elif case == "all_keys_invalid":
        keys = [np.full(40, -1, np.int32)]
    elif case == "batch3":         # a neighbour batch
        keys = [random_keys(rng, 100, n) for _ in range(3)]
    elif case == "dup_keys":
        # two slots sharing a key, as two copies of a bin under data_keys;
        # the map holds no entry in the shared keys' rows or columns
        keys = [repeated_keys(rng, 90, n, n_pairs=6)]
        uniq, counts = np.unique(keys[0][keys[0] >= 0], return_counts=True)
        row_start, cols, vals = drop_entries_of(row_start, cols, vals, uniq[counts > 1])
    else:                          # keys crowding a few buckets of the table
        keys = [colliding_keys(rng, 128, n)]
    keys = np.stack(keys)
    got = obs_grid_plain(torch.as_tensor(row_start), torch.as_tensor(cols),
                         torch.as_tensor(vals), torch.as_tensor(keys)).numpy()
    assert got.shape == keys.shape + (keys.shape[1],) and got.dtype == np.float32
    for a in range(keys.shape[0]):
        if case in ("dup_cols", "dup_keys"):
            w_cols, w_vals = csr_windows(row_start, cols, vals, keys[a])
        else:
            w_cols, w_vals = (np.asarray(x) for x in jax_windows(sobs, jnp.asarray(keys[a])))
        ref, pallas = jax_grids(w_cols, w_vals, keys[a])
        np.testing.assert_array_equal(got[a], ref)
        np.testing.assert_array_equal(got[a], pallas)
    assert np.all(np.tril(got[0]) == 0)
    if case != "all_keys_invalid":
        assert np.any(got > 0)
    if case in ("collisions", "dup_keys"):
        assert torch.equal(table_grid(row_start, cols, vals, keys),
                           torch.as_tensor(got))


def duplicate_columns(rng, row_start, cols, vals):
    """The CSR map with every other row's first entry repeated."""
    rows = np.repeat(np.arange(len(row_start) - 1), np.diff(row_start))
    extra = row_start[:-1][(np.diff(row_start) > 0) & (np.arange(len(row_start) - 1) % 2 == 0)]
    order = np.argsort(np.concatenate([np.arange(len(cols)), extra]), kind="stable")
    new_cols = np.concatenate([cols, cols[extra]])[order]
    new_vals = np.concatenate([vals, vals[extra] + 1.0])[order]
    new_rows = np.concatenate([rows, rows[extra]])[order]
    counts = np.bincount(new_rows, minlength=len(row_start) - 1)
    new_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    assert len(new_cols) > len(cols)
    return new_start, new_cols.astype(np.int32), new_vals.astype(np.float32)


def repeated_keys(rng, r, n, n_pairs):
    """R slots of distinct keys (a third invalid), ``n_pairs`` of them
    repeated in a second slot."""
    keys = random_keys(rng, r, n, frac_valid=0.6)
    valid = np.nonzero(keys >= 0)[0]
    src = rng.choice(valid, n_pairs, replace=False)
    dst = rng.choice(np.setdiff1d(np.arange(r), np.concatenate([valid, src])), n_pairs,
                     replace=False)
    keys[dst] = keys[src]
    return keys


def drop_entries_of(row_start, cols, vals, shared):
    """The map without the entries in the rows or columns ``shared``."""
    rows = np.repeat(np.arange(len(row_start) - 1), np.diff(row_start))
    keep = ~np.isin(rows, shared) & ~np.isin(cols, shared)
    counts = np.bincount(rows[keep], minlength=len(row_start) - 1)
    return (np.concatenate([[0], np.cumsum(counts)]).astype(np.int64), cols[keep],
            vals[keep])


def table_grid(row_start, cols, vals, keys):
    """csrc/obsgrid.cu's lookup in Python: each neighbour's keys inserted
    into a table of 2^log2cap 16-bit slots by multiplicative hashing and
    linear probing (a repeated key keeps its smallest slot: the kernel's
    rule whatever the order of its inserts, here inserted in slot order),
    each window entry looked up the same way; strict upper triangle.
    (M, R, R) f32."""
    m, r = keys.shape
    log2cap = obsgrid_cuda.log2_capacity(r)
    cap = 1 << log2cap
    out = torch.zeros((m, r, r), dtype=torch.float32)
    for a in range(m):
        tab = np.full(cap, -1)
        for j, k in enumerate(keys[a]):
            if k < 0:
                continue
            h = obsgrid_cuda.bucket(int(k), log2cap)
            while tab[h] >= 0 and keys[a, tab[h]] != k:
                h = (h + 1) % cap
            if tab[h] < 0:
                tab[h] = j
        for i, k in enumerate(keys[a]):
            if k < 0:
                continue
            for e in range(row_start[k], row_start[k + 1]):
                h = obsgrid_cuda.bucket(int(cols[e]), log2cap)
                while tab[h] >= 0 and keys[a, tab[h]] != cols[e]:
                    h = (h + 1) % cap
                if tab[h] >= 0 and tab[h] > i:
                    out[a, i, tab[h]] += float(vals[e])
    return out


def test_repeated_key_hit_goes_to_its_first_slot():
    """Outside the callers' contract (an entry whose column is a repeated
    key), the kernel's table and the plain version still agree: the entry
    goes to the key's first slot."""
    rng = np.random.default_rng(11)
    _, tsobs = sparse_map(rng, 300, density=0.2)
    row_start, cols, vals = (x.numpy() for x in (tsobs.row_start, tsobs.cols, tsobs.vals))
    keys = np.stack([repeated_keys(rng, 80, 300, n_pairs=8) for _ in range(2)])
    got = obs_grid_plain(*(torch.as_tensor(x) for x in (row_start, cols, vals, keys)))
    shared = [k for k, n in zip(*np.unique(keys[0][keys[0] >= 0], return_counts=True)) if n > 1]
    assert np.isin(cols, shared).any()              # the contract is broken here
    assert torch.equal(table_grid(row_start, cols, vals, keys), got)
    first = {int(k): int(np.nonzero(keys[0] == k)[0][0]) for k in shared}
    later = [j for j, k in enumerate(keys[0]) if int(k) in first and j != first[int(k)]]
    assert got[0][:, later].sum() == 0 and got[0].sum() > 0


def test_colliding_keys_probe_long_runs():
    """The collision case fills runs of the kernel's table, as it means to."""
    rng = np.random.default_rng(9)
    keys = colliding_keys(rng, 128, 2000)
    log2cap = obsgrid_cuda.log2_capacity(128)
    assert len(np.unique(keys)) == 128
    buckets = [obsgrid_cuda.bucket(int(k), log2cap) for k in keys]
    assert np.bincount(buckets).max() >= 8


def test_duplicate_columns_sum():
    # CSR rows of a 10-row map: 0 -> cols (5, 5, 7), 1 -> (5, 9), the rest
    # empty. Neighbour 1's slot 0 (key 0) reads row 0: both entries of
    # column 5 land in slot 1 (key 5), column 7 in slot 2
    row_start = torch.tensor([0, 3, 5] + [5] * 8, dtype=torch.int64)
    cols = torch.tensor([5, 5, 7, 5, 9], dtype=torch.int32)
    vals = torch.tensor([2.0, 3.0, 1.0, 4.0, 6.0])
    keys = torch.tensor([[1, 0, -1], [0, 5, 7]], dtype=torch.int32)
    out = obs_grid_plain(row_start, cols, vals, keys)
    assert out[1, 0, 1].item() == 5.0           # 2 + 3
    assert out[1, 0, 2].item() == 1.0
    assert out[1].sum().item() == 6.0           # nothing else, no lower triangle
    assert out[0].sum().item() == 0.0           # rows 1 and 0 hold no column 1 or 0


def test_wrapper_dispatch_on_cpu():
    rng = np.random.default_rng(3)
    _, tsobs = sparse_map(rng, 50)
    keys = torch.as_tensor(random_keys(rng, 20, 50))[None]
    args = (tsobs.row_start, tsobs.cols, tsobs.vals, keys)
    grid = WindowObsGrid()
    assert torch.equal(grid(*args), obs_grid_plain(*args))
    assert grid.n_launches == 0
    with pytest.raises(ValueError):
        grid.launch(*args)                     # the kernel takes CUDA tensors only


def smem_bytes(r, width, log2cap):
    """csrc/obsgrid.cu obsgrid_smem_bytes: 8 warps' row buffers of
    ``width`` floats, the keys and the table."""
    return 8 * width * 4 + r * 4 + (1 << log2cap) * 2


@pytest.mark.parametrize("r,m,want_ranges", [
    (256, 5, 1), (1024, 5, 1), (1024, 10, 1), (4096, 5, 1), (8192, 5, 2), (16384, 5, 6),
    (16384, 20, 6),
])
def test_launch_plan(r, m, want_ranges):
    """The plan at the tiers of the ladder: every warp of a block has a row
    buffer in an H100 block's shared memory, of the widest range of
    columns that fits (the whole row up to R = 4,096), each warp two rows
    or more, the blocks within one round of the card."""
    limit = 227 * 1024
    per_sm = {True: 1}

    def resident(smem, n_ranges):
        per_sm[True] = max(1, min(8, (228 * 1024) // (smem + 1024)))
        return per_sm[True] * 132

    rows_per_block, width, log2cap = obsgrid_cuda.plan(r, m, limit, smem_bytes, 8, resident)
    n_ranges = -(-r // width)
    assert n_ranges == want_ranges and width % 4 == 0
    assert (1 << log2cap) >= 2 * r and smem_bytes(r, width, log2cap) <= limit
    assert n_ranges == 1 or smem_bytes(r, -(-r // (n_ranges - 1)), log2cap) > limit
    assert rows_per_block % 8 == 0 and rows_per_block >= 2 * 8
    blocks = -(-r // rows_per_block) * m
    assert blocks <= per_sm[True] * 132


def test_launch_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        obsgrid_cuda.plan(40_000, 5, 227 * 1024, smem_bytes, 8, lambda smem, n_ranges: 132)


def test_bucket_is_the_kernels_hash():
    # (key * 0x9E3779B1 mod 2^32) >> (32 - log2cap)
    assert obsgrid_cuda.bucket(0, 11) == 0
    assert obsgrid_cuda.bucket(1, 11) == 0x9E3779B1 >> 21
    assert obsgrid_cuda.bucket(100_000, 15) == ((100_000 * 0x9E3779B1) % 2**32) >> 17
    keys = np.array([0, 1, 100_000, 2**31 - 1], np.int64)
    assert obsgrid_cuda.bucket(keys, 15).tolist() == [obsgrid_cuda.bucket(int(k), 15)
                                                      for k in keys]
    assert [obsgrid_cuda.log2_capacity(r) for r in (1, 16, 130, 1024, 1025, 16384)] == \
        [5, 5, 9, 11, 12, 15]
