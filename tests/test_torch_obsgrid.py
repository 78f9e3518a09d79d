"""Kernel B4's plain version (graal_tpu_torch.ops.obsgrid_cuda) against the
JAX package's window obs grid: ``window_obs_grid_reference`` (the one-hot
einsum) and the Pallas kernel ``make_window_obs_grid`` in interpret mode,
as tests/test_obsgrid.py runs it.

The port returns the strict upper triangle (j > r), the part the delta
scorer reads, so it is compared with the upper triangle of the JAX grids.
Window values are observed counts, integers held in f32, so every sum is
exact in any order and the comparison is exact (the CUDA kernel relies on
the same fact).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.ops.obsgrid_pallas import make_window_obs_grid, window_obs_grid_reference
from graal_tpu_torch.ops.obsgrid_cuda import WindowObsGrid, obs_grid_plain
import tests.test_torch_state  # noqa: F401  (one torch thread per test worker)


def windows(rng, r, cap, n_keys, dup_cols=False):
    """Random CSR-like windows: integer counts, unused slots (-2, 0), about
    half the key slots invalid (-1)."""
    cols = rng.integers(0, n_keys, (r, cap)).astype(np.int32)
    if dup_cols:
        cols[:, 1::2] = cols[:, ::2][:, : cols[:, 1::2].shape[1]]
    vals = rng.poisson(4.0, (r, cap)).astype(np.float32)
    unused = rng.random((r, cap)) < 0.3
    cols[unused] = -2
    vals[unused] = 0.0
    keys = np.full(r, -1, np.int32)
    k = max(r // 2, 1)
    keys[rng.permutation(r)[:k]] = rng.choice(n_keys, k, replace=False).astype(np.int32)
    return cols, vals, keys


def upper(x):
    return np.triu(np.asarray(x), 1)


CASES = ["ragged_r130", "dup_cols", "all_keys_invalid", "batch3"]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_reference_and_pallas(case):
    rng = np.random.default_rng(CASES.index(case))
    if case == "ragged_r130":      # R not a multiple of the 256 TPU tile
        batch = [windows(rng, 130, 9, 600)]
    elif case == "dup_cols":       # the same column twice in one window
        batch = [windows(rng, 64, 12, 80, dup_cols=True)]
    elif case == "all_keys_invalid":
        c, v, k = windows(rng, 40, 7, 100)
        batch = [(c, v, np.full_like(k, -1))]
    else:                          # a neighbour batch
        batch = [windows(rng, 100, 11, 400) for _ in range(3)]
    cols, vals, keys = (np.stack(x) for x in zip(*batch))
    r, cap = cols.shape[1:]
    got = obs_grid_plain(torch.as_tensor(cols), torch.as_tensor(vals),
                         torch.as_tensor(keys)).numpy()
    ref = np.asarray(jax.vmap(window_obs_grid_reference)(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(keys)))
    pallas = np.asarray(jax.vmap(make_window_obs_grid(r, cap, interpret=True))(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(keys)))
    np.testing.assert_array_equal(got, upper(ref))
    np.testing.assert_array_equal(got, upper(pallas))
    if case == "dup_cols":
        assert np.any(got > 0)


def test_duplicate_columns_sum():
    cols = torch.tensor([[[5, 5, 7], [5, -2, 9]]], dtype=torch.int32)
    vals = torch.tensor([[[2.0, 3.0, 1.0], [4.0, 0.0, 6.0]]])
    keys = torch.tensor([[9, 5]], dtype=torch.int32)
    out = obs_grid_plain(cols, vals, keys)
    # row 0 / key 5 sits in slot 1 (upper triangle): 2 + 3
    assert out[0, 0, 1].item() == 5.0
    assert out[0, 1, 0].item() == 0.0          # lower triangle is zero


def test_wrapper_dispatch_on_cpu():
    rng = np.random.default_rng(3)
    cols, vals, keys = (torch.as_tensor(x)[None] for x in windows(rng, 20, 5, 50))
    grid = WindowObsGrid()
    assert torch.equal(grid(cols, vals, keys), obs_grid_plain(cols, vals, keys))
    assert grid.n_launches == 0
    with pytest.raises(ValueError):
        grid.launch(cols, vals, keys)          # the kernel takes CUDA tensors only
