"""The flagship problems and the dense EM step, built on a given device.

- :func:`problem` / :func:`entry`, counterparts of
  ``__graft_entry__._problem`` / ``entry()``: a synthetic S1-pyramid-4-scale
  genome (384 bins x 3 sub-fragments, K = 1,152, 16 contigs) with its
  observed map and neighbour table, and one EM step over it (delta = 4, 65
  candidates per step) scored by the dense scorer, which launches the CUDA
  kernel when ``device`` is a GPU.
- :func:`scale_problem`: the chr1-class sparse problem of the chr1-scale
  path (``scale.ScaleRunner``), the recipe of the JAX package's
  ``benchmarks/bench_scale.py``: 100,000 fragments with one sub each over
  20 contigs at full coverage, shuffled into 400 pieces.
"""

from __future__ import annotations

import numpy as np
import torch

from graal_tpu_torch.core import mcmc
from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer
from graal_tpu_torch.utils.synthetic import (bin_level_matrix, default_params,
                                             make_genome, simulate_contacts)
from graal_tpu_torch.utils.synthetic_sparse import (make_scale_genome, scale_params,
                                                    shuffle_genome,
                                                    simulate_sparse_contacts)

DELTA = 4


def problem(n_bins=384, n_contigs=16, seed=0, device="cpu"):
    """(state, table, params, obs, nb): the true genome, its table and
    params on ``device``, the observed map as numpy f32, the neighbour
    table on ``device``."""
    state, table = make_genome(n_bins, n_contigs, subs_per_bin=3, seed=seed,
                               device=device)
    params = default_params(device=device)
    obs = simulate_contacts(state, table, params, seed=seed)
    bins = bin_level_matrix(obs, table)
    nb = mcmc.build_neighbour_table(bins, np.arange(n_bins), n_bins,
                                    device=device)
    return state, table, params, obs, nb


def entry(device="cpu", **problem_kw):
    """(step, example_args): one EM step on the flagship problem (or the
    :func:`problem` that ``problem_kw`` asks for), with the dense scorer,
    and arguments for one call (state, generator, params, f_a, f_t)."""
    state, table, params, obs, nb = problem(device=device, **problem_kw)
    scorer = make_dense_scorer(table, obs, device)
    step = mcmc.make_em_step(table, obs, nb, delta=DELTA, scorer=scorer)
    gen = torch.Generator(device=device).manual_seed(0)
    f_a = torch.tensor(7, dtype=torch.int64, device=device)
    return step, (state, gen, params, f_a, 1.0)


def scale_problem(n_bins=100_000, n_contigs=None, n_pieces=None, seed=31,
                  shuffle_seed=32, device="cpu"):
    """(truth, shuffled, table, params, sobs): the true genome, its shuffled
    start, the one-sub-per-bin table, the full-coverage params and the
    sparse observed map, all on ``device``. ``n_contigs`` defaults to
    max(n_bins // 5000, 4) and ``n_pieces`` to max(n_bins // 250, 8), the
    recipe of the JAX package's chr1-scale benchmarks."""
    if n_contigs is None:
        n_contigs = max(n_bins // 5000, 4)
    if n_pieces is None:
        n_pieces = max(n_bins // 250, 8)
    params = scale_params(device=device)
    truth, table = make_scale_genome(n_bins, n_contigs, seed=seed, device=device)
    sobs = simulate_sparse_contacts(truth, table, params, seed=seed)
    shuffled = shuffle_genome(truth, n_pieces, seed=shuffle_seed)
    return truth, shuffled, table, params, sobs
