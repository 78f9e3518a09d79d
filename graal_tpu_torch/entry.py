"""The flagship problems and the dense EM step, built on a given device.

Every function here puts its tensors on the card unless ``device`` asks
for another (the CPU tests pass ``device="cpu"``).

- :func:`problem` / :func:`entry`, counterparts of
  ``__graft_entry__._problem`` / ``entry()``: a synthetic S1-pyramid-4-scale
  genome (384 bins x 3 sub-fragments, K = 1,152, 16 contigs) with its
  observed map and neighbour table, and one EM step over it (delta = 4, 65
  candidates per step) scored by the dense scorer, which launches the CUDA
  kernel when ``device`` is a GPU; :func:`problem_jump_table`, its MTM / MH
  jumping distributions.
- :func:`repeat_problem`: the flagship genome with 12 bins duplicated
  once (the recipe of the JAX package's repeat scorer tests at the
  flagship width): K = 1,188 copy rows on S = 1,152 data subs, 396
  fragments, 130 candidates per EM step, scored by the copy-summing
  scorer.
- :func:`scale_problem`: the chr1-class sparse problem of the chr1-scale
  path (``scale.ScaleRunner``), the recipe of the JAX package's
  ``benchmarks/bench_scale.py``: 100,000 fragments with one sub each over
  20 contigs at full coverage, shuffled into 400 pieces.
- :func:`scale_repeat_problem`: the same chr1-scale recipe with repeat
  copies, as the JAX package's ``benchmarks/bench_scale_repeats.py``
  builds it (20,000 fragments, 200 duplicated bins).
"""

from __future__ import annotations

import numpy as np
import torch

from graal_tpu_torch.core import mcmc
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.core.subfrags import SubFragTable, build_sub_frag_table
from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer
from graal_tpu_torch.pipeline import extend_with_repeats
from graal_tpu_torch.utils.synthetic import (bin_level_matrix, default_params,
                                             make_genome, simulate_contacts)
from graal_tpu_torch.utils.synthetic_sparse import (add_scale_repeats,
                                                    make_scale_genome, scale_params,
                                                    shuffle_genome,
                                                    simulate_sparse_contacts)

DELTA = 4


def problem(n_bins=384, n_contigs=16, seed=0, device="cuda"):
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


def problem_jump_table(state, table, obs, delta=5):
    """The MTM / MH jump table of a :func:`problem` (``pipeline.Runner``'s
    recipe: the bin-level contacts, each bin normalised by its subs' accu
    mass), on the genome's device; ``delta`` partners a fragment (the
    refinement stages' default)."""
    from graal_tpu_torch.core.mtm import build_jump_table

    n = state.n_frags
    norm = np.bincount(table.owner.cpu().numpy(), weights=table.accu.cpu().numpy(),
                       minlength=n)
    return build_jump_table(bin_level_matrix(obs, table), norm, state.id_d.cpu().numpy(), n,
                            delta, device=state.pos.device)


def entry(device="cuda", **problem_kw):
    """(step, example_args): one EM step on the flagship problem (or the
    :func:`problem` that ``problem_kw`` asks for), with the dense scorer,
    and arguments for one call (state, generator, params, f_a, f_t)."""
    state, table, params, obs, nb = problem(device=device, **problem_kw)
    scorer = make_dense_scorer(table, obs, device)
    step = mcmc.make_em_step(table, obs, nb, delta=DELTA, scorer=scorer)
    gen = torch.Generator(device=device).manual_seed(0)
    f_a = torch.tensor(7, dtype=torch.int64, device=device)
    return step, (state, gen, params, f_a, 1.0)


def copy_expanded_table(table: SubFragTable, id_d, device=None) -> SubFragTable:
    """The sub-fragment table of a repeat-free ``table`` rebuilt for the
    copy-fragments ``id_d`` (each copy gets its bin's sub rows)."""
    owner = table.owner.cpu().numpy()
    n_bins = int(owner.max()) + 1
    counts = np.bincount(owner, minlength=n_bins)
    slot = np.arange(len(owner)) - (np.cumsum(counts) - counts)[owner]
    sub_ids = np.zeros((n_bins, 4), np.int64)
    sub_len = np.zeros((n_bins, 3))
    sub_acc = np.zeros((n_bins, 3))
    sub_ids[owner, slot] = table.data_id.cpu().numpy()
    sub_ids[:, 3] = counts
    sub_len[owner, slot] = table.len_kb.cpu().numpy()
    sub_acc[owner, slot] = table.accu.cpu().numpy()
    return build_sub_frag_table(sub_ids, sub_len, sub_acc, id_d, device=device)


def repeat_problem(n_bins=384, n_contigs=16, n_dups=12, seed=0, copies=1, device="cuda"):
    """(state, table, params, obs, nb) of a copy-expanded genome: the
    :func:`problem` genome with ``n_dups`` bins, evenly spread over
    [5, n_bins - 6], duplicated as fresh singleton contigs
    (``pipeline.extend_with_repeats``), its copy-expanded table, the
    observed map simulated on the copy-expanded state (numpy f32), and the
    neighbour table drawn from the data bins' contacts. ``copies``: the
    extra copies of each duplicated bin, one count for all or one per bin
    (2 gives a bin three copies)."""
    base, base_table = make_genome(n_bins, n_contigs, subs_per_bin=3, seed=seed)
    soa = base.to_numpy()
    soa["n_accu"] = np.ones(n_bins, np.int64)
    dup_bins = np.linspace(5, n_bins - 6, n_dups).astype(int)
    copies = np.broadcast_to(np.asarray(copies, np.int64), (n_dups,))
    soa = extend_with_repeats(soa, [(int(b), int(c)) for b, c in zip(dup_bins, copies)])
    state = GenomeState.from_soa(soa, device=device)
    table = copy_expanded_table(base_table, soa["id_d"], device=device)
    params = default_params(device=device)
    obs = simulate_contacts(state, table, params, seed=seed)
    # the bins' contacts come from the repeat-free base table: its owner
    # maps data subs to bins (on the copy-expanded table it would not)
    bins = bin_level_matrix(obs, base_table)
    nb = mcmc.build_neighbour_table(bins, soa["id_d"], state.n_frags, device=device)
    return state, table, params, obs, nb


def scale_problem(n_bins=100_000, n_contigs=None, n_pieces=None, seed=31,
                  shuffle_seed=32, device="cuda"):
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


def scale_repeat_problem(n_bins=20_000, n_dups=200, seed=31, shuffle_seed=32, copies=1,
                         device="cuda"):
    """(truth, shuffled, table, params, sobs, id_d): the chr1-scale recipe
    of :func:`scale_problem` with ``n_dups`` bins, evenly spread over
    [11, n_bins - 17], duplicated (``add_scale_repeats``); contacts are
    simulated on the repeat-free base genome, then the copy-expanded genome
    is shuffled into max(n_bins // 250, 8) pieces. ``copies``: the extra
    copies of each duplicated bin, one count for all or one per bin (the
    default 1 gives each two copies). ``id_d`` maps each copy-fragment to
    its data bin."""
    params = scale_params(device=device)
    base, base_table = make_scale_genome(n_bins, max(n_bins // 5000, 4), seed=seed,
                                         device=device)
    sobs = simulate_sparse_contacts(base, base_table, params, seed=seed)
    dup_bins = np.linspace(11, n_bins - 17, n_dups).astype(int)
    copies = np.broadcast_to(np.asarray(copies, np.int64), (n_dups,))
    truth, table, id_d = add_scale_repeats(base, base_table,
                                           tuple(int(b) for b in np.repeat(dup_bins, copies)))
    shuffled = shuffle_genome(truth, max(n_bins // 250, 8), seed=shuffle_seed)
    return truth, shuffled, table, params, sobs, id_d
