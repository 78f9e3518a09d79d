"""The MCMC / simulated-annealing sampler on the device.

PyTorch counterpart of ``graal_tpu.core.mcmc``. One EM step: for fragment
fA, sample <= delta neighbours from a contacts^3-weighted distribution,
build 13 candidate genomes per neighbour, score them all in one batched
call, filter / temper / sample a score slot, commit the winner. A cycle is
a scan of steps (:mod:`graal_tpu_torch.core.graphs`, the JAX package's
``lax.scan``: a captured CUDA graph on the card), each optionally followed
by one nuisance-parameter Metropolis step.

The loop never reads a device value on the host: indices, scores and
parameters stay tensors, and decisions are ``torch.where`` selects. The
only host syncs are where a caller reads the cycle's metrics.

On a card the step's scalar and control work runs on three hand-written
kernels (``ops.step_cuda``, ``csrc/step.cu``): the step's head
(:func:`step_head`: the neighbour draw, D2, with the nuisance proposal,
D1, beside it), the selection and commit (:func:`select_commit_dense`,
D3) and the step's tail (:func:`step_tail`: the l_t select, the nuisance
Metropolis test and the cycle metrics). The draw and the proposal alone
(:func:`sample_neighbours`, :func:`nuisance_propose`) are the head with
the other part off, the test alone (:func:`nuisance_accept`) the tail.
Each public function sends tensors on a card to its kernel and any others
to its plain version beside it (``*_plain``), which the kernels are held
to.

Randomness: every stochastic function takes either a ``torch.Generator``
or its random inputs as tensors (:class:`StepDraws`), so that tests can
feed it the draws the JAX package consumed. A cycle draws all its random
inputs in a few bulk calls.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from graal_tpu_torch.core import graphs
from graal_tpu_torch.core.candidates import N_CANDIDATES, build_candidates
from graal_tpu_torch.core.likelihood import log_likelihood
from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.core.subfrags import SubFragTable
from graal_tpu_torch.ops.likelihood_cuda import CopyRowScorer, params_vector
from graal_tpu_torch.ops.step_cuda import STEP

# Score window below the best candidate kept for sampling.
THRESH_OVERFLOW = 30.0


class NeighbourTable(NamedTuple):
    """Static proposal-distribution tables: per bin, the ``n_top`` strongest
    contact partners with probability proportional to contacts^3, plus the
    bin -> copy dispatcher for repeat expansion."""

    xk: torch.Tensor          # (n_bins, n_top) int32 candidate partner bins
    pk: torch.Tensor          # (n_bins, n_top) float32 probabilities
    dispatcher: torch.Tensor  # (n_bins, max_copies) int32 copy ids, -1 padded
    blacklist: torch.Tensor   # (n_frags,) bool
    n_bins: int
    max_copies: int


def _matrix_to_coo(matrix):
    """(rows, cols, vals, n) triplets of a dense array or scipy.sparse
    matrix, off-diagonal positive entries only."""
    import scipy.sparse as sp

    if sp.issparse(matrix):
        coo = matrix.tocoo()
        rows, cols, vals = coo.row, coo.col, coo.data.astype(np.float64)
        n = coo.shape[0]
    else:
        m = np.asarray(matrix, np.float64)
        n = m.shape[0]
        rows, cols = np.nonzero(m)
        vals = m[rows, cols]
    keep = (rows != cols) & (vals > 0)
    return rows[keep], cols[keep], vals[keep], n


def topk_rows(rows, cols, vals, n_rows, k):
    """Per-row top-``k`` entries of COO triplets (one lexsort). Returns
    (idx (n_rows, k) int32, val (n_rows, k) f64), zero-padded."""
    idx = np.zeros((n_rows, k), np.int32)
    val = np.zeros((n_rows, k), np.float64)
    if len(rows) == 0:
        return idx, val
    order = np.lexsort((-vals, rows))
    r, c, v = rows[order], cols[order], vals[order]
    new_seg = np.empty(len(r), bool)
    new_seg[0] = True
    new_seg[1:] = r[1:] != r[:-1]
    seg_id = np.cumsum(new_seg) - 1
    starts = np.nonzero(new_seg)[0]
    pos_in_seg = np.arange(len(r)) - starts[seg_id]
    sel = pos_in_seg < k
    idx[r[sel], pos_in_seg[sel]] = c[sel]
    val[r[sel], pos_in_seg[sel]] = v[sel]
    return idx, val


def build_dispatcher(id_d, n_bins):
    """(n_bins, max_copies) bin -> copy-fragment ids, -1 padded."""
    id_d = np.asarray(id_d)
    order = np.argsort(id_d, kind="stable")
    sorted_bins = id_d[order]
    counts = np.bincount(id_d, minlength=n_bins)
    max_copies = int(counts.max()) if len(counts) else 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos_in_bin = np.arange(len(order)) - starts[sorted_bins]
    dispatcher = np.full((n_bins, max_copies), -1, np.int32)
    dispatcher[sorted_bins, pos_in_bin] = order
    return dispatcher, max_copies


def build_neighbour_table(bin_matrix, id_d, n_frags, blacklisted=(),
                          n_top=10, fact=3.0, device=None) -> NeighbourTable:
    """Host-side construction of the proposal tables (dense or
    scipy.sparse ``bin_matrix``, O(nnz log nnz))."""
    rows, cols, vals, n_bins = _matrix_to_coo(bin_matrix)
    n_top = max(1, min(n_top, n_bins - 1))   # tiny coarse levels
    xk, topv = topk_rows(rows, cols, vals, n_bins, n_top)
    w = np.where(topv > 0, topv, 0.0) ** fact
    tot = w.sum(axis=1, keepdims=True)
    pk = np.divide(w, tot, out=np.zeros_like(w), where=tot > 0)
    # contact-free rows: uniform over the highest bin ids
    empty = tot[:, 0] <= 0
    if empty.any():
        xk[empty] = (n_bins - 1 - np.arange(n_top))[None, :]
        pk[empty] = 1.0 / n_top
    pk = pk.astype(np.float32)

    dispatcher, max_copies = build_dispatcher(id_d, n_bins)

    bl = np.zeros(n_frags, bool)
    bl[list(blacklisted)] = True
    return NeighbourTable(
        xk=torch.as_tensor(xk, device=device),
        pk=torch.as_tensor(pk, device=device),
        dispatcher=torch.as_tensor(dispatcher, device=device),
        blacklist=torch.as_tensor(bl, device=device),
        n_bins=n_bins, max_copies=max_copies)


# ---------------------------------------------------------------------------
# Random inputs
# ---------------------------------------------------------------------------

class StepDraws(NamedTuple):
    """The random inputs of one EM step (+ nuisance step); a leading axis
    holds the draws of a whole cycle."""

    u_nb: torch.Tensor      # (..., n_top) uniforms of the Gumbel top-k
    gumbel: torch.Tensor    # (..., n_slots) Gumbel noise of the slot draw
    id_modif: torch.Tensor  # (...,) int64 nuisance parameter in [0, 4)
    eps: torch.Tensor       # (...,) standard normal perturbation
    u_acc: torch.Tensor     # (...,) uniform of the Metropolis test


def n_slots(nb: NeighbourTable, delta: int) -> int:
    """Score slots per step: 13 candidates x (delta + 1) copy-expanded
    neighbour slots."""
    return N_CANDIDATES * (delta * nb.max_copies + nb.max_copies)


def draw_step_inputs(gen: torch.Generator, nb: NeighbourTable, delta: int,
                     shape=()) -> StepDraws:
    """Draw the random inputs of ``shape`` steps from ``gen`` (on the
    generator's device)."""
    dev = gen.device
    shape = tuple(shape)
    u_nb = torch.rand(shape + (nb.pk.shape[1],), generator=gen, device=dev)
    u_g = torch.rand(shape + (n_slots(nb, delta),), generator=gen, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u_g.clamp_min(tiny)))
    return StepDraws(u_nb, gumbel, *draw_nuisance_inputs(gen, shape))


class NuisanceDraws(NamedTuple):
    """The random inputs of a nuisance step alone (the :class:`StepDraws`
    fields it reads), with the caller's leading axes (e.g. chains)."""

    id_modif: torch.Tensor  # (...,) int64 nuisance parameter in [0, 4)
    eps: torch.Tensor       # (...,) standard normal perturbation
    u_acc: torch.Tensor     # (...,) uniform of the Metropolis test


def draw_nuisance_inputs(gen: torch.Generator, shape=()) -> NuisanceDraws:
    """Draw the inputs of ``shape`` nuisance steps from ``gen``: id_modif,
    eps and u, in that order (the order every caller draws them in, so a
    seeded run keeps its bits)."""
    dev = gen.device
    shape = tuple(shape)
    id_modif = torch.randint(0, 4, shape, generator=gen, device=dev)
    eps = torch.randn(shape, generator=gen, device=dev)
    return NuisanceDraws(id_modif, eps, torch.rand(shape, generator=gen, device=dev))


def _take(x, i):
    """x[i] for a 0-d index tensor, without a host read of ``i``."""
    return x.index_select(0, i.reshape(1).long())[0]


# ---------------------------------------------------------------------------
# EM step
# ---------------------------------------------------------------------------

def sample_neighbours(u, f_a, state: GenomeState, nb: NeighbourTable,
                      delta: int):
    """Sample <= delta partner bins without replacement (p prop
    contacts^3) by Gumbel top-k on the uniforms ``u`` (shape (n_top,), or a
    Generator to draw them), expand to repeat copies, add the other copies
    of fA's own bin, mask blacklisted / self entries. Returns (ids, valid)
    of static length delta * max_copies + max_copies, sorted by id with
    invalid entries last.

    With a leading chains axis (``u`` (C, n_top), ``f_a`` (C,), ``state``
    fields (C, n)) every chain is sampled at once, row c as chain c alone.

    :func:`sample_neighbours_plain`'s result, drawn by the head kernel
    (the draw alone) when the state is on a card."""
    if isinstance(u, torch.Generator):
        u = torch.rand(nb.pk.shape[1], generator=u, device=u.device)
    f_a = torch.as_tensor(f_a, device=state.pos.device).long()
    if state.pos.device.type == "cuda":
        return _neighbours_on_card(u, f_a, state, nb, delta)
    return sample_neighbours_plain(u, f_a, state, nb, delta)


def _neighbours_on_card(u, f_a, state: GenomeState, nb: NeighbourTable, delta: int):
    return STEP.neighbours(u, f_a, state.id_d, state.rep, nb, delta)


def step_head(u, f_a, state: GenomeState, nb: NeighbourTable, delta: int, nuisance=None):
    """The step's head: the neighbour draw of :func:`sample_neighbours`
    (``u`` a tensor) and, with ``nuisance`` = (id_modif, eps, params,
    d_max_cap, log_nfpb), the nuisance proposal of :func:`nuisance_propose`
    beside it (it reads only the parameters and its draws, not the state
    the step commits). Returns ((ids, valid), (test_params, in_support,
    row) or None).

    :func:`step_head_plain`'s result, by one launch of the head kernel
    when the state is on a card."""
    f_a = torch.as_tensor(f_a, device=state.pos.device).long()
    if state.pos.device.type == "cuda":
        return _head_on_card(u, f_a, state, nb, delta, nuisance)
    return step_head_plain(u, f_a, state, nb, delta, nuisance)


def _head_on_card(u, f_a, state: GenomeState, nb: NeighbourTable, delta: int, nuisance):
    propose = None
    if nuisance is not None:
        id_modif, eps, params, d_max_cap, log_nfpb = nuisance
        propose = (torch.as_tensor(id_modif).long(), eps, params, d_max_cap, log_nfpb)
    drawn, proposed = STEP.step_head((u, f_a, state.id_d, state.rep, nb, delta), propose)
    if proposed is not None:
        (c1, slope, d_max, fact, v_inter), in_support, row = proposed
        proposed = (nuisance[2]._replace(c1=c1, slope=slope, d_max=d_max, fact=fact,
                                         v_inter=v_inter), in_support, row)
    return drawn, proposed


def step_head_plain(u, f_a, state: GenomeState, nb: NeighbourTable, delta: int,
                    nuisance=None):
    """:func:`step_head` in plain torch: the plain draw, then the plain
    proposal."""
    drawn = sample_neighbours_plain(u, f_a, state, nb, delta)
    return drawn, None if nuisance is None else nuisance_propose_plain(*nuisance)


def sample_neighbours_plain(u, f_a, state: GenomeState, nb: NeighbourTable,
                            delta: int):
    """:func:`sample_neighbours` in plain torch, ``u`` a tensor."""
    f_a = torch.as_tensor(f_a, device=state.pos.device).long()
    id_d, rep = state.id_d, state.rep
    single = f_a.dim() == 0
    if single:
        u, f_a, id_d, rep = u[None], f_a[None], id_d[None], rep[None]
    col = f_a[:, None]
    bin_a = id_d.gather(1, col)[:, 0].long()
    pk_row = nb.pk[bin_a]
    xk_row = nb.xk[bin_a]
    g = torch.where(pk_row > 0, torch.log(pk_row), -math.inf)
    g = g - torch.log(-torch.log(u + 1e-20) + 1e-20)
    # top-k by a stable sort: ties (the -inf entries) keep the lower index
    top = torch.sort(-g, dim=-1, stable=True).indices[:, :delta]
    bins = xk_row.gather(1, top).long()
    bin_valid = pk_row.gather(1, top) > 0

    # repeat expansion: (C, delta, max_copies) copy ids
    exp = nb.dispatcher[bins]
    exp_valid = (exp >= 0) & bin_valid[..., None]
    # other copies of fA's own bin
    own = nb.dispatcher[bin_a]
    own_valid = (own >= 0) & (own != col) & (rep.gather(1, col) == 1)

    c = f_a.shape[0]
    ids = torch.cat([own, exp.reshape(c, -1)], 1)
    valid = torch.cat([own_valid, exp_valid.reshape(c, -1)], 1)
    valid = valid & ~nb.blacklist[ids.clamp_min(0).long()] & (ids != col)
    ids = ids.clamp_min(0)
    # deterministic order: ids ascending, invalid entries last
    order = torch.sort(torch.where(valid, ids, 2 ** 30), dim=-1, stable=True).indices
    ids, valid = ids.gather(1, order), valid.gather(1, order)
    return (ids[0], valid[0]) if single else (ids, valid)


def select_score_slot(gumbel, score, valid_nb, f_t, slot_valid=None,
                      thresh_overflow=THRESH_OVERFLOW):
    """Filter / temper / sample one (neighbour, op) slot: drop duplicate
    eject/flip slots beyond the first neighbour, shift by the minimum,
    clamp to a 30-window below the max, normalise, raise to 1/F_t, draw by
    argmax(log w + Gumbel); argmax of the scores when <= 1 candidate
    survives. ``score``: (m, n_ops); ``gumbel``: (m * n_ops,) noise, or a
    Generator to draw it. With a leading chains axis (``score`` (C, m,
    n_ops), ``valid_nb`` (C, m), ``gumbel`` (C, m * n_ops), ``f_t`` (C,))
    every chain selects at once, as it would alone."""
    keys, n_pos, best = slot_keys(gumbel, score, valid_nb, f_t, slot_valid, thresh_overflow)
    return torch.where(n_pos <= 1, best, torch.argmax(keys, -1))


def slot_keys(gumbel, score, valid_nb, f_t, slot_valid=None,
              thresh_overflow=THRESH_OVERFLOW):
    """What :func:`select_score_slot` draws from: (the keys log w + Gumbel
    of every slot, flattened; the count of slots inside the window; the
    best selectable slot). The drawn slot is the keys' argmax, or the best
    slot when the count is at most 1."""
    m, n_ops = score.shape[-2:]
    lead = score.shape[:-2]
    dev = score.device
    if isinstance(gumbel, torch.Generator):
        u = torch.rand(lead + (m * n_ops,), generator=gumbel, device=dev)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    op_idx = torch.arange(n_ops, device=dev)[None, :]
    nb_idx = torch.arange(m, device=dev)[:, None]
    dup = (op_idx < 2) & (nb_idx > 0)
    valid_op = valid_nb[..., None] | ((nb_idx == 0) & (op_idx < 2))
    if slot_valid is not None:
        valid_op = valid_op & slot_valid
    flat = score.reshape(lead + (-1,))
    valid_flat = (valid_op & ~dup).reshape(lead + (-1,))

    score_min = torch.where(valid_flat, flat, math.inf).amin(-1, keepdim=True)
    filtered = torch.where(valid_flat, flat - score_min, 0.0)
    max_score = filtered.amax(-1, keepdim=True)
    filtered = torch.clamp_min(filtered - (max_score - thresh_overflow), 0.0)
    filtered = torch.where(valid_flat, filtered, 0.0)

    n_pos = (filtered > 0).sum(-1)
    p = filtered / filtered.sum(-1, keepdim=True)
    # a tensor f_t (one per chain) broadcasts over the slots; a Python
    # float is not copied to the device (that would synchronise)
    f_t = f_t[..., None] if isinstance(f_t, torch.Tensor) else f_t
    # the p > 0 guard also maps the NaN of an all-zero sum to -inf
    logw = torch.where(p > 0, torch.log(p) / f_t, -math.inf)
    best = torch.argmax(torch.where(valid_flat, flat, -math.inf), -1)
    return logw + gumbel, n_pos, best


def _default_scorer(table: SubFragTable, obs, ll_dtype):
    """The scorer of a builder called without one: on a CUDA table the
    kernel scorer (B1, or B3 for a repeat table; f32 whatever
    ``ll_dtype``), on the CPU the dense tensor likelihood in ``ll_dtype``."""
    dev = table.owner.device
    if dev.type == "cuda":
        from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer

        return make_dense_scorer(table, obs, dev)
    obs = torch.as_tensor(obs, dtype=torch.float32, device=dev)

    def score(states: GenomeState, params: RippeParams):
        return log_likelihood(states, table, obs, params, dtype=ll_dtype)

    return score


def make_em_step(table: SubFragTable, obs, nb: NeighbourTable, delta: int,
                 ll_dtype=torch.float32, scorer=None,
                 thresh_overflow=THRESH_OVERFLOW):
    """Build the single-fragment EM step.

    Returns step(state, rng, params, f_a, f_t, neighbours=None) ->
    (new_state, (score_sel, op_sel, fb_sel)), where ``rng`` is a Generator
    or one step's :class:`StepDraws` (only its ``u_nb`` and ``gumbel`` are
    read); ``neighbours``: the step's (ids, valid), already drawn from
    ``rng.u_nb`` (:func:`step_head`), or None to draw them.

    With a leading chains axis (``state`` fields (C, n), ``f_a`` (C,),
    draws (C, ...), ``f_t`` (C,) or a float) every chain takes its step at
    once, as it would alone, and the candidates of all chains are scored in
    one scorer call (B = C x slots); the outputs gain the chains axis.

    ``scorer``: batched likelihood ``(GenomeState (B, n), params) -> (B,)``
    (e.g. :func:`graal_tpu_torch.ops.likelihood_cuda.make_dense_scorer`);
    defaults to :func:`_default_scorer`.
    """
    if scorer is None:
        scorer = _default_scorer(table, obs, ll_dtype)

    def step(state: GenomeState, rng, params: RippeParams, f_a, f_t, neighbours=None):
        f_a = torch.as_tensor(f_a, device=state.pos.device).long()
        single = f_a.dim() == 0
        if isinstance(rng, torch.Generator):
            rng = draw_step_inputs(rng, nb, delta, f_a.shape)
        ids, valid = (sample_neighbours(rng.u_nb, f_a, state, nb, delta) if neighbours is None
                      else neighbours)
        m = ids.shape[-1]
        c = 1 if single else ids.shape[0]
        n = state.n_frags

        if single:
            # one genome, broadcast over its neighbours
            cands = build_candidates(state, f_a, ids)
        else:
            # one genome per (chain, neighbour), each with its chain's max id
            per_nb = GenomeState(*[x.repeat_interleave(m, 0) for x in state])
            cands = build_candidates(per_nb, f_a.repeat_interleave(m), ids.reshape(-1),
                                     max_id=state.id_c.amax(-1).repeat_interleave(m))
        flat = GenomeState(*[x.reshape(c * m * N_CANDIDATES, n) for x in cands])
        ll = scorer(flat, params).reshape(ids.shape + (N_CANDIDATES,))
        new_state, out, _ = select_commit_dense(state, flat, ll, ids, valid, f_a, rng.gumbel,
                                                f_t, nb.blacklist, thresh_overflow)
        return new_state, out

    return step


def select_commit_dense(state: GenomeState, cands: GenomeState, ll, ids, valid, f_a, gumbel,
                        f_t, blacklist, thresh_overflow=THRESH_OVERFLOW):
    """The dense step's selection and commit: draw a (neighbour, op) slot
    of the scores ``ll`` (:func:`select_score_slot`), take that candidate
    of ``cands`` as the new state, or keep ``state`` when ``f_a`` is
    blacklisted. One genome (``state`` fields (n,), ``cands`` (m x 13, n),
    ``ll`` (m, 13), ``ids`` / ``valid`` (m,), ``f_a`` () int64, ``gumbel``
    (m x 13,)) or a chains axis (C leading every one of them, ``cands``
    (C x m x 13, n), ``f_t`` a number or one a chain). Returns (new_state,
    (score, op, fb), sel): score -inf, op -1 and fb f_a on a blacklisted
    fragment.

    :func:`select_commit_dense_plain`'s result, by kernel D3 when the
    state is on a card; the drawn slot may differ where the two best
    tempered keys lie within a few ulps (``csrc/step.cu``)."""
    if state.pos.device.type != "cuda":
        return select_commit_dense_plain(state, cands, ll, ids, valid, f_a, gumbel, f_t,
                                         blacklist, thresh_overflow)
    return _dense_on_card(state, cands, ll, ids, valid, f_a, gumbel, f_t, blacklist,
                          thresh_overflow)


def _dense_on_card(state: GenomeState, cands: GenomeState, ll, ids, valid, f_a, gumbel, f_t,
                   blacklist, thresh_overflow):
    """:func:`select_commit_dense` through the kernel's wrapper, which takes
    a chains axis (one genome is a chains axis of one)."""
    single = f_a.dim() == 0
    c, m = (1 if single else f_a.shape[0]), ids.shape[-1]

    def lift(x):
        return x[None] if single else x

    fields, score, op, fb, sel = STEP.select_dense(
        GenomeState(*[lift(x) for x in state]),
        GenomeState(*[x.reshape(c, m * N_CANDIDATES, x.shape[-1]) for x in cands]),
        lift(ll), lift(ids), lift(valid), f_a.reshape(c), lift(gumbel), f_t, blacklist,
        thresh_overflow)
    if single:
        return GenomeState(*[x[0] for x in fields]), (score[0], op[0], fb[0]), sel[0]
    return GenomeState(*fields), (score, op, fb), sel


def select_commit_dense_plain(state: GenomeState, cands: GenomeState, ll, ids, valid, f_a,
                              gumbel, f_t, blacklist, thresh_overflow=THRESH_OVERFLOW):
    """:func:`select_commit_dense` in plain torch."""
    single = f_a.dim() == 0
    c, m = (1 if single else f_a.shape[0]), ids.shape[-1]
    sel = select_score_slot(gumbel, ll.float(), valid, f_t, thresh_overflow=thresh_overflow)
    sel_nb = sel // N_CANDIDATES
    sel_op = sel % N_CANDIDATES
    pick = sel.reshape(c)
    if c > 1:
        pick = pick + torch.arange(0, c * m * N_CANDIDATES, m * N_CANDIDATES,
                                   device=pick.device)
    new_state = [x.index_select(0, pick).reshape(state.pos.shape) for x in cands]

    # blacklisted fragments are skipped entirely
    skip = blacklist.index_select(0, f_a.reshape(c)).reshape(f_a.shape)
    new_state = GenomeState(*[torch.where(skip[..., None], a, b)
                              for a, b in zip(state, new_state)])
    score = ll.reshape(c, -1).gather(1, sel.reshape(c, 1)).reshape(sel.shape)
    fb = ids.reshape(c, m).gather(1, sel_nb.reshape(c, 1)).reshape(sel.shape)
    return new_state, (torch.where(skip, -math.inf, score), torch.where(skip, -1, sel_op),
                       torch.where(skip, f_a, fb)), sel


# ---------------------------------------------------------------------------
# Nuisance-parameter step
# ---------------------------------------------------------------------------

def _device_peval(s, params: RippeParams):
    """Rippe curve without the v_inter clamp / range gate — the raw model
    value used for nuisance re-derivations."""
    n = s * params.lm / params.kuhn
    return (params.fact * 0.53 * torch.pow(params.kuhn, -3.0)
            * torch.pow(n, params.slope)
            * torch.exp((params.d - 2.0) / (n * n + params.d)))


def solve_d_max(params: RippeParams, v_inter, lo=1e-2, hi=1e6, passes=5,
                width=64):
    """Log-space multisection solve of rippe(s) == v_inter on the
    decreasing branch: each pass evaluates the curve at ``width``
    geometrically spaced points and shrinks the bracket (width-1)x.

    ``params`` and ``v_inter`` may carry a leading batch shape; the solve
    is elementwise over it."""
    dev = v_inter.device
    llo = torch.full(v_inter.shape, float(np.float32(np.log(lo))), device=dev)
    lhi = torch.full(v_inter.shape, float(np.float32(np.log(hi))), device=dev)
    frac = torch.arange(width, dtype=torch.float32, device=dev) / np.float32(width - 1)
    p_col = RippeParams(*[x[..., None] for x in params])
    for _ in range(passes):
        xs = torch.exp(llo[..., None] + (lhi - llo)[..., None] * frac)
        above = _device_peval(xs, p_col) > v_inter[..., None]
        idx = (above.int().sum(-1) - 1).clamp(0, width - 2)
        step = (lhi - llo) / np.float32(width - 1)
        llo = llo + idx.float() * step
        lhi = llo + step
    return torch.exp((llo + lhi) * 0.5)


def _pick4(x4, id_modif):
    """Row ``id_modif`` of the four proposals ``x4`` (4, ...): one index,
    or one per chain ((C,) against (4, C)), without a host read."""
    return x4.gather(0, id_modif.long().reshape((1,) + x4.shape[1:]))[0]


def nuisance_propose(id_modif, eps, params: RippeParams, d_max_cap: float | None = None,
                     log_nfpb=None):
    """One of {fact, slope, d_max, v_inter} (``id_modif`` 0..3) perturbed
    by ``eps`` times the reference's per-parameter sigma, dependent
    parameters re-derived; the proposal is in support when the perturbed
    parameter stays in its declared range (and its d_max within
    ``d_max_cap``). With a chains axis (``id_modif`` and ``eps`` (C,),
    params fields (C,)) each chain proposes from its own parameters, as it
    would alone (the JAX package's ``jax.vmap`` of the proposer).

    Returns (test_params, in_support, row): ``row`` is the dense scorers'
    parameter row of ``test_params`` (``ops.likelihood_cuda.params_vector``
    with ``log_nfpb``), or None without ``log_nfpb``.
    :func:`nuisance_propose_plain`'s result, by the head kernel (the
    proposal alone) when the parameters are on a card."""
    if params.fact.device.type == "cuda":
        return _propose_on_card(id_modif, eps, params, d_max_cap, log_nfpb)
    return nuisance_propose_plain(id_modif, eps, params, d_max_cap, log_nfpb)


def _propose_on_card(id_modif, eps, params: RippeParams, d_max_cap, log_nfpb):
    (c1, slope, d_max, fact, v_inter), in_support, row = STEP.nuisance_propose(
        torch.as_tensor(id_modif).long(), eps, params, d_max_cap, log_nfpb)
    return params._replace(c1=c1, slope=slope, d_max=d_max, fact=fact,
                           v_inter=v_inter), in_support, row


def nuisance_propose_plain(id_modif, eps, params: RippeParams,
                           d_max_cap: float | None = None, log_nfpb=None):
    """:func:`nuisance_propose` in plain torch: all four proposals are built
    as one batch of four parameter sets and ``id_modif`` selects one on the
    device."""
    sigma_slope = 0.05
    sigma_d_max = 100.0
    sigma_d_nuc = 0.5
    slope_range = (-2.0, -0.5)
    d_max_range = (0.0, 10000.0)
    d_nuc_range = (0.0, 100.0)

    p = params
    new_fact = p.fact + eps * torch.pow(10.0, torch.log10(p.fact) - 2.0)
    new_slope = p.slope + eps * sigma_slope
    c1_slope = (0.53 * torch.pow(p.lm / p.kuhn, new_slope)
                * torch.pow(p.kuhn, -3.0))
    new_d_max = p.d_max + eps * sigma_d_max
    v_d_max = _device_peval(new_d_max, p)
    new_v = p.v_inter + eps * sigma_d_nuc

    # rows: 0 fact, 1 slope, 2 d_max, 3 v_inter
    fact4 = torch.stack([new_fact, p.fact, p.fact, p.fact])
    slope4 = torch.stack([p.slope, new_slope, p.slope, p.slope])
    c1_4 = torch.stack([p.c1, c1_slope, p.c1, p.c1])
    v4 = torch.stack([p.v_inter, p.v_inter, v_d_max, new_v])
    four = p._replace(c1=c1_4, slope=slope4, fact=fact4, v_inter=v4)
    solved = solve_d_max(four, v4)
    d_max4 = torch.stack([solved[0], solved[1], new_d_max, solved[3]])
    valid4 = torch.stack([
        new_fact > 0.0,
        (new_slope >= slope_range[0]) & (new_slope <= slope_range[1]),
        (new_d_max > d_max_range[0]) & (new_d_max <= d_max_range[1]),
        (new_v > d_nuc_range[0]) & (new_v <= d_nuc_range[1])])

    test_params = p._replace(c1=_pick4(c1_4, id_modif),
                             slope=_pick4(slope4, id_modif),
                             d_max=_pick4(d_max4, id_modif),
                             fact=_pick4(fact4, id_modif),
                             v_inter=_pick4(v4, id_modif))
    in_support = _pick4(valid4, id_modif)
    if d_max_cap is not None:
        in_support = in_support & (test_params.d_max <= d_max_cap)
    row = None if log_nfpb is None else params_vector(test_params, log_nfpb)
    return test_params, in_support, row


def nuisance_accept(u, test_params: RippeParams, params: RippeParams,
                    l_star, l_t, f_t, in_support):
    """Metropolis accept/reject half of the nuisance step; elementwise, so
    a chains axis on every argument accepts each chain on its own.
    Returns (params, l_t, accepted): :func:`nuisance_accept_plain`'s
    result, by the tail kernel (the test alone) when the parameters are on
    a card."""
    if params.fact.device.type == "cuda":
        return _accept_on_card(u, test_params, params, l_star, l_t, f_t, in_support)
    return nuisance_accept_plain(u, test_params, params, l_star, l_t, f_t, in_support)


def _accept_on_card(u, test_params: RippeParams, params: RippeParams, l_star, l_t, f_t,
                    in_support):
    fields, l_out, accept = STEP.nuisance_accept(u, test_params, params, l_star.float(), l_t,
                                                 f_t, in_support)
    return RippeParams(*fields), l_out, accept


def nuisance_accept_plain(u, test_params: RippeParams, params: RippeParams,
                          l_star, l_t, f_t, in_support):
    """:func:`nuisance_accept` in plain torch."""
    ratio = torch.exp((l_star.float() - l_t) / f_t)
    accept = in_support & (ratio >= u)
    out = RippeParams(*[torch.where(accept, a, b)
                        for a, b in zip(test_params, params)])
    l_out = torch.where(accept, l_star.float(), l_t)
    return out, l_out, accept


class StepTail(NamedTuple):
    """What :func:`step_tail` returns (None where its part was off)."""

    params: RippeParams | None   # after the Metropolis test
    l_t: torch.Tensor
    accepted: torch.Tensor       # the cycle's ``success``: true without a test
    n_contigs: torch.Tensor | None
    mean_len: torch.Tensor | None


def step_tail(l_t, score=None, accept=None, state: GenomeState | None = None) -> StepTail:
    """The step's tail, in the cycle body's order: l_t <- ``score`` (the
    selection's) where it is finite; with ``accept`` = (u, test_params,
    params, l_star, f_t, in_support) the Metropolis test of
    :func:`nuisance_accept` on that l_t; with ``state`` its metrics, the
    contig count and the mean contig length over the active fragments.
    A leading chains axis on every argument handles each chain on its own.

    :func:`step_tail_plain`'s result, by one launch of the tail kernel when
    ``l_t`` is on a card."""
    if l_t.device.type == "cuda":
        return _tail_on_card(l_t, score, accept, state)
    return step_tail_plain(l_t, score, accept, state)


def _tail_on_card(l_t, score, accept, state):
    if accept is not None:
        u, test_params, params, l_star, f_t, in_support = accept
        accept = (u, test_params, params, l_star.float(), f_t, in_support)
    metrics = None if state is None else (state.pos, state.activ, state.len_bp)
    fields, l_out, accepted, n_contigs, mean_len = STEP.step_tail(l_t, score, accept, metrics)
    return StepTail(None if fields is None else RippeParams(*fields), l_out, accepted, n_contigs,
                    mean_len)


def step_tail_plain(l_t, score=None, accept=None, state: GenomeState | None = None) -> StepTail:
    """:func:`step_tail` in plain torch."""
    if score is not None:
        l_t = torch.where(torch.isfinite(score), score, l_t)
    params = None
    if accept is not None:
        u, test_params, params, l_star, f_t, in_support = accept
        params, l_t, success = nuisance_accept_plain(u, test_params, params, l_star, l_t, f_t,
                                                     in_support)
    else:
        success = torch.ones(l_t.shape, dtype=torch.bool, device=l_t.device)
    n_contigs = mean_len = None
    if state is not None:
        n_contigs = state.n_contigs()
        # mean contig length over *active* fragments only
        active_bp = torch.where(state.activ == 1, state.len_bp, 0).sum(-1)
        mean_len = active_bp.float() / n_contigs
    return StepTail(params, l_t, success, n_contigs, mean_len)


def _score_test(scorer, state: GenomeState, test_params: RippeParams, row):
    """l* of the nuisance test: ``test_params``' likelihood of ``state``
    by the (batched) ``scorer`` at batch size 1, handed the test set's
    parameter row where the proposal made one."""
    one = GenomeState(*[x[None] for x in state])
    return (scorer(one, test_params) if row is None
            else scorer(one, test_params, pvec=row))[0]


def make_nuisance_step(table: SubFragTable, obs, ll_dtype=torch.float32,
                       scorer=None, d_max_cap: float | None = None):
    """Nuisance-parameter Metropolis step: perturb one of {fact, slope,
    d_max, v_inter}, re-derive dependents, accept with probability
    exp((L* - L_t) / F_t). The test-parameter likelihood goes through
    ``scorer`` (the EM step's batched scorer) at batch size 1.

    Returns step(state, rng, params, l_t, f_t) -> (params, l_t, accepted),
    where ``rng`` is a Generator, a :class:`StepDraws` or a
    :class:`NuisanceDraws` (its id_modif, eps and u_acc are used).
    """
    if scorer is None:
        scorer = _default_scorer(table, obs, ll_dtype)
    # the dense scorers take the test set's parameter row from the proposal
    log_nfpb = scorer.log_nfpb if isinstance(scorer, CopyRowScorer) else None

    def step(state: GenomeState, rng, params: RippeParams, l_t, f_t):
        if isinstance(rng, torch.Generator):
            rng = draw_nuisance_inputs(rng)
        id_modif, eps, u = rng.id_modif, rng.eps, rng.u_acc
        test_params, in_support, row = nuisance_propose(id_modif, eps, params, d_max_cap,
                                                        log_nfpb)
        l_star = _score_test(scorer, state, test_params, row)
        return nuisance_accept(u, test_params, params, l_star, l_t, f_t,
                               in_support)

    return step


# ---------------------------------------------------------------------------
# EM cycle
# ---------------------------------------------------------------------------

class CycleMetrics(NamedTuple):
    likelihood: torch.Tensor
    n_contigs: torch.Tensor
    mean_len: torch.Tensor      # mean contig length in bp
    op_sampled: torch.Tensor
    id_f_sampled: torch.Tensor
    id_f_a: torch.Tensor
    fact: torch.Tensor
    slope: torch.Tensor
    d_max: torch.Tensor
    v_inter: torch.Tensor
    success: torch.Tensor


def make_em_cycle(table: SubFragTable, obs, nb: NeighbourTable, delta: int,
                  sample_param: bool = True, ll_dtype=torch.float32,
                  scorer=None, thresh_overflow=THRESH_OVERFLOW, capture=None):
    """One EM cycle over the fragments of ``frag_order``.

    Returns cycle(state, rng, params, frag_order, l_t, f_t) ->
    (state, params, l_t, CycleMetrics), where ``rng`` is a Generator or a
    :class:`StepDraws` with a leading axis of len(frag_order). Metric
    fields are per-step tensors stacked over the cycle.

    The cycle is a :class:`graal_tpu_torch.core.graphs.Scan` of the step
    (the step's head: the neighbour draw and, with ``sample_param``, the
    nuisance proposal; the EM step's catalogue, scoring and selection; the
    test set's score; the step's tail: l_t, the Metropolis test and the
    metrics): on a CUDA table a captured graph replayed once a step,
    elsewhere the same body run step by step. ``capture``: as the scan
    takes it (False runs eagerly on the card).
    """
    if scorer is None:
        scorer = _default_scorer(table, obs, ll_dtype)
    em_step = make_em_step(table, obs, nb, delta, ll_dtype, scorer=scorer,
                           thresh_overflow=thresh_overflow)
    # the dense scorers take the test set's parameter row from the proposal
    log_nfpb = scorer.log_nfpb if isinstance(scorer, CopyRowScorer) else None

    # the parameters are carried when the nuisance step moves them, else
    # constants of the call (and the cycle returns the caller's own)
    def body(carry, consts, x):
        if sample_param:
            (state, params, l_t), f_t = carry, consts
        else:
            (state, l_t), (params, f_t) = carry, consts
        draws, f_a = x
        nuisance = (draws.id_modif, draws.eps, params, None, log_nfpb) if sample_param else None
        drawn, proposal = step_head(draws.u_nb, f_a, state, nb, delta, nuisance)
        state, (score, op, fb) = em_step(state, draws, params, f_a, f_t, neighbours=drawn)
        accept = None
        if sample_param:
            test_params, in_support, row = proposal
            accept = (draws.u_acc, test_params, params,
                      _score_test(scorer, state, test_params, row), f_t, in_support)
        tail = step_tail(l_t, score, accept, state)
        if sample_param:
            params = tail.params
        l_t = tail.l_t
        return (state, params, l_t) if sample_param else (state, l_t), CycleMetrics(
            likelihood=l_t, n_contigs=tail.n_contigs, mean_len=tail.mean_len,
            op_sampled=op, id_f_sampled=fb, id_f_a=f_a,
            fact=params.fact, slope=params.slope, d_max=params.d_max,
            v_inter=params.v_inter, success=tail.accepted)

    scan = graphs.Scan(body, table.owner.device, capture=capture)

    def cycle(state: GenomeState, rng, params: RippeParams, frag_order, l_t,
              f_t):
        frag_order = torch.as_tensor(frag_order, device=state.pos.device).long()
        if isinstance(rng, torch.Generator):
            rng = draw_step_inputs(rng, nb, delta, (frag_order.shape[0],))
        xs = (rng, frag_order)
        if sample_param:
            (state, params, l_t), metrics = scan((state, params, l_t), f_t, xs)
        else:
            (state, l_t), metrics = scan((state, l_t), (params, f_t), xs)
        return state, params, l_t, metrics

    cycle.scan = scan
    return cycle


def explode_genome(state: GenomeState) -> GenomeState:
    """Scramble to the worst-case start: every fragment a singleton contig."""
    n = state.n_frags
    dev = state.pos.device
    shape = state.pos.shape
    zeros = torch.zeros(shape, dtype=torch.int32, device=dev)
    return state._replace(
        pos=zeros,
        id_c=torch.arange(n, dtype=torch.int32, device=dev).expand(shape).clone(),
        start_bp=zeros.clone(),
        circ=zeros.clone(),
        l_cont=torch.ones(shape, dtype=torch.int32, device=dev),
        l_cont_bp=state.len_bp.clone(),
        ori=torch.ones(shape, dtype=torch.int32, device=dev),
    )


def apply_mutation(state: GenomeState, f_a, f_b, mode) -> GenomeState:
    """Apply one recorded mutation — the replay primitive."""
    dev = state.pos.device
    f_b = torch.as_tensor(f_b, dtype=torch.int32, device=dev).reshape(1)
    mode = torch.as_tensor(mode, device=dev)
    cands = build_candidates(state, f_a, f_b)
    return GenomeState(*[_take(x[0], mode) for x in cands])
