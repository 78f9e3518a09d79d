"""Multiple-try Metropolis and plain Metropolis-Hastings samplers.

PyTorch counterpart of ``graal_tpu.core.mtm``, the refinement samplers
that usually run after EM:

- jumping distributions (:func:`build_jump_table`, host numpy): per
  fragment, the delta strongest partners of the accu-normalised contact
  matrix;
- an MTM step (:func:`make_mtm_step`): the forward pass scores the 13
  MH-catalogue candidates (:func:`core.candidates.mh_candidates`) against
  every fragment of fA's neighbour set (its delta partners plus its
  current prev / next), draws a proposal from the tempered softmax and
  applies it; the backward pass scores the same catalogue from the
  proposal pivoted at the chosen partner f*; the ratio exp(max_f - max_b)
  sum(w_f) / sum(w_b) decides acceptance;
- a plain MH step (:func:`make_mh_step`) with the proposal probabilities
  in its ratio;
- the impossible-operation mask: a paste needs both fragments at
  linear-contig extremities, a translocation fB at the matching one.

Each pass scores its (delta + 2) x 13 candidates in one scorer call (B1,
or B3 for a repeat table, on the card). The delta twins
(:func:`make_delta_mtm_step`, :func:`make_delta_mh_step`) score them
through the delta engine with the MH catalogue, each neighbour on its own
member rows (kernels B4 and B2), and reconstruct candidate likelihoods as
the carried l_t plus the delta: both passes compare likelihoods only
through differences and softmax weights, so this is the absolute form.

Three quirks of the JAX package are kept by default (``corrected=False``),
for parity: the MTM backward pass pivots at f* but reuses fA's neighbour
set; the MH ratio adds the proposal probabilities to the log-likelihoods
inside the exponent; the MH backward pass pivots at fA (in both modes, as
the JAX package's ``corrected=True`` changes the MH ratio only).
``corrected=True`` gives the canonical MTM backward set and MH ratio.

A step's control work is three public functions, each one kernel of
``csrc/mtm.cu`` on a card (``ops.mtm_cuda``) and its plain version
(``*_plain``) anywhere else: :func:`move_set` (E1: the neighbour set, its
discard mask, the genome's largest contig id and contig count; twice a
step, the backward pass in its mask-only mode or, corrected MTM, pivoted at
f*), :func:`forward_dense` / :func:`forward_delta` (E2: the forward
weights, the slot draw and the proposal g*) and :func:`accept_dense` /
:func:`accept_delta` (E3: the backward weights, the ratio, the acceptance
and the commit). On a card the delta step writes g* into the state in
place (a captured cycle's carry, or a copy of the mutable fields when run
eagerly) and a rejection writes the saved rows back: no genome-length copy
is left on the delta step.

Randomness: a step takes a ``torch.Generator`` or its draws as tensors
(:class:`MoveDraws`: the Gumbel noise of the categorical over the slots
and the acceptance uniform), so that tests can feed it the draws a JAX
step consumed. Nothing in a step reads a device value on the host, so a
cycle is a scan of steps (:mod:`graal_tpu_torch.core.graphs`, the JAX
package's jitted ``lax.scan``): a captured CUDA graph on the card.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from graal_tpu_torch.core import graphs
from graal_tpu_torch.core.candidates import N_CANDIDATES, mh_candidates
from graal_tpu_torch.core.mcmc import _default_scorer, _matrix_to_coo, _take, topk_rows
from graal_tpu_torch.core.state import MUTABLE_FIELDS, GenomeState
from graal_tpu_torch.core.subfrags import SubFragTable
from graal_tpu_torch.ops.mtm_cuda import MH_THRESH_OVERFLOW, MOVE, MTM_THRESH_OVERFLOW


class JumpTable(NamedTuple):
    """Top-delta jumping-distribution table (static)."""

    frags: torch.Tensor   # (n_frags, delta) int32 partner ids
    delta: int


def build_jump_table(bin_matrix, norm_vect_accu, id_d, n_frags, delta,
                     device=None) -> JumpTable:
    """Accu-normalised contact matrix (dense or scipy.sparse) -> per-fragment
    top-delta partners (set_jumping_distributions_parameters,
    cuda_lib_gl.py:2563-2581), O(nnz log nnz) on the host."""
    rows, cols, vals, n_bins = _matrix_to_coo(bin_matrix)
    norm = np.asarray(norm_vect_accu, np.float64)
    vals = vals / np.maximum(norm[rows] * norm[cols], 1e-12)
    top_bins, topv = topk_rows(rows, cols, vals, n_bins, delta)
    # rows with fewer than delta positive partners: pad with distinct bins
    pad = (n_bins - 1 - np.arange(delta))[None, :].astype(np.int32)
    top_bins = np.where(topv > 0, top_bins, pad % n_bins)

    id_d = np.asarray(id_d)
    # first copy fragment of each bin (reversed scatter: the lowest index wins)
    first_copy = np.zeros(n_bins, np.int64)
    n = len(id_d)
    first_copy[id_d[::-1]] = np.arange(n - 1, -1, -1)
    frags = first_copy[top_bins[id_d]].astype(np.int32)
    return JumpTable(frags=torch.as_tensor(frags, device=device), delta=delta)


class MoveDraws(NamedTuple):
    """The random inputs of one MTM / MH step; a leading axis holds the
    draws of a whole cycle."""

    gumbel: torch.Tensor   # (..., (delta + 2) * 13) Gumbel noise of the slot draw
    u_acc: torch.Tensor    # (...,) uniform of the acceptance test


def n_move_slots(jump: JumpTable) -> int:
    return (jump.delta + 2) * N_CANDIDATES


def draw_move_inputs(gen: torch.Generator, jump: JumpTable, shape=()) -> MoveDraws:
    """Draw the random inputs of ``shape`` steps from ``gen``."""
    dev = gen.device
    shape = tuple(shape)
    u = torch.rand(shape + (n_move_slots(jump),), generator=gen, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return MoveDraws(gumbel, torch.rand(shape, generator=gen, device=dev))


def _prev_next(state: GenomeState, f):
    """(prev, next) of fragment ``f`` (a 0-d tensor), -1 at linear
    extremities, as 0-d int64 tensors (derived from (id_c, pos))."""
    c = _take(state.id_c, f)
    p = _take(state.pos, f)
    in_c = state.id_c == c
    is_prev = in_c & (state.pos == p - 1)
    is_next = in_c & (state.pos == p + 1)
    # circular wrap
    l_val = _take(state.l_cont, f)
    circ = _take(state.circ, f) == 1
    wrap_prev = in_c & (state.pos == l_val - 1) & (p == 0) & circ
    wrap_next = in_c & (state.pos == 0) & (p == l_val - 1) & circ
    prev_mask = is_prev | wrap_prev
    next_mask = is_next | wrap_next
    prev = torch.where(prev_mask.any(), prev_mask.int().argmax(), -1)
    nxt = torch.where(next_mask.any(), next_mask.int().argmax(), -1)
    return prev, nxt


def _impossibility_mask(state: GenomeState, f_a, nb_ids):
    """(m, 13) True where the op slot must be discarded
    (detect_impossibility, cuda_lib_gl.py:3072-3100)."""
    ids = nb_ids.long()
    lin_b = state.circ[ids] == 0
    pos_b, lc_b = state.pos[ids], state.l_cont[ids]
    fa_ok = (_take(state.circ, f_a) == 0) & (
        (_take(state.pos, f_a) == 0) | (_take(state.pos, f_a) == _take(state.l_cont, f_a) - 1))
    fb_ok = lin_b & ((pos_b == 0) | (pos_b == lc_b - 1))
    fb_down = lin_b & (pos_b == lc_b - 1)   # next == -1
    fb_up = lin_b & (pos_b == 0)            # prev == -1
    mask = torch.zeros((ids.shape[0], N_CANDIDATES), dtype=torch.bool, device=ids.device)
    mask[:, 8] = ~(fa_ok & fb_ok)
    mask[:, 9] = ~fb_down
    mask[:, 11] = ~fb_down
    mask[:, 10] = ~fb_up
    mask[:, 12] = ~fb_up
    return mask


def _neighbour_set(state: GenomeState, f_a, jump: JumpTable):
    """V = the delta partners of fA plus its current prev / next
    (cuda_lib_gl.py:2850-2860): fixed length delta + 2, with a validity
    mask that drops duplicates (the first occurrence stays), fA itself and
    missing prev / next."""
    base = _take(jump.frags, f_a).long()
    prev, nxt = _prev_next(state, f_a)
    ids = torch.cat([base, torch.stack([prev, nxt])])
    dev = ids.device
    valid = torch.cat([torch.ones(jump.delta, dtype=torch.bool, device=dev),
                       torch.stack([prev != -1, nxt != -1])])
    ix = torch.arange(ids.shape[0], device=dev)
    dup = (ids[:, None] == ids[None, :]) & (ix[None, :] < ix[:, None])
    valid = valid & ~(dup & valid[None, :]).any(1) & (ids != f_a)
    return ids.clamp_min(0), valid


def _categorical(p, gumbel):
    """The slot drawn from probabilities ``p`` by argmax(log p + Gumbel);
    zero-probability slots get log 1e-30, as in the JAX package."""
    return torch.argmax(torch.log(torch.where(p > 0, p, 1e-30)) + gumbel)


def _mtm_weights(ll_flat, discard_flat, f_t, thresh=MTM_THRESH_OVERFLOW):
    """MTM weights exp(s - max) of the tempered scores s = ll / F_t within
    ``thresh`` of the best kept slot; discarded slots weigh 0."""
    s = ll_flat / f_t
    mx = torch.where(discard_flat, -math.inf, s).amax()
    s = torch.where(s <= mx - thresh, -math.inf, s)
    w = torch.where(discard_flat, 0.0, torch.exp(s - mx))
    return w, mx


def _mh_probs(ll_flat, discard_flat, f_t):
    """MH forward proposal probabilities: tempered scores clamped to a
    window of MH_THRESH_OVERFLOW below the best kept slot, shifted by
    their minimum, exponentiated; returns (the unnormalised probabilities,
    their sum, the best kept tempered score)."""
    s = ll_flat / f_t
    mx = torch.where(discard_flat, -math.inf, s).amax()
    s = torch.maximum(s, mx - MH_THRESH_OVERFLOW)
    s = s - s.amin()
    w = torch.where(discard_flat, 0.0, torch.exp(s))
    sw = w.sum()
    return w, sw, mx


def _mh_return_prob(ll_b_flat, discard_b_flat, l_t, f_t, clamp_sum: bool):
    """MH backward probability of returning to the current genome, whose
    tempered score l_t / F_t is clamped like the backward slots'; returns
    (p_bwd, the backward weights' sum)."""
    sb = ll_b_flat / f_t
    mxb = torch.where(discard_b_flat, -math.inf, sb).amax()
    target = torch.maximum(l_t / f_t, mxb - MH_THRESH_OVERFLOW)
    sb = torch.maximum(sb, mxb - MH_THRESH_OVERFLOW)
    target = target - sb.amin()
    sb = sb - sb.amin()
    wb = torch.where(discard_b_flat, 0.0, torch.exp(sb))
    swb = wb.sum()
    den = swb.clamp_min(1e-30) if clamp_sum else swb
    return torch.exp(target) / den, swb


def _mh_ratio(ll_star, l_t, p_fwd, p_bwd, f_t, corrected: bool):
    if corrected:
        return torch.exp((ll_star - l_t) / f_t) * p_bwd / p_fwd.clamp_min(1e-30)
    # the JAX package's form: probabilities added to log-likelihoods
    return torch.exp((ll_star + p_bwd - l_t - p_fwd) / f_t)


def _commit(accept, g_star: GenomeState, state: GenomeState, ll_star, l_t):
    new_state = GenomeState(*[torch.where(accept, a, b) for a, b in zip(g_star, state)])
    return new_state, torch.where(accept, ll_star, l_t), accept, new_state.n_contigs()


# ---------------------------------------------------------------------------
# A step's control work, one public function a kernel of csrc/mtm.cu: E1 the
# neighbour set and its masks (move_set), E2 the forward weights, the draw
# and the proposal (forward_dense / forward_delta), E3 the backward weights,
# the acceptance and the commit (accept_dense / accept_delta). On a card each
# runs its kernel (ops.mtm_cuda.MOVE), on any other device its plain version.
# ---------------------------------------------------------------------------

class Forward(NamedTuple):
    """What a step's forward pass (E2) hands its acceptance (E3)."""

    g_star: GenomeState        # the proposal (delta: the state it was written into)
    omega: torch.Tensor        # () int64: the drawn slot
    f_star: torch.Tensor       # () int64: its neighbour
    ll_star: torch.Tensor      # () f32: its log-likelihood
    p_fwd: torch.Tensor        # () f32: its probability
    sw: torch.Tensor           # () f32: the forward weights' sum
    mx: torch.Tensor           # () f32: the best kept tempered score
    ok: torch.Tensor | None = None     # delta: sw > 0 and the chosen neighbour fits f_max
    undo: object = None        # delta: the state before the move (plain) or E2's saved values
    rows: torch.Tensor | None = None   # delta: the neighbours' member rows
    rows_valid: torch.Tensor | None = None


def _scalar(x, dev):
    """A Python number as the 0-d f32 tensor the kernels take (torch rounds a
    CPU scalar to f32 against f32 operands); a tensor as it is."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), float(x), dtype=torch.float32, device=dev)


def move_set(state: GenomeState, f_a, jump: JumpTable, mask_pivot, given=None):
    """E1: the neighbour set of ``f_a`` (:func:`_neighbour_set`) with its
    discard mask at ``mask_pivot`` (:func:`_impossibility_mask`, or an
    invalid slot), the state's largest contig id and its contig count.
    ``given`` = (ids, valid): the mask-only mode, the mask of those slots
    (``f_a`` unused). Returns (ids (m,) int64, valid (m,), discard (m, 13),
    max_id () int32, n_contigs () int64): :func:`move_set_plain`'s result,
    by kernel E1 when the state is on a card."""
    if state.pos.device.type == "cuda":
        return _set_on_card(state, f_a, jump, mask_pivot, given)
    return move_set_plain(state, f_a, jump, mask_pivot, given)


def _set_on_card(state: GenomeState, f_a, jump: JumpTable, mask_pivot, given):
    dev = state.pos.device
    f_a = None if given is not None else torch.as_tensor(f_a, device=dev).long()
    return MOVE.set(state._asdict(), f_a, jump.frags,
                    torch.as_tensor(mask_pivot, device=dev).long(), given)


def move_set_plain(state: GenomeState, f_a, jump: JumpTable, mask_pivot, given=None):
    """:func:`move_set` in plain torch."""
    ids, valid = _neighbour_set(state, f_a, jump) if given is None else given
    discard = _impossibility_mask(state, mask_pivot, ids) | ~valid[:, None]
    return ids, valid, discard, state.id_c.amax(), state.n_contigs()


def _forward_weights(variant, ll_flat, discard_flat, f_t):
    """(weights, their sum, the best kept tempered score) of a forward
    pass: MTM weights or MH probabilities."""
    if variant == "mtm":
        w, mx = _mtm_weights(ll_flat, discard_flat, f_t)
        return w, w.sum(), mx
    return _mh_probs(ll_flat, discard_flat, f_t)


def forward_dense(variant, ll, discard, f_t, gumbel, ids, cands: GenomeState) -> Forward:
    """E2 on a dense step: the forward weights of the scores ``ll`` (m, 13)
    (MTM weights or MH probabilities, ``variant``), the slot drawn by
    argmax(log p + ``gumbel``), and that candidate of the flat catalogue
    ``cands`` (fields (m x 13, n)) as g*. :func:`forward_dense_plain`'s
    result, by kernel E2 when the scores are on a card (there the weights'
    sum, and p with it, is summed in another order: the drawn slot may
    differ where the two best keys lie within a few ulps,
    ``csrc/mtm.cu``)."""
    if ll.device.type == "cuda":
        return _draw_dense_on_card(variant, ll, discard, f_t, gumbel, ids, cands)
    return forward_dense_plain(variant, ll, discard, f_t, gumbel, ids, cands)


def _draw_dense_on_card(variant, ll, discard, f_t, gumbel, ids, cands: GenomeState):
    g_star, *out = MOVE.draw_dense(variant, ll, discard, gumbel, ids, f_t, tuple(cands))
    return Forward(GenomeState(*g_star), *out)


def forward_dense_plain(variant, ll, discard, f_t, gumbel, ids, cands: GenomeState) -> Forward:
    """:func:`forward_dense` in plain torch."""
    ll_flat = ll.reshape(-1)
    w, sw, mx = _forward_weights(variant, ll_flat, discard.reshape(-1), f_t)
    p = w / sw
    omega = _categorical(p, gumbel)
    return Forward(GenomeState(*[_take(x, omega) for x in cands]), omega,
                   _take(ids, omega // N_CANDIDATES), _take(ll_flat, omega), _take(p, omega),
                   sw, mx)


def forward_delta(variant, dll, l_t, overflow, discard, f_t, gumbel, ids, minis: GenomeState,
                  rows, rows_valid, state: GenomeState, inplace: bool = False) -> Forward:
    """E2 on a delta step: the forward pass of the candidate likelihoods
    ``l_t`` + ``dll`` (m, 13), the neighbour slots that overflow f_max
    (``overflow`` (m,)) discarded, the weights' sum clamped at 1e-30 in p;
    g* is ``state`` with the drawn mini-state of ``minis`` (fields (m, 13,
    f_max)) written at its neighbour's valid ``rows``. On a card kernel E2
    writes it into ``state`` itself with ``inplace`` (a captured cycle's
    carry) and else into a copy of the mutable fields, and saves the values
    it overwrote for E3; elsewhere :func:`forward_delta_plain` builds a new
    genome (the rule of :func:`forward_dense` on the drawn slot)."""
    if dll.device.type == "cuda":
        return _draw_delta_on_card(variant, dll, l_t, overflow, discard, f_t, gumbel, ids, minis,
                                   rows, rows_valid, state, inplace)
    return forward_delta_plain(variant, dll, l_t, overflow, discard, f_t, gumbel, ids, minis,
                               rows, rows_valid, state)


def _draw_delta_on_card(variant, dll, l_t, overflow, discard, f_t, gumbel, ids,
                        minis: GenomeState, rows, rows_valid, state: GenomeState, inplace):
    g_star = state if inplace else state._replace(
        **{f: getattr(state, f).clone() for f in MUTABLE_FIELDS})
    undo, *out = MOVE.draw_delta(variant, dll, _scalar(l_t, dll.device), overflow, discard,
                                 gumbel, ids, f_t, minis._asdict(), rows, rows_valid,
                                 g_star._asdict())
    return Forward(g_star, *out, undo=undo, rows=rows, rows_valid=rows_valid)


def forward_delta_plain(variant, dll, l_t, overflow, discard, f_t, gumbel, ids,
                        minis: GenomeState, rows, rows_valid, state: GenomeState) -> Forward:
    """:func:`forward_delta` in plain torch (g* through
    :func:`_delta_commit_candidate`; ``undo`` the state that came in)."""
    ll_flat = (l_t + dll).reshape(-1)
    w, sw, mx = _forward_weights(variant, ll_flat, (discard | overflow[:, None]).reshape(-1), f_t)
    p = w / sw.clamp_min(1e-30)
    omega = _categorical(p, gumbel)
    sel_nb = omega // N_CANDIDATES
    return Forward(_delta_commit_candidate(state, omega, minis, rows, rows_valid), omega,
                   _take(ids, sel_nb), _take(ll_flat, omega), _take(p, omega), sw, mx,
                   (sw > 0) & ~_take(overflow, sel_nb), undo=state, rows=rows,
                   rows_valid=rows_valid)


def accept_dense(variant, ll_b, discard_b, fwd: Forward, state: GenomeState, l_t, f_t, u,
                 corrected: bool):
    """E3 on a dense step: from the backward scores ``ll_b`` (m, 13), the
    MTM ratio exp(max_f - max_b) sum(w_f) / sum(w_b) or the MH ratio with
    the probability of returning to ``state`` (:func:`_mh_ratio`,
    ``corrected`` its canonical form), the acceptance min(ratio, 1) >= ``u``
    and the commit. Returns (new state, l_t, accepted, n_contigs, ratio):
    :func:`accept_dense_plain`'s result, by kernel E3 when the scores are on
    a card (there the backward sum, and the ratio with it, may differ in the
    last ulps, and the decision where min(ratio, 1) lies that close to
    ``u``)."""
    if ll_b.device.type == "cuda":
        return _accept_dense_on_card(variant, ll_b, discard_b, fwd, state, l_t, f_t, u,
                                     corrected)
    return accept_dense_plain(variant, ll_b, discard_b, fwd, state, l_t, f_t, u, corrected)


def _accept_dense_on_card(variant, ll_b, discard_b, fwd: Forward, state: GenomeState, l_t, f_t,
                          u, corrected):
    fields, *out = MOVE.accept_dense(variant, ll_b, discard_b, fwd, tuple(fwd.g_star),
                                     tuple(state), _scalar(l_t, ll_b.device), u, f_t, corrected)
    return (GenomeState(*fields), *out)


def accept_dense_plain(variant, ll_b, discard_b, fwd: Forward, state: GenomeState, l_t, f_t, u,
                       corrected: bool):
    """:func:`accept_dense` in plain torch."""
    ll_flat, disc = ll_b.reshape(-1), discard_b.reshape(-1)
    if variant == "mtm":
        w_b, max_b = _mtm_weights(ll_flat, disc, f_t)
        ratio = torch.exp(fwd.mx - max_b) * fwd.sw / w_b.sum()
    else:
        p_bwd, _ = _mh_return_prob(ll_flat, disc, l_t, f_t, clamp_sum=False)
        ratio = _mh_ratio(fwd.ll_star, l_t, fwd.p_fwd, p_bwd, f_t, corrected)
    accept = ratio.clamp_max(1.0) >= u
    return (*_commit(accept, fwd.g_star, state, fwd.ll_star, l_t), ratio)


def accept_delta(variant, dll_b, overflow_b, discard_b, fwd: Forward, l_t, f_t, u,
                 corrected: bool, n_contigs):
    """E3 on a delta step: :func:`accept_dense`'s ratio of the backward
    candidates ``fwd.ll_star`` + ``dll_b`` (m, 13), the slots overflowing
    f_max (``overflow_b``) discarded, the backward sum clamped at 1e-30; the
    step is rejected when either pass has no weight or the chosen forward
    neighbour overflows. The commit: on a card E3 writes E2's saved values
    back into g* on a rejection (g* is then the state that came in) and
    counts the contigs from ``n_contigs``, the count before the move (E1's),
    over the rows the move wrote; elsewhere :func:`accept_delta_plain`'s
    selects over the 11 fields. Returns (new state, l_t, accepted,
    n_contigs, ratio)."""
    if dll_b.device.type == "cuda":
        return _accept_delta_on_card(variant, dll_b, overflow_b, discard_b, fwd, l_t, f_t, u,
                                     corrected, n_contigs)
    return accept_delta_plain(variant, dll_b, overflow_b, discard_b, fwd, l_t, f_t, u, corrected)


def _accept_delta_on_card(variant, dll_b, overflow_b, discard_b, fwd: Forward, l_t, f_t, u,
                          corrected, n_contigs):
    g_star = fwd.g_star
    out = MOVE.accept_delta(variant, dll_b, overflow_b, discard_b, fwd, g_star._asdict(),
                            fwd.rows, fwd.rows_valid, fwd.undo, n_contigs,
                            _scalar(l_t, dll_b.device), u, f_t, corrected)
    return (g_star, *out)


def accept_delta_plain(variant, dll_b, overflow_b, discard_b, fwd: Forward, l_t, f_t, u,
                       corrected: bool):
    """:func:`accept_delta` in plain torch (the state that came in is
    ``fwd.undo``)."""
    ll_flat = (fwd.ll_star + dll_b).reshape(-1)
    disc = (discard_b | overflow_b[:, None]).reshape(-1)
    if variant == "mtm":
        w_b, max_b = _mtm_weights(ll_flat, disc, f_t)
        sw_b = w_b.sum()
        ratio = torch.exp(fwd.mx - max_b) * fwd.sw / sw_b.clamp_min(1e-30)
    else:
        p_bwd, sw_b = _mh_return_prob(ll_flat, disc, l_t, f_t, clamp_sum=True)
        ratio = _mh_ratio(fwd.ll_star, l_t, fwd.p_fwd, p_bwd, f_t, corrected)
    accept = fwd.ok & (sw_b > 0) & (ratio.clamp_max(1.0) >= u)
    return (*_commit(accept, fwd.g_star, fwd.undo, fwd.ll_star, l_t), ratio)


# ---------------------------------------------------------------------------
# Dense steps and cycles
# ---------------------------------------------------------------------------

def _draws(rng, jump):
    return draw_move_inputs(rng, jump) if isinstance(rng, torch.Generator) else rng


def _make_scores_for(table, obs, ll_dtype, scorer):
    """Candidate scoring of one pass: the m x 13 MH-catalogue candidates of
    ``f_a`` against ``nb_ids``, in one call of ``scorer``. Returns (flat
    candidates (m * 13, n), scores (m, 13) f32)."""
    if scorer is None:
        scorer = _default_scorer(table, obs, ll_dtype)

    def scores_for(state, f_a, nb_ids, params):
        cands = mh_candidates(state, f_a, nb_ids)
        m, n = nb_ids.shape[0], state.n_frags
        flat = GenomeState(*[x.reshape(m * N_CANDIDATES, n) for x in cands])
        return flat, scorer(flat, params).reshape(m, N_CANDIDATES).float()

    return scores_for


def make_mtm_step(table: SubFragTable, obs, jump: JumpTable, ll_dtype=torch.float32,
                  scorer=None, corrected: bool = False):
    """Build step_mtm(state, rng, params, l_t, f_a, f_t) -> (state, l_t,
    accepted, n_contigs), where ``rng`` is a Generator or one step's
    :class:`MoveDraws`.

    ``scorer``: batched likelihood ``(GenomeState (B, n), params) -> (B,)``
    (the run's kernel scorer; by default B1 / B3 on a CUDA table, the plain
    dense likelihood on the CPU).
    ``corrected=True``: the backward pass draws from f*'s own neighbour set
    (canonical MTM) instead of reusing fA's.
    """
    scores_for = _make_scores_for(table, obs, ll_dtype, scorer)

    def step(state: GenomeState, rng, params, l_t, f_a, f_t):
        rng = _draws(rng, jump)
        f_a = torch.as_tensor(f_a, device=state.pos.device)
        nb_ids, nb_valid, discard_f, _, _ = move_set(state, f_a, jump, f_a)

        # ---- forward pass ----
        cands_f, ll_f = scores_for(state, f_a, nb_ids, params)
        fwd = forward_dense("mtm", ll_f, discard_f, f_t, rng.gumbel, nb_ids, cands_f)

        # ---- backward pass: pivot at f* ----
        if corrected:
            bk_ids, _, discard_b, _, _ = move_set(fwd.g_star, fwd.f_star, jump, f_a)
        else:
            bk_ids = nb_ids
            discard_b = move_set(fwd.g_star, None, jump, f_a, (nb_ids, nb_valid))[2]
        _, ll_b = scores_for(fwd.g_star, fwd.f_star, bk_ids, params)
        return accept_dense("mtm", ll_b, discard_b, fwd, state, l_t, f_t, rng.u_acc,
                            corrected)[:4]

    return step


def make_mh_step(table: SubFragTable, obs, jump: JumpTable, ll_dtype=torch.float32,
                 scorer=None, corrected: bool = False):
    """Build the plain Metropolis-Hastings step
    (step_metropolis_hastings_s_a, cuda_lib_gl.py:2836-2934), with the
    signature of :func:`make_mtm_step`. ``corrected=True`` uses the
    canonical ratio exp((L* - L_t) / F_t) p_bwd / p_fwd."""
    scores_for = _make_scores_for(table, obs, ll_dtype, scorer)

    def step(state: GenomeState, rng, params, l_t, f_a, f_t):
        rng = _draws(rng, jump)
        f_a = torch.as_tensor(f_a, device=state.pos.device)
        nb_ids, nb_valid, discard_f, _, _ = move_set(state, f_a, jump, f_a)

        cands_f, ll_f = scores_for(state, f_a, nb_ids, params)
        fwd = forward_dense("mh", ll_f, discard_f, f_t, rng.gumbel, nb_ids, cands_f)

        # backward probability of returning to the current genome
        _, ll_b = scores_for(fwd.g_star, f_a, nb_ids, params)
        discard_b = move_set(fwd.g_star, None, jump, f_a, (nb_ids, nb_valid))[2]
        return accept_dense("mh", ll_b, discard_b, fwd, state, l_t, f_t, rng.u_acc,
                            corrected)[:4]

    return step


def make_mtm_cycle(table: SubFragTable, obs, jump: JumpTable, variant="mtm",
                   ll_dtype=torch.float32, scorer=None, corrected: bool = False,
                   capture=None):
    """One MTM / MH cycle over a fragment order (the start_MTM inner loop,
    main_gl.py:361-379), a scan of steps (:func:`_scan_cycle`).

    Returns cycle(state, rng, params, frag_order, l_t, f_t) -> (state, l_t,
    (lls, accepts, n_contigs)) with per-step tensors; ``rng`` is a
    Generator or :class:`MoveDraws` with a leading axis of
    len(frag_order). ``capture``: as :class:`graal_tpu_torch.core.graphs.Scan`
    takes it (False runs eagerly on the card)."""
    if variant not in ("mtm", "mh"):
        raise ValueError(f"unknown variant {variant!r} (expected mtm or mh)")
    step = (make_mtm_step if variant == "mtm" else make_mh_step)(
        table, obs, jump, ll_dtype, scorer=scorer, corrected=corrected)
    return _scan_cycle(step, jump, table.owner.device, capture)


def _scan_cycle(step, jump, device, capture):
    """The cycle of ``step`` as a :class:`graal_tpu_torch.core.graphs.Scan`
    (the JAX package's jitted ``lax.scan``): on a CUDA device one captured
    graph replayed once a step, elsewhere the same body step by step.
    Carry (state, l_t), constants (params, f_t: a Python f_t becomes a 0-d
    f32 buffer, reloaded by every call), per-step inputs (the draws, the
    fragment), outputs (l_t, accepted, n_contigs) stacked by the scan."""

    def body(carry, consts, x):
        state, l_t = carry
        params, f_t = consts
        draws, f_a = x
        state, l_t, accepted, n_contigs = step(state, draws, params, l_t, f_a, f_t)
        return (state, l_t), (l_t, accepted, n_contigs)

    scan = graphs.Scan(body, device, capture=capture)

    def cycle(state: GenomeState, rng, params, frag_order, l_t, f_t):
        dev = state.pos.device
        frag_order = torch.as_tensor(frag_order, device=dev).long()
        if isinstance(rng, torch.Generator):
            rng = draw_move_inputs(rng, jump, (frag_order.shape[0],))
        l_t = torch.as_tensor(l_t, device=dev)
        (state, l_t), ys = scan((state, l_t), (params, f_t), (rng, frag_order))
        return state, l_t, ys

    cycle.scan = scan
    return cycle


# ---------------------------------------------------------------------------
# Delta-scored steps (the chr1-scale refinement samplers)
# ---------------------------------------------------------------------------

def _delta_mh_scorer(table: SubFragTable, f_max: int, sobs, band_w, rep, obs_grid,
                     mini_grid):
    """The delta engine with the MH catalogue: the repeat engine v2 for a
    copy-expanded table, the plain one (band applied as the EM path does)
    otherwise."""
    from graal_tpu_torch.core import delta as delta_mod

    if table.has_repeats:
        from graal_tpu_torch.core import delta_repeats

        return delta_repeats.make_repeat_delta_scorer_v2(
            table, f_max, sobs, rep, obs_grid=obs_grid, mini_grid=mini_grid,
            catalogue=mh_candidates)
    return delta_mod.make_delta_scorer(
        table, None, f_max, sobs=sobs, band_w=delta_mod.effective_band_w(band_w, table, f_max),
        obs_grid=obs_grid, mini_grid=mini_grid, catalogue=mh_candidates)


def _delta_score_set(dscore):
    """score_set(state, pivot, nb_ids, params, max_id) -> (dll (m, 13),
    minis (m, 13, f_max), rows, valid, overflow): every neighbour on its own
    member rows, as the JAX package's per-neighbour spec extracts them;
    ``max_id`` the state's largest contig id (E1's)."""
    from graal_tpu_torch.core.delta import extract_rows_each

    def score_set(state, pivot, nb_ids, params, max_id):
        rows, valid, over = extract_rows_each(state, pivot, nb_ids, dscore.f_max)
        return dscore.score(state, pivot, nb_ids, rows, valid, over, params, max_id)

    return score_set


def _delta_commit_candidate(state, omega, minis_f, rows_f, rvalid_f):
    """The full genome with mini candidate ``omega`` written back."""
    from graal_tpu_torch.core.delta import drop_chain, lift_chain, scatter_mini

    m = rows_f.shape[0]
    sel_nb = omega // N_CANDIDATES
    sel_mini = GenomeState(*[_take(x.reshape(m * N_CANDIDATES, -1), omega) for x in minis_f])
    return drop_chain(scatter_mini(*lift_chain(state, sel_mini, _take(rows_f, sel_nb),
                                               _take(rvalid_f, sel_nb))))[0]


def make_delta_mtm_step(table: SubFragTable, jump: JumpTable, f_max: int, sobs,
                        band_w: int | None = None, corrected: bool = False,
                        obs_grid=None, mini_grid=None, rep=None):
    """MTM step with delta candidate scoring, the signature of
    :func:`make_mtm_step` (``rng`` a Generator or :class:`MoveDraws`) and
    ``inplace``: on a card, write the proposal into ``state``'s own tensors
    (the captured cycle's carry, which nothing else holds).

    Candidate likelihoods are the carried l_t plus the engine's deltas. The
    chosen mini candidate is written into the full genome before the
    backward pass; a step whose chosen forward neighbour overflows
    ``f_max``, or with no backward weight, is rejected. A repeat table goes
    to the repeat engine v2 with the MH catalogue; ``rep``, the genome's
    repeat flags, is then required (its exactness contract). ``obs_grid``
    / ``mini_grid``: the kernel wrappers to launch through."""
    dscore = _delta_mh_scorer(table, f_max, sobs, band_w, rep, obs_grid, mini_grid)
    score_set = _delta_score_set(dscore)

    def step(state: GenomeState, rng, params, l_t, f_a, f_t, inplace=False):
        rng = _draws(rng, jump)
        f_a = torch.as_tensor(f_a, device=state.pos.device)
        nb_ids, nb_valid, discard_f, max_id, n_contigs = move_set(state, f_a, jump, f_a)
        dll_f, minis_f, rows_f, rvalid_f, over_f = score_set(state, f_a, nb_ids, params, max_id)
        fwd = forward_delta("mtm", dll_f, l_t, over_f, discard_f, f_t, rng.gumbel, nb_ids,
                            minis_f, rows_f, rvalid_f, state, inplace)

        # ---- backward pass: pivot at f* from the committed genome ----
        if corrected:
            bk_ids, _, discard_b, max_b, _ = move_set(fwd.g_star, fwd.f_star, jump, f_a)
        else:
            bk_ids = nb_ids
            _, _, discard_b, max_b, _ = move_set(fwd.g_star, None, jump, f_a, (nb_ids, nb_valid))
        dll_b, _, _, _, over_b = score_set(fwd.g_star, fwd.f_star, bk_ids, params, max_b)
        return accept_delta("mtm", dll_b, over_b, discard_b, fwd, l_t, f_t, rng.u_acc,
                            corrected, n_contigs)[:4]

    return step


def make_delta_mh_step(table: SubFragTable, jump: JumpTable, f_max: int, sobs,
                       band_w: int | None = None, corrected: bool = False,
                       obs_grid=None, mini_grid=None, rep=None):
    """Plain Metropolis-Hastings with delta candidate scoring: the delta
    twin of :func:`make_mh_step`, with the arguments of
    :func:`make_delta_mtm_step` and its step's ``inplace``. The backward
    pass pivots at fA."""
    dscore = _delta_mh_scorer(table, f_max, sobs, band_w, rep, obs_grid, mini_grid)
    score_set = _delta_score_set(dscore)

    def step(state: GenomeState, rng, params, l_t, f_a, f_t, inplace=False):
        rng = _draws(rng, jump)
        f_a = torch.as_tensor(f_a, device=state.pos.device)
        nb_ids, nb_valid, discard_f, max_id, n_contigs = move_set(state, f_a, jump, f_a)
        dll_f, minis_f, rows_f, rvalid_f, over_f = score_set(state, f_a, nb_ids, params, max_id)
        fwd = forward_delta("mh", dll_f, l_t, over_f, discard_f, f_t, rng.gumbel, nb_ids,
                            minis_f, rows_f, rvalid_f, state, inplace)

        # backward return probability, pivot fA
        _, _, discard_b, max_b, _ = move_set(fwd.g_star, None, jump, f_a, (nb_ids, nb_valid))
        dll_b, _, _, _, over_b = score_set(fwd.g_star, f_a, nb_ids, params, max_b)
        return accept_delta("mh", dll_b, over_b, discard_b, fwd, l_t, f_t, rng.u_acc,
                            corrected, n_contigs)[:4]

    return step


def make_delta_mtm_cycle(table: SubFragTable, jump: JumpTable, f_max: int, sobs,
                         variant: str = "mtm", band_w: int | None = None,
                         corrected: bool = False, obs_grid=None, mini_grid=None, rep=None,
                         capture=None):
    """A delta-scored MTM / MH cycle (a scan of steps, as
    :func:`make_mtm_cycle`'s), with its signature and outputs; no re-anchor
    (the caller anchors once per cycle). What a capture fixes, the bucket
    ``f_max``, the jump table's delta, the engine, is fixed by this cycle.
    The steps write their proposals into the scan's carry in place."""
    if variant not in ("mtm", "mh"):
        raise ValueError(f"unknown variant {variant!r} (expected mtm or mh)")
    step = (make_delta_mtm_step if variant == "mtm" else make_delta_mh_step)(
        table, jump, f_max, sobs, band_w=band_w, corrected=corrected, obs_grid=obs_grid,
        mini_grid=mini_grid, rep=rep)
    return _scan_cycle(functools.partial(step, inplace=True), jump, table.owner.device, capture)
