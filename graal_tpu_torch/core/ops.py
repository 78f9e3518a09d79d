"""Structural mutation primitives on batches of genome states.

PyTorch counterpart of ``graal_tpu.core.ops``. Each primitive maps a batch
of states (every field of shape ``(B, n)``) and per-genome fragment indices
(shape ``(B,)``) to a new batch of the same shape; the JAX package's
``vmap`` axis is the leading dimension here. The per-fragment case
analyses are masked ``torch.where`` updates over the whole fragment vector.

- :func:`flip`           <- flip_frag
- :func:`swap_activity`  <- swap_activity_frag
- :func:`pop_out`        <- pop_out_frag
- :func:`pop_in_1`       <- pop_in_frag_1   split insert @ left
- :func:`pop_in_2`       <- pop_in_frag_2   split insert @ right
- :func:`pop_in_3`       <- pop_in_frag_3   insert @ right
- :func:`pop_in_4`       <- pop_in_frag_4   insert @ left
- :func:`split`          <- split_contig
- :func:`paste`          <- paste_contigs

Scalar arguments (``ori_pop``, ``upstream``) are Python ints or tensors of
shape ``(B,)``; ``max_id_contig`` is a tensor of shape ``(B,)``.
"""

from __future__ import annotations

import torch

from graal_tpu_torch.core.state import GenomeState


def _col(x):
    """A per-genome value as a (B, 1) column (Python ints pass through)."""
    return x.reshape(-1, 1) if isinstance(x, torch.Tensor) else x


def _at(x, f):
    """Field value of fragment ``f[b]`` in genome ``b``, as a (B, 1) column."""
    return x.gather(-1, f.long().reshape(-1, 1))


def _idx(state: GenomeState):
    return torch.arange(state.n_frags, device=state.pos.device)


def flip(state: GenomeState, f) -> GenomeState:
    """Negate the orientation of fragment ``f``."""
    is_f = _idx(state) == _col(f)
    return state._replace(ori=torch.where(is_f, -state.ori, state.ori))


def swap_activity(state: GenomeState, f, max_id_contig) -> GenomeState:
    """Toggle the activity of a *repeated* fragment ``f``: deactivating keeps
    its contig id; re-activating moves it to a fresh contig id. No-op for
    non-repeats."""
    is_f = (_idx(state) == _col(f)) & (state.rep == 1)
    old_act = _at(state.activ, f)
    new_act = torch.where(old_act == 1, 0, 1).to(state.activ.dtype)
    new_idc = torch.where(old_act == 1, _at(state.id_c, f),
                          _col(max_id_contig) + 1)
    return state._replace(
        activ=torch.where(is_f, new_act, state.activ),
        id_c=torch.where(is_f, new_idc, state.id_c),
    )


def pop_out(state: GenomeState, f, max_id_contig) -> GenomeState:
    """Remove fragment ``f`` from its contig; it becomes a fresh singleton.

    Remaining fragments close ranks; a 2-fragment contig collapses to a
    linear singleton (circ cleared); popping from a circular contig leaves
    it circular.
    """
    mx = _col(max_id_contig)
    c = _at(state.id_c, f)
    P = _at(state.pos, f)
    L = _at(state.l_cont, f)
    len_f = _at(state.len_bp, f)

    is_f = _idx(state) == _col(f)
    in_c = (state.id_c == c) & ~is_f
    after = in_c & (state.pos > P)
    nontrivial = L > 1  # L == 1: f already a singleton, identity

    pos = torch.where(after, state.pos - 1, state.pos)
    start_bp = torch.where(after, state.start_bp - len_f, state.start_bp)
    l_cont = torch.where(in_c, state.l_cont - 1, state.l_cont)
    l_cont_bp = torch.where(in_c, state.l_cont_bp - len_f, state.l_cont_bp)
    circ = torch.where(in_c & (L == 2), 0, state.circ)

    pos = torch.where(is_f, 0, pos)
    id_c = torch.where(is_f, mx + 1, state.id_c)
    start_bp = torch.where(is_f, 0, start_bp)
    circ = torch.where(is_f, 0, circ)
    ori = torch.where(is_f, 1, state.ori)
    l_cont = torch.where(is_f, 1, l_cont)
    l_cont_bp = torch.where(is_f, len_f, l_cont_bp)

    new = state._replace(pos=pos, id_c=id_c, start_bp=start_bp, circ=circ,
                         ori=ori, l_cont=l_cont, l_cont_bp=l_cont_bp)
    return _select(nontrivial, new, state)


def _select(cond, a: GenomeState, b: GenomeState) -> GenomeState:
    """Per-genome state select on a (B, 1) predicate."""
    return GenomeState(*[torch.where(cond, x, y) for x, y in zip(a, b)])


def _guard_activ(state, new, f_a, f_b):
    """Return ``new`` where both fragments are active and distinct, else
    ``state``. The f_a == f_b guard makes every op a total function."""
    ok = (_at(state.activ, f_a) == 1) & (_at(state.activ, f_b) == 1) \
        & (_col(f_a) != _col(f_b))
    return _select(ok, new, state)


def pop_in_1(state: GenomeState, f_pop, f_ins, ori_pop, max_id_contig) -> GenomeState:
    """Split-insert @ left: f_pop becomes the head of a new contig formed by
    [f_pop, f_ins, ...rest of f_ins's contig]; the part before f_ins stays.
    ``state`` must have f_pop as a singleton (output of :func:`pop_out`).
    Inserting into a circular contig linearises it with f_pop at the
    origin."""
    mx = _col(max_id_contig)
    ci = _at(state.id_c, f_ins)
    Pi = _at(state.pos, f_ins)
    Li = _at(state.l_cont, f_ins)
    Lbpi = _at(state.l_cont_bp, f_ins)
    si = _at(state.start_bp, f_ins)
    circ_i = _at(state.circ, f_ins)
    len_pop = _at(state.len_bp, f_pop)

    is_pop = _idx(state) == _col(f_pop)
    in_ci = (state.id_c == ci) & ~is_pop
    before = in_ci & (state.pos < Pi)
    at_or_after = in_ci & (state.pos >= Pi)

    lin = circ_i == 0
    new_label = torch.where(lin, mx + 1, ci)
    id_c = torch.where(is_pop | at_or_after, new_label, state.id_c)

    pos = state.pos
    pos = torch.where(is_pop, 0, pos)
    pos = torch.where(at_or_after, state.pos - Pi + 1, pos)
    # circular: the wrapped-around prefix goes after the old suffix
    pos = torch.where(before & ~lin, Li - Pi + state.pos + 1, pos)

    start_bp = state.start_bp
    start_bp = torch.where(is_pop, 0, start_bp)
    start_bp = torch.where(at_or_after, state.start_bp - si + len_pop, start_bp)
    start_bp = torch.where(before & ~lin,
                           Lbpi - si + state.start_bp + len_pop, start_bp)

    l_new = torch.where(lin, Li - Pi + 1, Li + 1)
    lbp_new = torch.where(lin, Lbpi - si + len_pop, Lbpi + len_pop)
    l_cont = torch.where(is_pop | at_or_after, l_new, state.l_cont)
    l_cont_bp = torch.where(is_pop | at_or_after, lbp_new, state.l_cont_bp)
    # linear: the left remainder keeps contig ci with l_cont=Pi
    l_cont = torch.where(before & lin, Pi, l_cont)
    l_cont_bp = torch.where(before & lin, si, l_cont_bp)
    # circular: everyone is in the merged contig
    l_cont = torch.where(before & ~lin, l_new, l_cont)
    l_cont_bp = torch.where(before & ~lin, lbp_new, l_cont_bp)

    circ = torch.where(is_pop | in_ci, 0, state.circ)
    ori = torch.where(is_pop, _col(ori_pop), state.ori)

    new = state._replace(pos=pos, id_c=id_c, start_bp=start_bp, circ=circ,
                         ori=ori, l_cont=l_cont, l_cont_bp=l_cont_bp)
    return _guard_activ(state, new, f_pop, f_ins)


def pop_in_2(state: GenomeState, f_pop, f_ins, ori_pop, max_id_contig) -> GenomeState:
    """Split-insert @ right: [head of f_ins's contig ... f_ins, f_pop]; the
    part after f_ins becomes a new contig. Circular target: linearised with
    f_pop at the tail."""
    mx = _col(max_id_contig)
    ci = _at(state.id_c, f_ins)
    Pi = _at(state.pos, f_ins)
    Li = _at(state.l_cont, f_ins)
    Lbpi = _at(state.l_cont_bp, f_ins)
    si = _at(state.start_bp, f_ins)
    len_ins = _at(state.len_bp, f_ins)
    circ_i = _at(state.circ, f_ins)
    len_pop = _at(state.len_bp, f_pop)

    is_pop = _idx(state) == _col(f_pop)
    in_ci = (state.id_c == ci) & ~is_pop
    at_or_before = in_ci & (state.pos <= Pi)
    after = in_ci & (state.pos > Pi)
    lin = circ_i == 0

    shift_p = Li - (Pi + 1)              # circular wrap offset (fragments)
    shift_bp = Lbpi - (si + len_ins)     # circular wrap offset (bp)

    pos = state.pos
    start_bp = state.start_bp
    pos = torch.where(is_pop, torch.where(lin, Pi + 1, Li), pos)
    start_bp = torch.where(is_pop, torch.where(lin, si + len_ins, Lbpi), start_bp)
    pos = torch.where(at_or_before & ~lin, shift_p + state.pos, pos)
    start_bp = torch.where(at_or_before & ~lin, shift_bp + state.start_bp, start_bp)
    pos = torch.where(after, state.pos - (Pi + 1), pos)
    start_bp = torch.where(after, state.start_bp - (si + len_ins), start_bp)

    id_c = torch.where(is_pop, ci, state.id_c)
    id_c = torch.where(after & lin, mx + 1, id_c)

    l_keep = torch.where(lin, Pi + 2, Li + 1)
    lbp_keep = torch.where(lin, si + len_ins + len_pop, Lbpi + len_pop)
    l_cont = torch.where(is_pop | at_or_before, l_keep, state.l_cont)
    l_cont_bp = torch.where(is_pop | at_or_before, lbp_keep, state.l_cont_bp)
    l_cont = torch.where(after, torch.where(lin, Li - (Pi + 1), l_keep), l_cont)
    l_cont_bp = torch.where(after, torch.where(lin, Lbpi - (si + len_ins), lbp_keep),
                            l_cont_bp)

    circ = torch.where(is_pop | in_ci, 0, state.circ)
    ori = torch.where(is_pop, _col(ori_pop), state.ori)

    new = state._replace(pos=pos, id_c=id_c, start_bp=start_bp, circ=circ,
                         ori=ori, l_cont=l_cont, l_cont_bp=l_cont_bp)
    return _guard_activ(state, new, f_pop, f_ins)


def pop_in_3(state: GenomeState, f_pop, f_ins, ori_pop, max_id_contig) -> GenomeState:
    """Insert f_pop immediately right of f_ins without splitting. The target
    contig's circ flag is preserved."""
    ci = _at(state.id_c, f_ins)
    Pi = _at(state.pos, f_ins)
    Li = _at(state.l_cont, f_ins)
    Lbpi = _at(state.l_cont_bp, f_ins)
    si = _at(state.start_bp, f_ins)
    len_ins = _at(state.len_bp, f_ins)
    circ_i = _at(state.circ, f_ins)
    len_pop = _at(state.len_bp, f_pop)

    is_pop = _idx(state) == _col(f_pop)
    in_ci = (state.id_c == ci) & ~is_pop
    after = in_ci & (state.pos > Pi)

    pos = torch.where(after, state.pos + 1, state.pos)
    start_bp = torch.where(after, state.start_bp + len_pop, state.start_bp)
    pos = torch.where(is_pop, Pi + 1, pos)
    start_bp = torch.where(is_pop, si + len_ins, start_bp)
    id_c = torch.where(is_pop, ci, state.id_c)
    circ = torch.where(is_pop, circ_i, state.circ)
    ori = torch.where(is_pop, _col(ori_pop), state.ori)
    l_cont = torch.where(is_pop | in_ci, Li + 1, state.l_cont)
    l_cont_bp = torch.where(is_pop | in_ci, Lbpi + len_pop, state.l_cont_bp)

    new = state._replace(pos=pos, id_c=id_c, start_bp=start_bp, circ=circ,
                         ori=ori, l_cont=l_cont, l_cont_bp=l_cont_bp)
    return _guard_activ(state, new, f_pop, f_ins)


def pop_in_4(state: GenomeState, f_pop, f_ins, ori_pop, max_id_contig) -> GenomeState:
    """Insert f_pop immediately left of f_ins without splitting."""
    ci = _at(state.id_c, f_ins)
    Pi = _at(state.pos, f_ins)
    Li = _at(state.l_cont, f_ins)
    Lbpi = _at(state.l_cont_bp, f_ins)
    si = _at(state.start_bp, f_ins)
    circ_i = _at(state.circ, f_ins)
    len_pop = _at(state.len_bp, f_pop)

    is_pop = _idx(state) == _col(f_pop)
    in_ci = (state.id_c == ci) & ~is_pop
    at_or_after = in_ci & (state.pos >= Pi)

    pos = torch.where(at_or_after, state.pos + 1, state.pos)
    start_bp = torch.where(at_or_after, state.start_bp + len_pop, state.start_bp)
    pos = torch.where(is_pop, Pi, pos)
    start_bp = torch.where(is_pop, si, start_bp)
    id_c = torch.where(is_pop, ci, state.id_c)
    circ = torch.where(is_pop, circ_i, state.circ)
    ori = torch.where(is_pop, _col(ori_pop), state.ori)
    l_cont = torch.where(is_pop | in_ci, Li + 1, state.l_cont)
    l_cont_bp = torch.where(is_pop | in_ci, Lbpi + len_pop, state.l_cont_bp)

    new = state._replace(pos=pos, id_c=id_c, start_bp=start_bp, circ=circ,
                         ori=ori, l_cont=l_cont, l_cont_bp=l_cont_bp)
    return _guard_activ(state, new, f_pop, f_ins)


def split(state: GenomeState, f_cut, upstream, max_id_contig) -> GenomeState:
    """Cut the contig of ``f_cut``: before it (upstream=1) or after it
    (upstream=0). A circular contig is linearised at the cut (same contig
    id); a linear one spawns a new contig id for the right part. Identity
    when inactive or singleton."""
    mx = _col(max_id_contig)
    c = _at(state.id_c, f_cut)
    P = _at(state.pos, f_cut)
    L = _at(state.l_cont, f_cut)
    Lbp = _at(state.l_cont_bp, f_cut)
    s_cut = _at(state.start_bp, f_cut)
    len_cut = _at(state.len_bp, f_cut)
    circ_c = _at(state.circ, f_cut)

    in_c = state.id_c == c
    # boundary: fragments at positions >= bound go to the right part
    if isinstance(upstream, torch.Tensor):
        up = _col(upstream) == 1
        bound = torch.where(up, P, P + 1)
        bound_bp = torch.where(up, s_cut, s_cut + len_cut)
    elif upstream == 1:
        bound, bound_bp = P, s_cut
    else:
        bound, bound_bp = P + 1, s_cut + len_cut
    right = in_c & (state.pos >= bound)
    left = in_c & (state.pos < bound)
    lin = circ_c == 0

    # --- linear case: right part becomes a new contig ---
    pos = torch.where(right, state.pos - bound, state.pos)
    start_bp = torch.where(right, state.start_bp - bound_bp, state.start_bp)
    id_c_lin = torch.where(right, mx + 1, state.id_c)
    l_cont_lin = torch.where(right, L - bound, torch.where(left, bound, state.l_cont))
    lbp_lin = torch.where(right, Lbp - bound_bp,
                          torch.where(left, bound_bp, state.l_cont_bp))

    # --- circular case: rotate to linearise, keep contig id and sizes ---
    pos_circ = torch.where(right, state.pos - bound,
                           torch.where(left, state.pos + (L - bound), state.pos))
    start_circ = torch.where(right, state.start_bp - bound_bp,
                             torch.where(left, state.start_bp + (Lbp - bound_bp),
                                         state.start_bp))

    pos = torch.where(lin, pos, pos_circ)
    start_bp = torch.where(lin, start_bp, start_circ)
    id_c = torch.where(lin, id_c_lin, state.id_c)
    l_cont = torch.where(lin, l_cont_lin, state.l_cont)
    l_cont_bp = torch.where(lin, lbp_lin, state.l_cont_bp)
    circ = torch.where(in_c, 0, state.circ)

    new = state._replace(pos=pos, id_c=id_c, start_bp=start_bp, circ=circ,
                         l_cont=l_cont, l_cont_bp=l_cont_bp)
    ok = (_at(state.activ, f_cut) == 1) & (L > 1)
    return _select(ok, new, state)


def paste(state: GenomeState, f_a, f_b, max_id_contig) -> GenomeState:
    """Join the contig ends carrying f_a and f_b.

    Both fragments must sit at extremities of their (linear) contigs. Contig
    A is reversed when f_a is its head so that f_a ends up adjacent to f_b;
    contig B is appended, reversed when f_b is its tail. When f_a and f_b
    are the two ends of the *same* contig the contig is circularised.
    Otherwise-invalid inputs return the state unchanged.
    """
    cA = _at(state.id_c, f_a)
    cB = _at(state.id_c, f_b)
    pA = _at(state.pos, f_a)
    pB = _at(state.pos, f_b)
    LA = _at(state.l_cont, f_a)
    LB = _at(state.l_cont, f_b)
    LbpA = _at(state.l_cont_bp, f_a)
    LbpB = _at(state.l_cont_bp, f_b)

    in_A = state.id_c == cA
    in_B = state.id_c == cB

    # --- different contigs: concatenate ---
    rev_A = pA == 0
    pos_A = torch.where(rev_A, LA - 1 - state.pos, state.pos)
    start_A = torch.where(rev_A, LbpA - (state.start_bp + state.len_bp),
                          state.start_bp)
    ori_A = torch.where(rev_A, -state.ori, state.ori)

    rev_B = pB != 0
    pos_B = torch.where(rev_B, LA + (LB - 1 - state.pos), LA + state.pos)
    start_B = torch.where(rev_B, LbpA + (LbpB - (state.start_bp + state.len_bp)),
                          LbpA + state.start_bp)
    ori_B = torch.where(rev_B, -state.ori, state.ori)

    pos = torch.where(in_A, pos_A, torch.where(in_B, pos_B, state.pos))
    start_bp = torch.where(in_A, start_A, torch.where(in_B, start_B, state.start_bp))
    ori = torch.where(in_A, ori_A, torch.where(in_B, ori_B, state.ori))
    id_c = torch.where(in_B, cA, state.id_c)
    l_cont = torch.where(in_A | in_B, LA + LB, state.l_cont)
    l_cont_bp = torch.where(in_A | in_B, LbpA + LbpB, state.l_cont_bp)
    circ = torch.where(in_A | in_B, 0, state.circ)
    concat = state._replace(pos=pos, id_c=id_c, start_bp=start_bp, circ=circ,
                            ori=ori, l_cont=l_cont, l_cont_bp=l_cont_bp)

    # --- same contig: circularise when f_a / f_b are the two distinct ends ---
    can_circ = (((pA == 0) & (pB == LA - 1)) | ((pA == LA - 1) & (pB == 0))) \
        & (LA > 1)
    circd = state._replace(circ=torch.where(in_A, 1, state.circ))

    ok_activ = (_at(state.activ, f_a) == 1) & (_at(state.activ, f_b) == 1) \
        & (_col(f_a) != _col(f_b))
    same = cA == cB
    result = _select(same, _select(can_circ, circd, state), concat)
    return _select(ok_activ, result, state)
