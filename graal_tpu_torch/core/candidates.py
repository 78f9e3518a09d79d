"""Build the 13 candidate genomes of (fragment, neighbour) proposals.

PyTorch counterpart of ``graal_tpu.core.candidates``: the EM catalogue
(:func:`build_candidates`) and the Metropolis-Hastings / MTM one
(:func:`mh_candidates`). The EM catalogue:

====  =======================================  =============================
mode  operation                                built from
====  =======================================  =============================
0     eject fragment                           pop_out
1     flip fragment                            flip
2/3   pop out, split-insert left of B (+/-)    pop_out then pop_in_1
4/5   pop out, split-insert right of B (+/-)   pop_out then pop_in_2
6/7   pop out, insert right of B (+/-)         pop_out then pop_in_3
8     swap activity (repeats only)             pop_out then swap_activity
9-12  translocation (4 cut-direction combos)   split(A) o split(B) o paste
====  =======================================  =============================

The m neighbours of one step are the batch dimension. On a card the
catalogues are one hand-written kernel call each (C1 for the EM catalogue,
C2 for the MH one: ``ops.candidates_cuda``, ``csrc/candidates.cu``); on
any other device they are their plain versions,
:func:`build_candidates_plain` and :func:`mh_candidates_plain`, one pass
over the primitives of ``core.ops`` with the neighbours as the batch
dimension of every op. Both give the same int32 fields bit for bit.
"""

from __future__ import annotations

import numbers

import torch

from graal_tpu_torch.core import ops
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.ops.candidates_cuda import CATALOGUE

N_CANDIDATES = 13

# Names of the 13 modes, as the reference prints them.
MODIFICATION_STR = [
    "eject frag",
    "flip frag",
    "pop out split insert @ left or 1", "pop out split insert @ left or -1",
    "pop out split insert @ right or 1", "pop out split insert @ right or -1",
    "pop out insert @ right or 1", "pop out insert @ right or -1",
    "swap activity",
    "transloc_1", "transloc_2", "transloc_3", "transloc_4",
]


def _batch(state: GenomeState, f_a, f_b: torch.Tensor, max_id):
    """The m-genome batch of a catalogue call: (batch (m, n), f_a (m,),
    f_b (m,), max_id (m,)), all int64 indices."""
    m = f_b.shape[0]
    n = state.n_frags
    dev = state.pos.device
    batch = GenomeState(*[x.expand(m, n) for x in state])
    # int64 indices once, rather than a cast at every field gather
    f_b = f_b.long()
    if isinstance(f_a, torch.Tensor):
        fa = f_a.to(dev).long().reshape(-1).expand(m)
    else:
        fa = torch.full((m,), f_a, dtype=torch.int64, device=dev)
    if max_id is None:
        max_id = state.id_c.amax()
    max_id = torch.as_tensor(max_id, dtype=state.id_c.dtype, device=dev).expand(m)
    return batch, fa, f_b, max_id


def _stack(cands) -> GenomeState:
    return GenomeState(*[torch.stack(fields, dim=1) for fields in zip(*cands)])


def _on_card(kind, state: GenomeState, f_a, f_b, max_id, with_base):
    """The catalogue ``kind`` of a state on a card, through its kernel
    (indices and maxima on another device are moved to the state's, f_b
    made contiguous)."""
    dev = state.pos.device

    def here(x):
        if x is None or isinstance(x, numbers.Integral):
            return x
        x = torch.as_tensor(x, device=dev)
        return x if x.dtype in (torch.int32, torch.int64) else x.long()

    f_b = here(f_b)
    return GenomeState(*CATALOGUE(kind, state, here(f_a), f_b.contiguous(), here(max_id),
                                  with_base))


def _with_base(batch: GenomeState, cands: GenomeState) -> GenomeState:
    return GenomeState(*[torch.cat([a[:, None], b], 1) for a, b in zip(batch, cands)])


def build_candidates(state: GenomeState, f_a, f_b: torch.Tensor, max_id=None,
                     with_base: bool = False) -> GenomeState:
    """Candidate genomes for moving fragment ``f_a`` relative to each of the
    neighbours ``f_b`` (shape ``(m,)``): :func:`build_candidates_plain`'s
    result, built by kernel C1 when the state is on a card."""
    if state.pos.device.type == "cuda":
        return _on_card("em", state, f_a, f_b, max_id, with_base)
    return build_candidates_plain(state, f_a, f_b, max_id, with_base)


def mh_candidates(state: GenomeState, f_a, f_b: torch.Tensor, max_id=None,
                  with_base: bool = False) -> GenomeState:
    """The Metropolis-Hastings / MTM catalogue: :func:`mh_candidates_plain`'s
    result, built by kernel C2 when the state is on a card."""
    if state.pos.device.type == "cuda":
        return _on_card("mh", state, f_a, f_b, max_id, with_base)
    return mh_candidates_plain(state, f_a, f_b, max_id, with_base)


def build_candidates_plain(state: GenomeState, f_a, f_b: torch.Tensor, max_id=None,
                           with_base: bool = False) -> GenomeState:
    """Candidate genomes for moving fragment ``f_a`` relative to each of the
    neighbours ``f_b`` (shape ``(m,)``).

    ``state`` is one genome (fields of shape ``(n,)``) shared by the m
    neighbours, or one genome per neighbour (``(m, n)``, the delta engine's
    mini-states); ``f_a`` a Python int, a 0-d tensor or one index per
    neighbour (``(m,)``). Returns a state whose fields have shape
    ``(m, 13, n)``. ``max_id``: the maximum contig id in use (defaults to
    the state's own maximum; pass the whole genome's maximum when ``state``
    holds mini-states, so that fresh contig ids never collide with contigs
    outside the view), a scalar or one value per neighbour. ``with_base``:
    fields of shape ``(m, 14, n)``, each neighbour's base genome in slot 0
    (the delta engine's layout).
    """
    batch, fa, f_b, max_id = _batch(state, f_a, f_b, max_id)
    popped = ops.pop_out(batch, fa, max_id)
    m2 = torch.maximum(popped.id_c.amax(-1), max_id)

    cands = [
        popped,                                           # 0: eject
        ops.flip(batch, fa),                              # 1: flip
        ops.pop_in_1(popped, fa, f_b, 1, m2),             # 2
        ops.pop_in_1(popped, fa, f_b, -1, m2),            # 3
        ops.pop_in_2(popped, fa, f_b, 1, m2),             # 4
        ops.pop_in_2(popped, fa, f_b, -1, m2),            # 5
        ops.pop_in_3(popped, fa, f_b, 1, m2),             # 6
        ops.pop_in_3(popped, fa, f_b, -1, m2),            # 7
        ops.swap_activity(popped, fa, m2),                # 8
    ]
    # Translocations: split at A (down/up-stream), split at B, paste A-B
    # (loop order upstream-A outer, upstream-B inner; upstream=0 cuts after).
    for up_a in (0, 1):
        t1 = ops.split(batch, fa, up_a, max_id)
        m1 = torch.maximum(t1.id_c.amax(-1), max_id)
        for up_b in (0, 1):
            t2 = ops.split(t1, f_b, up_b, m1)
            mt = torch.maximum(t2.id_c.amax(-1), m1)
            cands.append(ops.paste(t2, fa, f_b, mt))
    return _with_base(batch, _stack(cands)) if with_base else _stack(cands)


def mh_candidates_plain(state: GenomeState, f_a, f_b: torch.Tensor, max_id=None,
                        with_base: bool = False) -> GenomeState:
    """The 13-candidate catalogue of the Metropolis-Hastings / MTM samplers,
    with the calling convention of :func:`build_candidates_plain` (fields
    of shape ``(m, 13, n)``, or ``(m, 14, n)`` with the base).

    Modes: 0 eject, 1 flip, 2/3 insert right of B (pop_in_3 +/-), 4/5
    insert left of B (pop_in_4 +/-), 6/7 split at A (down / upstream), 8
    paste A-B (only when both are linear-contig extremities), 9-12
    translocations (only when B is the matching extremity of a linear
    contig before the cuts).

    ``max_id`` is used as the JAX package uses it: by eject, the
    insertions, the splits at A and the paste; the translocations take
    their fresh ids from the maximum of the split state itself, without
    ``max_id``, as the JAX package does.
    """
    batch, fa, f_b, max_id = _batch(state, f_a, f_b, max_id)
    popped = ops.pop_out(batch, fa, max_id)
    m2 = torch.maximum(popped.id_c.amax(-1), max_id)

    cands = [
        popped,                                           # 0: eject
        ops.flip(batch, fa),                              # 1: flip
        ops.pop_in_3(popped, fa, f_b, 1, m2),             # 2
        ops.pop_in_3(popped, fa, f_b, -1, m2),            # 3
        ops.pop_in_4(popped, fa, f_b, 1, m2),             # 4
        ops.pop_in_4(popped, fa, f_b, -1, m2),            # 5
        ops.split(batch, fa, 0, max_id),                  # 6
        ops.split(batch, fa, 1, max_id),                  # 7
    ]
    pos_b, lc_b = ops._at(batch.pos, f_b), ops._at(batch.l_cont, f_b)
    lin_b = ops._at(batch.circ, f_b) == 0

    def is_extremity(f):
        pos = ops._at(batch.pos, f)
        return ((pos == 0) | (pos == ops._at(batch.l_cont, f) - 1)) \
            & (ops._at(batch.circ, f) == 0)

    ok = is_extremity(fa) & is_extremity(f_b)
    cands.append(ops._select(ok, ops.paste(batch, fa, f_b, max_id), batch))   # 8
    for up_a in (0, 1):
        t1 = ops.split(batch, fa, up_a, max_id)
        m1 = t1.id_c.amax(-1)
        for up_b in (0, 1):
            # fB must be the matching extremity of a linear contig before
            # the split (next == -1 for a cut after it, prev == -1 before)
            valid = lin_b & ((pos_b == lc_b - 1) if up_b == 0 else (pos_b == 0))
            t2 = ops.split(t1, f_b, up_b, m1)
            mt = t2.id_c.amax(-1)
            cands.append(ops._select(valid, ops.paste(t2, fa, f_b, mt), batch))   # 9-12
    return _with_base(batch, _stack(cands)) if with_base else _stack(cands)
