"""Genome state: a NamedTuple of int32 tensors, one entry per (copy-)fragment.

PyTorch counterpart of ``graal_tpu.core.state``. Contigs are encoded by
``(id_c, pos)``; neighbour ids are derived on demand on the host. The fields
and their order are those of the JAX package:

- ``pos``        position of the fragment inside its contig (0-based)
- ``id_c``       contig label (equality-compared only; values unbounded)
- ``start_bp``   cumulated bp offset of the fragment inside its contig
- ``len_bp``     fragment length in bp (immutable)
- ``circ``       1 if the fragment's contig is circular
- ``l_cont``     number of fragments in the contig
- ``l_cont_bp``  total bp length of the contig
- ``ori``        orientation (+1 / -1)
- ``rep``        1 if the fragment is a repeat copy (immutable)
- ``activ``      1 if the fragment is active (repeats can be switched off)
- ``id_d``       index of the underlying data bin (immutable)

Every field has shape ``(..., n_frags)``: a leading batch dimension holds a
batch of genomes (the JAX package's ``vmap`` axis written out). The
host-side functions (:func:`derive_prev_next`, :func:`check_invariants`,
:func:`dist_inter_genome`) work on one genome and copy it to numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


# Fields a mutation may change; the others are fixed per fragment.
MUTABLE_FIELDS = ("pos", "id_c", "start_bp", "circ", "l_cont", "l_cont_bp",
                  "ori", "activ")


class GenomeState(NamedTuple):
    pos: torch.Tensor
    id_c: torch.Tensor
    start_bp: torch.Tensor
    len_bp: torch.Tensor
    circ: torch.Tensor
    l_cont: torch.Tensor
    l_cont_bp: torch.Tensor
    ori: torch.Tensor
    rep: torch.Tensor
    activ: torch.Tensor
    id_d: torch.Tensor

    @property
    def n_frags(self) -> int:
        return self.pos.shape[-1]

    def max_id_contig(self) -> torch.Tensor:
        return self.id_c.amax(-1)

    def n_contigs(self) -> torch.Tensor:
        """Number of contigs == number of fragments at position 0."""
        return (self.pos == 0).sum(-1)

    @staticmethod
    def from_soa(soa: dict, device=None) -> "GenomeState":
        """Build from the reference-format struct-of-arrays dict."""
        n = len(soa["pos"])

        def as_i32(k, default=None):
            x = np.asarray(soa.get(k, default)).astype(np.int32)
            return torch.as_tensor(x, device=device)

        return GenomeState(
            pos=as_i32("pos"),
            id_c=as_i32("id_c"),
            start_bp=as_i32("start_bp"),
            len_bp=as_i32("len_bp"),
            circ=as_i32("circ"),
            l_cont=as_i32("l_cont"),
            l_cont_bp=as_i32("l_cont_bp"),
            ori=as_i32("ori", np.ones(n, np.int32)),
            rep=as_i32("rep", np.zeros(n, np.int32)),
            activ=as_i32("activ", np.ones(n, np.int32)),
            id_d=as_i32("id_d", np.arange(n, dtype=np.int32)),
        )

    def to_numpy(self) -> dict:
        return {f: getattr(self, f).detach().cpu().numpy() for f in self._fields}


def renormalize(state: GenomeState) -> GenomeState:
    """Recompute start_bp / l_cont / l_cont_bp from (id_c, pos, len_bp).

    start_bp[i] = sum of len_bp over same-contig fragments with smaller pos,
    as an n x n masked sum in int64 (exact at any genome length). The
    consistency oracle for the closed-form per-op updates.
    """
    same = state.id_c[..., :, None] == state.id_c[..., None, :]
    before = state.pos[..., None, :] < state.pos[..., :, None]
    len64 = state.len_bp.long()[..., None, :]
    start_bp = ((same & before) * len64).sum(-1).int()
    l_cont = same.sum(-1).int()
    l_cont_bp = (same * len64).sum(-1).int()
    return state._replace(start_bp=start_bp, l_cont=l_cont, l_cont_bp=l_cont_bp)


def derive_prev_next(state: GenomeState):
    """Host-side: (prev, next) neighbour ids per fragment, -1 at contig ends.

    Circular contigs wrap (prev of pos 0 is the last fragment).
    """
    s = state.to_numpy()
    id_c, pos, circ, l_cont = s["id_c"], s["pos"], s["circ"], s["l_cont"]
    n = len(id_c)
    order = np.lexsort((pos, id_c))
    prev = np.full(n, -1, np.int32)
    nxt = np.full(n, -1, np.int32)
    if n == 0:
        return prev, nxt
    oc = id_c[order]
    same = oc[1:] == oc[:-1]            # consecutive entries share a contig
    nxt[order[:-1][same]] = order[1:][same]
    prev[order[1:][same]] = order[:-1][same]
    # circular wrap: head (pos 0) links back to the tail
    head_k = np.nonzero(pos[order] == 0)[0]
    heads = order[head_k]
    wrap = (circ[heads] == 1) & (l_cont[heads] > 1)
    tails = order[head_k[wrap] + l_cont[heads[wrap]] - 1]
    prev[heads[wrap]] = tails
    nxt[tails] = heads[wrap]
    return prev, nxt


def check_invariants(state: GenomeState, raise_on_error: bool = True):
    """Host-side structural invariant battery: no negative pos / l_cont /
    l_cont_bp / start_bp, start_bp==0 <=> pos==0, no zero-length contigs,
    ori in {-1, +1}, plus full consistency of the derived fields and the
    per-contig permutation property of ``pos``."""
    s = state.to_numpy()
    errors = []
    for f in ("pos", "l_cont", "l_cont_bp", "start_bp"):
        if np.any(s[f] < 0):
            errors.append(f"negative {f}")
    if np.any((s["start_bp"] != 0) & (s["pos"] == 0)):
        errors.append("pos==0 but start_bp!=0")
    if np.any((s["start_bp"] == 0) & (s["pos"] != 0)):
        errors.append("start_bp==0 but pos!=0")
    if np.any(s["l_cont"] == 0) or np.any(s["l_cont_bp"] == 0):
        errors.append("zero-length contig")
    if np.any(s["l_cont_bp"] - s["start_bp"] <= 0):
        errors.append("start_bp beyond contig end")
    if np.any(np.abs(s["ori"]) != 1):
        errors.append("ori not in {-1, +1}")

    n = len(s["pos"])
    order = np.lexsort((s["pos"], s["id_c"]))
    oc = s["id_c"][order]
    new_seg = np.empty(n, bool)
    if n:
        new_seg[0] = True
        new_seg[1:] = oc[1:] != oc[:-1]
        seg_id = np.cumsum(new_seg) - 1
        starts = np.nonzero(new_seg)[0]
        pos_in_seg = np.arange(n) - starts[seg_id]
        if not np.array_equal(s["pos"][order], pos_in_seg):
            errors.append("pos not a permutation within some contig")
        lens = s["len_bp"][order].astype(np.int64)
        cum = np.cumsum(lens) - lens
        start_ref = cum - cum[starts[seg_id]]
        if not np.array_equal(s["start_bp"][order], start_ref):
            errors.append("stored start_bp inconsistent with (id_c,pos,len_bp)")
        seg_count = np.bincount(seg_id)
        if not np.array_equal(s["l_cont"][order], seg_count[seg_id]):
            errors.append("stored l_cont inconsistent with (id_c,pos)")
        seg_bp = np.add.reduceat(lens, starts)
        if not np.array_equal(s["l_cont_bp"][order], seg_bp[seg_id]):
            errors.append("stored l_cont_bp inconsistent with (id_c,len_bp)")
        circ_o = s["circ"][order]
        if not np.array_equal(circ_o, circ_o[starts[seg_id]]):
            errors.append("inconsistent circ flag within some contig")
    if errors and raise_on_error:
        raise AssertionError("genome state corrupted: " + "; ".join(errors))
    return errors


def dist_inter_genome(state: GenomeState, init_prev, init_next, init_ori,
                      orientable, skip_mask) -> float:
    """Neighbourhood-agreement distance to the initial genome, in [0, 1].

    For every fragment not in ``skip_mask``, compare its (prev, next, ori)
    neighbourhood (mapped through id_d) with the initial genome; orientable
    fragments score orientation agreement of their neighbours too.
    """
    prev_arr, next_arr = derive_prev_next(state)
    s = state.to_numpy()
    id_d, ori_arr = s["id_d"], s["ori"]
    init_prev = np.asarray(init_prev)
    init_next = np.asarray(init_next)
    init_ori = np.asarray(init_ori)
    orientable = np.asarray(orientable)
    counted = ~np.asarray(skip_mask)
    n = len(id_d)
    n_counted = int(np.sum(counted))
    if n_counted == 0:
        return 1.0
    norm = 3.0 * n_counted
    d = norm

    prev_t1 = np.where(prev_arr != -1, id_d[np.clip(prev_arr, 0, None)], -1)
    next_t1 = np.where(next_arr != -1, id_d[np.clip(next_arr, 0, None)], -1)
    prev_t0, next_t0 = init_prev, init_next

    pair_match = ((prev_t1 == prev_t0) & (next_t1 == next_t0)) | \
        ((prev_t1 == next_t0) & (next_t1 == prev_t0))
    d -= np.sum(pair_match & counted)

    # first active copy of each data bin (repeat-aware neighbour-ori lookup)
    n_bins = int(id_d.max()) + 1 if n else 0
    first_copy = np.zeros(max(n_bins, 1), np.int64)
    # reversed minimum: later assignments win, so iterate descending ids
    first_copy[id_d[::-1]] = np.arange(n - 1, -1, -1)

    ori_f = counted & orientable
    swap = np.where(init_ori != ori_arr, -1, 1)
    p1 = np.where(swap == -1, next_t1, prev_t1)
    n1 = np.where(swap == -1, prev_t1, next_t1)

    def orientable_side(t0, t1):
        nonlocal d
        match = ori_f & (t0 == t1)
        t1c = np.clip(t1, 0, len(orientable) - 1)
        simple = (t0 == -1) | ~orientable[t1c]
        d -= np.sum(match & simple)
        half = match & ~simple
        d -= 0.5 * np.sum(half)
        cand_ori = ori_arr[first_copy[np.clip(t1, 0, None)]]
        ori_ok = init_ori[np.clip(t0, 0, None)] == swap * cand_ori
        d -= 0.5 * np.sum(half & ori_ok)

    orientable_side(prev_t0, p1)
    orientable_side(next_t0, n1)

    non_f = counted & ~orientable
    d -= np.sum(non_f & ((prev_t1 == prev_t0) | (prev_t1 == next_t0)))
    d -= np.sum(non_f & ((next_t1 == next_t0) | (next_t1 == prev_t0)))
    return float(d / norm)
