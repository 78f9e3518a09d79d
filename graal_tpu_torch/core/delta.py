"""Incremental (delta) candidate scoring on the affected-contig mini-state.

PyTorch counterpart of ``graal_tpu.core.delta``. Let D be the fragments of
contig(fA) and contig(fB) in the base genome. Every candidate mutation
only relabels fragments inside D, so a pair with one end outside D is
trans in both genomes with an unchanged expectation: only pairs within
D x D change, and

    dL = sum over pairs u < v in D of [g_cand(u, v) - g_base(u, v)]

with g the Poisson log-pmf (its log(ob!) term cancels). That is O(|D|^2)
per candidate, independent of the genome size.

A step gathers the <= f_max member fragments of the m neighbours' contig
pairs into mini-states (one per neighbour), applies the 13 mutations to
each, scores base + 13 candidates on the neighbour's sub-row grid, and
writes the winner back. Candidates whose contigs exceed ``f_max`` are
excluded from selection through the validity mask; callers grow f_max
between cycles as contigs coalesce.

Kernels carry the step's scoring on the card, each behind a wrapper
whose plain torch version runs on CPU tensors:

- the member rows and mini-states (:data:`graal_tpu_torch.ops.rows_cuda.ROWS`,
  G1-G3): each neighbour's rows in one ordered pass over the genome, and
  the 11 fields gathered at them;
- the scorers' inputs (:data:`graal_tpu_torch.ops.delta_inputs_cuda.INPUTS`,
  I1 / I2): each slot's local fA / neighbour indices, fresh-id maximum and
  parameter row before the catalogue, then the sub-row vectors of its 14
  genomes and the window keys;
- the window obs grid (:class:`graal_tpu_torch.ops.obsgrid_cuda.WindowObsGrid`):
  the D rows' CSR windows, read from the observed map in place, made dense
  over the D sub rows, with base activity folded into the keys;
- the mini-grid scorer (:class:`graal_tpu_torch.ops.mini_grid_cuda.MiniGridScorer`):
  the observed term and the expected mass of the 14 genomes per
  neighbour, with the deltas taken in f64.

The circular / linear specialisation of the JAX package (a ``lax.cond`` on
a device flag) is not a branch here: the kernel branches per cell and the
plain version evaluates the circular-aware formula, which equals the
linear one on a linear row. Nothing in a step reads a device value on the
host.

This module scores repeat-free geometry (copy rows == data rows). A
copy-expanded (repeat) table, where an observed count's expectation sums
over repeat copies, goes to :mod:`graal_tpu_torch.core.delta_repeats`,
which :func:`make_delta_em_step` routes it to; that engine runs its
single-copy majority through :class:`DeltaScorer` with ``data_keys``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graal_tpu_torch.core import graphs
from graal_tpu_torch.core.candidates import N_CANDIDATES, build_candidates
from graal_tpu_torch.core.mcmc import (THRESH_OVERFLOW,
                                       draw_step_inputs, sample_neighbours,
                                       select_score_slot)
from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.sparse import SparseObs, lexsort2
from graal_tpu_torch.core.state import MUTABLE_FIELDS, GenomeState
from graal_tpu_torch.core.subfrags import SubFragTable
from graal_tpu_torch.ops import mini_grid_cuda
from graal_tpu_torch.ops.delta_inputs_cuda import INPUTS, SubVectors, VectorTables
from graal_tpu_torch.ops.likelihood_cuda import N_PARAMS, params_vector
from graal_tpu_torch.ops.mini_grid_cuda import MiniGridScorer, log_cis_plain
from graal_tpu_torch.ops.obsgrid_cuda import WindowObsGrid
from graal_tpu_torch.ops.rows_cuda import ROWS
from graal_tpu_torch.ops.step_cuda import STEP

class MiniTable(NamedTuple):
    """Static fragment -> sub-fragment row ranges of a repeat-free table."""

    sub_start: torch.Tensor   # (n_frags,) int64: first sub row of fragment f
    sub_count: torch.Tensor   # (n_frags,) int64: number of subs (<= 3)
    s_max: int                # max subs per fragment
    n_frags: int


def build_mini_table(table: SubFragTable, allow_repeats: bool = False) -> MiniTable:
    """Per-fragment sub ranges (owner rows are in fragment order, so the
    ranges are contiguous). ``allow_repeats`` opts in to copy-expanded
    tables, which only a repeat-aware scorer may score."""
    if table.has_repeats and not allow_repeats:
        raise ValueError("plain delta scoring requires a repeat-free table")
    owner = table.owner.cpu().numpy()
    if np.any(np.diff(owner) < 0):
        raise ValueError("owner rows must be sorted")
    n_frags = int(owner.max()) + 1 if len(owner) else 0
    counts = np.bincount(owner, minlength=n_frags)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    dev = table.owner.device
    return MiniTable(sub_start=torch.as_tensor(starts, dtype=torch.int64, device=dev),
                     sub_count=torch.as_tensor(counts, dtype=torch.int64, device=dev),
                     s_max=int(counts.max()) if len(counts) else 1, n_frags=n_frags)


def _member_key(member, n):
    """Sort key putting members first, in ascending index order."""
    idx = torch.arange(n, device=member.device)
    return torch.where(member, 2 * n - idx, -idx - 1)


def extract_rows(state: GenomeState, f_a, f_b, f_max: int):
    """Member fragments of contig(fA) u contig(fB), padded to ``f_max``.

    Returns (rows (f_max,) int64, valid (f_max,), overflow ()) with the valid
    member rows forming an ascending prefix."""
    f_b = torch.as_tensor(f_b, device=state.pos.device).reshape(1)
    rows, valid, overflow = extract_rows_each(state, f_a, f_b, f_max)
    return rows[0], valid[0], overflow[0]


def _chain_args(state: GenomeState, f_a, ids):
    """The contig ids (C, n), fA's contig (C, 1) and the neighbours (C, m)
    of one chain (lifted to C = 1; ``single``) or of a chains axis."""
    dev = state.pos.device
    f_a = torch.as_tensor(f_a, device=dev).long()
    single = f_a.dim() == 0
    id_c, ids = (state.id_c[None], ids[None]) if single else (state.id_c, ids)
    c_a = id_c.gather(1, f_a.reshape(-1, 1))
    return single, id_c, c_a, ids.long()


def extract_rows_each(state: GenomeState, f_a, ids, f_max: int):
    """:func:`extract_rows` of every neighbour ``ids`` at once: (rows (m,
    f_max), valid (m, f_max), overflow (m,)), each row equal to
    ``extract_rows(state, f_a, ids[i], f_max)``, padding included. With a
    chains axis (``state`` fields (C, n), ``f_a`` (C,), ``ids`` (C, m))
    every chain at once: (C, m, f_max), (C, m, f_max), (C, m).
    :func:`extract_rows_each_plain`'s result, by kernels G1 / G2 when the
    state is on a card."""
    if state.id_c.device.type != "cuda":
        return extract_rows_each_plain(state, f_a, ids, f_max)
    return _rows_on_card(state, f_a, ids, f_max, False)[:3]


def extract_rows_each_plain(state: GenomeState, f_a, ids, f_max: int):
    """:func:`extract_rows_each` in plain torch: a (C, m, n) membership
    compare and a top-k of the members-first key over the genome."""
    single, id_c, c_a, ids = _chain_args(state, f_a, ids)
    c_b = id_c.gather(1, ids)                                  # (C, m)
    member = (id_c[:, None, :] == c_a[:, :, None]) | (id_c[:, None, :] == c_b[:, :, None])
    overflow = member.sum(-1) > f_max
    rows = torch.topk(_member_key(member, state.n_frags), f_max, dim=-1, sorted=True).indices
    out = (rows, member.gather(-1, rows), overflow)
    return tuple(x[0] for x in out) if single else out


def extract_rows_union(state: GenomeState, f_a, ids, f_max: int):
    """Member rows of every neighbour through one genome-length top-k.

    All m neighbours share contig(fA), so the union of the m + 1 contigs'
    members (contigs larger than f_max left out: their pairs overflow
    anyway) is gathered once, then each neighbour's rows are selected from
    the union. Returns (rows (m, f_max), valid (m, f_max), overflow (m,))
    with the member sets and order of :func:`extract_rows`; overflow comes
    from counted membership. With a chains axis, as
    :func:`extract_rows_each` takes it, each chain's union on its own in
    one batched top-k: (C, m, f_max), (C, m, f_max), (C, m).
    :func:`extract_rows_union_plain`'s result, padding included, by kernels
    G1 / G2 when the state is on a card."""
    if state.id_c.device.type != "cuda":
        return extract_rows_union_plain(state, f_a, ids, f_max)
    return _rows_on_card(state, f_a, ids, f_max, True)[:3]


def extract_rows_union_plain(state: GenomeState, f_a, ids, f_max: int):
    """:func:`extract_rows_union` in plain torch: the union's top-k over
    the genome, then each neighbour's top-k over the union."""
    n = state.n_frags
    dev = state.pos.device
    single, id_c, c_a, ids = _chain_args(state, f_a, ids)
    m = ids.shape[1]
    u_cap = min(n, (m + 1) * f_max)
    c_bs = id_c.gather(1, ids)                                 # (C, m)
    memb_a = id_c == c_a                                       # (C, n)
    raw_memb_b = id_c[:, :, None] == c_bs[:, None, :]          # (C, n, m)
    cnt_a = memb_a.sum(-1, keepdim=True)                       # (C, 1)
    cnt_b = raw_memb_b.sum(1)                                  # (C, m)
    memb_b = raw_memb_b & (cnt_b <= f_max)[:, None, :]
    member_u = (memb_a & (cnt_a <= f_max)) | memb_b.any(-1)
    rows_u = torch.topk(_member_key(member_u, n), u_cap, dim=-1, sorted=True).indices
    valid_u = member_u.gather(1, rows_u)
    idc_u = torch.where(valid_u, id_c.gather(1, rows_u), -1)   # (C, u_cap)
    overflow = torch.where(c_bs == c_a, cnt_a, cnt_a + cnt_b) > f_max
    memb = (idc_u[:, None, :] == c_a[:, :, None]) \
        | (idc_u[:, None, :] == c_bs[:, :, None])              # (C, m, u_cap)
    uidx = torch.arange(u_cap, device=dev)
    key = torch.where(memb, 2 * u_cap - uidx, -uidx - 1)
    sel = torch.topk(key, min(f_max, u_cap), dim=-1, sorted=True).indices
    rows = rows_u.gather(1, sel.reshape(sel.shape[0], -1)).reshape(sel.shape)
    out = (rows, memb.gather(-1, sel), overflow)
    return tuple(x[0] for x in out) if single else out


def extract_rows_max(state: GenomeState, f_a, ids, f_max: int, union: bool):
    """The delta EM step's extraction on a chains axis (``state`` fields
    (C, n), ``f_a`` (C,), ``ids`` (C, m)): :func:`extract_rows_union`
    (``union``) or :func:`extract_rows_each`, and each chain's largest
    contig id (C,), the catalogue's ``max_id``. On a card one G1 / G2 pair
    gives all four; elsewhere the extraction and ``id_c.amax(-1)``."""
    if state.id_c.device.type != "cuda":
        rows = (extract_rows_union_plain if union else extract_rows_each_plain)(
            state, f_a, ids, f_max)
        return (*rows, state.id_c.amax(-1))
    return _rows_on_card(state, f_a, ids, f_max, union)


def _rows_on_card(state: GenomeState, f_a, ids, f_max: int, union: bool):
    """G1 / G2 through :data:`ROWS`: (rows, valid, overflow, max_id), one
    chain (``f_a`` 0-d) lifted to a chains axis of one and dropped after."""
    dev = state.id_c.device
    f_a = torch.as_tensor(f_a, device=dev).long()
    single = f_a.dim() == 0
    id_c, ids = (state.id_c[None], ids[None]) if single else (state.id_c, ids)
    out = ROWS.extract(id_c, f_a.reshape(-1), ids.long(), f_max, union)
    return tuple(x[0] for x in out) if single else out


_PAD_FIELDS = dict(pos=0, start_bp=0, l_cont=1, l_cont_bp=1, circ=0, ori=1,
                   activ=0, rep=0)


def lift_chain(*xs):
    """One chain's arguments with a leading chains axis of one: tensors
    ``x[None]``, tuples of tensors (a GenomeState, draws, params) field by
    field, None kept."""
    return tuple(type(x)(*[None if f is None else f[None] for f in x])
                 if isinstance(x, tuple) else x[None] for x in xs)


def drop_chain(*xs):
    """The inverse of :func:`lift_chain`: chain 0 of each argument."""
    return tuple(type(x)(*[None if f is None else f[0] for f in x])
                 if isinstance(x, tuple) else x[0] for x in xs)


def gather_mini(state: GenomeState, rows, valid) -> GenomeState:
    """Gather each chain's mini-states at ``rows`` (C, ..., f_max) from its
    own genome (``state`` fields (C, n); a single genome goes through
    :func:`lift_chain`); padding rows become inert inactive singletons with
    unique negative contig ids. :func:`gather_mini_plain`'s result, by
    kernel G3 when the rows are on a card (each field a contiguous slice of
    one (11, C, ..., f_max) output)."""
    if rows.device.type != "cuda":
        return gather_mini_plain(state, rows, valid)
    return _gather_on_card(state, rows, valid)


def _gather_on_card(state: GenomeState, rows, valid) -> GenomeState:
    return GenomeState(*ROWS.gather(state, rows, valid).reshape((-1,) + rows.shape).unbind(0))


def gather_mini_plain(state: GenomeState, rows, valid) -> GenomeState:
    """:func:`gather_mini` in plain torch: all 11 fields ride one gather of
    a stacked (C, n, 11) matrix, then the padding's fills."""
    f_max = rows.shape[-1]
    ch = torch.arange(rows.shape[0], device=rows.device)
    got = torch.stack(list(state), dim=-1)[ch.reshape((-1,) + (1,) * (rows.dim() - 1)),
                                           rows]                # (C, ..., f_max, 11)
    mini = GenomeState(*got.unbind(-1))
    pad_idc = -(torch.arange(f_max, dtype=torch.int32, device=rows.device) + 2)
    repl = {"id_c": torch.where(valid, mini.id_c, pad_idc)}
    for f, fill in _PAD_FIELDS.items():
        repl[f] = torch.where(valid, getattr(mini, f), fill)
    return mini._replace(**repl)


def scatter_mini(state: GenomeState, mini: GenomeState, rows, valid) -> GenomeState:
    """Write each chain's mini-state (fields, ``rows`` and ``valid`` (C,
    f_max)) into its own genome (``state`` fields (C, n)): the mutable
    fields through an f_max-element inverse slot map (padding rows target
    the dropped entry n) and one gather."""
    n = state.n_frags
    f_max = rows.shape[-1]
    vrows = torch.where(valid, rows, n)
    slots = torch.arange(f_max, device=rows.device)
    fields = torch.stack([getattr(mini, f) for f in MUTABLE_FIELDS], dim=-1)
    inv = torch.full((rows.shape[0], n + 1), -1, dtype=torch.int64, device=rows.device)
    inv.scatter_(1, vrows, slots.expand_as(vrows))
    inv = inv[:, :n]
    got = fields.gather(1, inv.clamp_min(0)[..., None].expand(-1, -1, fields.shape[-1]))
    in_d = inv >= 0
    return state._replace(**{f: torch.where(in_d, got[..., k], getattr(state, f))
                             for k, f in enumerate(MUTABLE_FIELDS)})


def select_commit_delta(state: GenomeState, minis: GenomeState, rows, rows_valid, dll, ids,
                        valid, overflow, f_a, gumbel, f_t, blacklist, thresh_overflow,
                        inplace: bool = False):
    """The delta step's selection and commit, on a chains axis: draw a
    (neighbour, op) slot of each chain's deltas ``dll`` (C, m, 13), the
    overflowed neighbour slots excluded (:func:`core.mcmc.select_score_slot`),
    and write the 8 mutable fields of that candidate mini-state (``minis``
    fields (C, m, 13, f_max)) at its valid member rows (``rows`` /
    ``rows_valid`` (C, m, f_max)) into the chain's genome (``state`` fields
    (C, n)). A chain's step is a no-op when ``f_a`` is blacklisted or every
    selectable slot overflows. ``ids`` / ``valid`` / ``overflow`` (C, m),
    ``f_a`` (C,) int64, ``gumbel`` (C, m x 13), ``f_t`` a number or one a
    chain.

    Returns (new_state, d_sel (C,) f32: 0 on a no-op, (op, fb, n_over),
    sel). :func:`select_commit_delta_plain`'s result, by kernel D3 when the
    state is on a card (the drawn slot as :func:`core.mcmc.select_commit_dense`
    says): the kernel writes O(f_max) entries, into ``state`` itself with
    ``inplace`` (returned as the new state; a captured cycle's carry) and
    else into a copy of its mutable fields."""
    if state.pos.device.type != "cuda":
        return select_commit_delta_plain(state, minis, rows, rows_valid, dll, ids, valid,
                                         overflow, f_a, gumbel, f_t, blacklist, thresh_overflow)
    return _delta_on_card(state, minis, rows, rows_valid, dll, ids, valid, overflow, f_a,
                          gumbel, f_t, blacklist, thresh_overflow, inplace)


def _delta_on_card(state: GenomeState, minis: GenomeState, rows, rows_valid, dll, ids, valid,
                   overflow, f_a, gumbel, f_t, blacklist, thresh_overflow, inplace):
    new = state if inplace else state._replace(
        **{f: getattr(state, f).clone() for f in MUTABLE_FIELDS})
    d_sel, op, fb, n_over, sel = STEP.select_delta(
        new._asdict(), minis._asdict(), rows, rows_valid, dll, ids, valid, overflow, f_a, gumbel,
        f_t, blacklist, thresh_overflow)
    return new, d_sel, (op, fb, n_over), sel


def select_commit_delta_plain(state: GenomeState, minis: GenomeState, rows, rows_valid, dll,
                              ids, valid, overflow, f_a, gumbel, f_t, blacklist,
                              thresh_overflow):
    """:func:`select_commit_delta` in plain torch (the commit through
    :func:`scatter_mini`)."""
    dev = state.pos.device
    n_ch, m = ids.shape
    slot_ok = (~overflow)[..., None].expand(n_ch, m, N_CANDIDATES)
    sel = select_score_slot(gumbel, dll, valid, f_t, slot_valid=slot_ok,
                            thresh_overflow=thresh_overflow)
    sel_nb = sel // N_CANDIDATES
    sel_op = sel % N_CANDIDATES
    sel_mini = GenomeState(*[_pick(x.reshape(n_ch, m * N_CANDIDATES, -1), sel) for x in minis])
    new_state = scatter_mini(state, sel_mini, _pick(rows, sel_nb), _pick(rows_valid, sel_nb))

    # no-op when every selectable slot overflows
    op_idx = torch.arange(N_CANDIDATES, device=dev)[None, :]
    nb_idx = torch.arange(m, device=dev)[:, None]
    base_ok = (valid[..., None] | ((nb_idx == 0) & (op_idx < 2))) \
        & ~((op_idx < 2) & (nb_idx > 0))
    skip = blacklist.index_select(0, f_a) | ~(base_ok & slot_ok).flatten(-2).any(-1)
    new_state = GenomeState(*[torch.where(skip[..., None], a, b)
                              for a, b in zip(state, new_state)])
    d_sel = torch.where(skip, 0.0, _pick(dll.reshape(n_ch, -1), sel))
    return new_state, d_sel, (torch.where(skip, -1, sel_op),
                              torch.where(skip, f_a, _pick(ids, sel_nb)),
                              overflow.sum(-1)), sel


def effective_band_w(band_w: int | None, table: SubFragTable, f_max: int,
                     device=None) -> int | None:
    """The band a delta scorer of bucket ``f_max`` scores with on
    ``device`` (the table's by default): ``band_w`` for the banded
    expected-mass path, or None for the dense (R, R) grid.

    On a CUDA device every bucket takes the grid, B4 + B2. B2 already pays
    its transcendentals only on the same-contig pairs inside (0, d_max),
    which are the band, and a product on every other cell, in one launch;
    the banded path repeats B2's observed term in plain torch over the
    whole grid and adds a sort and a band loop. Measured by
    ``chip_smoke.py`` (phase 5c) on one NVIDIA H100 80GB HBM3 at a 700 W
    power limit, scoring one step of the 100k-fragment problem (band 996),
    in two runs: the banded path took 3.9-4.5x the grid's wall time at
    R = 2,048, 12-16x at 4,096, 35-46x at 8,192, 102-109x at 16,384 and
    130-136x for 4 chains at 8,192.

    Elsewhere (the CPU) the reference's rule holds: the band when it is at
    most 1/8 of the mini-grid edge."""
    if band_w is None:
        return None
    if torch.device(table.owner.device if device is None else device).type == "cuda":
        return None
    mt = build_mini_table(table, allow_repeats=True)
    r_max = min(f_max, mt.n_frags) * mt.s_max
    return band_w if 8 * band_w <= r_max else None


class Geometry(NamedTuple):
    """Per-sub-row vectors of a batch of mini genomes, shape (m, C, R)."""

    mid: torch.Tensor
    idc: torch.Tensor
    act: torch.Tensor
    circ: torch.Tensor
    stot: torch.Tensor


def geometry_of(vec: SubVectors) -> Geometry:
    """The :class:`Geometry` (circ int32) of sub-row vectors made with
    their extras (``act``, ``circ_i``)."""
    return Geometry(vec.mid, vec.idc, vec.act, vec.circ_i, vec.stot)


def sub_rows_plain(vt: VectorTables, rows, valid):
    """Global sub rows of mini fragments ``rows`` (m, f_max), (m, R), and
    their validity."""
    m, f_max = rows.shape
    start = vt.sub_start[rows]                                   # (m, f_max)
    count = vt.sub_count[rows]
    slot = torch.arange(vt.s_max, device=rows.device)
    subs = (start[..., None] + slot).reshape(m, f_max * vt.s_max)
    sub_valid = (valid[..., None] & (slot < count[..., None])).reshape(m, f_max * vt.s_max)
    return subs, sub_valid


def slot_inputs_plain(rows, f_a, ids, max_id, params: RippeParams, log_nfpb):
    """Kernel I1's function in plain torch: for the C x m neighbour slots of
    ``rows`` (C, m, f_max) (``f_a`` and ``max_id`` (C,), ``ids`` (C, m),
    params shared or one set a chain with fields (C,)), (lf_a, lf_b (M,)
    int64: the first position of fA / the neighbour in the slot's rows, 0
    where there is none; max_id (M,), each slot its chain's; the parameter
    rows (M, 10), each slot its chain's)."""
    c, m, _ = rows.shape
    lf_a = (rows == f_a[:, None, None]).int().argmax(-1).reshape(-1)
    lf_b = (rows == ids[..., None]).int().argmax(-1).reshape(-1)
    pvec = params_vector(params, log_nfpb).expand(c, N_PARAMS).repeat_interleave(m, 0)
    return lf_a, lf_b, max_id.repeat_interleave(m), pvec


def sub_vectors_plain(full: GenomeState, rows, valid, vt: VectorTables,
                      extras: bool) -> SubVectors:
    """Kernel I2's function in plain torch: the :class:`SubVectors` of the
    slots' 14 genomes ``full`` (fields (C x m, 14, f_max), the base first)
    on their member rows ``rows`` / ``valid`` (C, m, f_max); ``extras``:
    with act, circ_i and accu_sub."""
    c, m, f_max = rows.shape
    rows, valid = rows.reshape(c * m, f_max), valid.reshape(c * m, f_max)
    subs, sub_valid = sub_rows_plain(vt, rows, valid)
    subs_c = subs.clamp(0, vt.prefix.shape[0] - 1)
    os_ = torch.arange(f_max, device=rows.device).repeat_interleave(vt.s_max)   # (R,)
    ori = full.ori[..., os_]
    mid = full.start_bp[..., os_].float() / 1000.0 \
        + torch.where(ori == 1, vt.prefix[subs_c][:, None, :], vt.suffix[subs_c][:, None, :]) \
        + vt.len_kb[subs_c][:, None, :] * 0.5
    act = (full.activ[..., os_] == 1) & sub_valid[:, None, :]
    circ = full.circ[..., os_]
    accu_sub = vt.accu[subs_c]
    la = torch.where(act, torch.log(accu_sub)[:, None, :], -1e9)
    # the CSR windows' keys: the sub row, or its data sub under key_of,
    # where the base row is active, and -1 (no window) elsewhere
    keys = torch.where(act[:, 0], subs_c if vt.key_of is None else vt.key_of[subs_c], -1).int()
    return SubVectors(mid=mid, idc=full.id_c[..., os_], circ=circ.float(),
                      stot=full.l_cont_bp[..., os_].float() / 1000.0, la=la, keys=keys,
                      act=act if extras else None, circ_i=circ if extras else None,
                      accu_sub=accu_sub if extras else None)


class DeltaScorer:
    """The per-neighbour delta scorer (``make_delta_scorer``).

    ``scorer(state, f_a, f_b, params, max_id) -> (dll (13,), candidates
    (13, f_max), rows, valid, overflow)`` scores one neighbour like the JAX
    ``dscore``; :meth:`score` scores the m neighbours of a step at once.
    dll is log_likelihood(candidate) - log_likelihood(base) whenever
    overflow is False.

    ``obs``: dense observed matrix (small problems); ``sobs``: a
    :class:`SparseObs` (chr1 scale), whose CSR windows the obs-grid kernel
    reads for the D rows. ``band_w``: when set, the expected mass is the
    analytic trans mass plus a banded cis correction over the (contig,
    midpoint)-sorted rows
    (plain torch; the JAX package has no kernel for it). ``obs_grid`` and
    ``mini_grid``: the kernel wrappers to launch through (new ones by
    default), shared by a caller that counts launches.

    ``catalogue``: the 13-candidate builder applied to the mini-states,
    with :func:`core.candidates.build_candidates`'s calling convention,
    ``with_base`` included (the EM catalogue, the default); the MTM / MH
    samplers pass :func:`core.candidates.mh_candidates`.

    ``data_keys``: an optional (n_subs,) map from copy rows to data subs.
    When set, ``sobs`` lies on the data grid and the CSR windows are fetched
    and matched by ``data_keys[sub]`` instead of the sub row itself: the
    repeat engine (:mod:`core.delta_repeats`) scores its single-copy
    majority through here, copy rows keyed by their data bin. The caller
    owns the exactness contract: every window entry's expectation must be
    one in-D copy pair, i.e. ``sobs`` holds no entry that touches a
    multi-copy bin. Without ``data_keys`` a repeat table raises ValueError.
    """

    def __init__(self, table: SubFragTable, obs, f_max: int, sobs: SparseObs | None = None,
                 band_w: int | None = None, obs_grid: WindowObsGrid | None = None,
                 mini_grid: MiniGridScorer | None = None, data_keys=None,
                 catalogue=None, _off_chunk: int | None = None):
        self.catalogue = build_candidates if catalogue is None else catalogue
        self.mt = build_mini_table(table, allow_repeats=data_keys is not None)
        self.f_max = min(f_max, self.mt.n_frags)    # top-k cannot exceed the genome
        self.s_max = self.mt.s_max
        self.r_max = self.f_max * self.s_max
        self.k_subs = table.n_subs
        self.device = table.owner.device
        self.nfpb = float(np.float32(table.n_frags_per_bins))
        self.log_nfpb = torch.tensor(np.float32(np.log(table.n_frags_per_bins)),
                                     device=self.device)
        self.sobs = sobs
        self.key_of = None
        if data_keys is not None:
            if sobs is None:
                raise ValueError("data_keys needs a sparse observed map (sobs)")
            self.key_of = torch.as_tensor(data_keys, device=self.device).long()
        if sobs is None:
            self.obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
            self.upper = torch.ones((self.r_max, self.r_max), dtype=torch.bool,
                                    device=self.device).triu(1)
        self.obs_grid_kernel = WindowObsGrid() if obs_grid is None else obs_grid
        self.mini_grid = MiniGridScorer() if mini_grid is None else mini_grid
        self.band_w = band_w
        if band_w is not None:
            self.off_chunk = _off_chunk if _off_chunk is not None else \
                max(8, min(band_w, (1 << 20) // max(self.r_max, 1)))
        mt = self.mt
        self.vt = VectorTables(                                  # as kernel I2 reads them
            sub_start=mt.sub_start.contiguous(), sub_count=mt.sub_count.contiguous(),
            prefix=table.prefix_kb.contiguous(), suffix=table.suffix_kb.contiguous(),
            len_kb=table.len_kb.contiguous(), accu=table.accu.contiguous(),
            key_of=None if self.key_of is None else self.key_of.contiguous(), s_max=mt.s_max)
        # the repeat engine's corrections and the banded route read the
        # activity, the int32 circ and the sub rows' accu too
        self.extras = self.key_of is not None or band_w is not None

    # ---- the D sub rows and their observed grid ---------------------------
    def sub_rows(self, rows, valid):
        """Global sub rows of the mini fragments ``rows`` (m, f_max), (m,
        R), and their validity."""
        return sub_rows_plain(self.vt, rows, valid)

    def obs_grid(self, keys):
        """(m, R, R) strict-upper observed grid of the D sub rows whose
        ``keys`` (:class:`SubVectors`' keys) are not -1, zero on the other
        rows and columns. On a dense observed map (no ``sobs``: small
        problems) a torch gather; there ``keys`` are the sub rows
        themselves where they are not -1."""
        if self.sobs is not None:
            sobs = self.sobs
            return self.obs_grid_kernel(sobs.row_start, sobs.cols, sobs.vals, keys)
        act = keys >= 0
        sc = keys.clamp_min(0).long()
        ob = self.obs[sc[:, :, None], sc[:, None, :]]
        return torch.where(self.upper & act[:, :, None] & act[:, None, :], ob, 0.0)

    def slot_inputs(self, rows, f_a, ids, max_id, params: RippeParams):
        """The C x m slots' (lf_a, lf_b, max_id, parameter rows):
        :func:`slot_inputs_plain`'s result, by kernel I1 when the rows lie
        on a card."""
        if rows.device.type != "cuda":
            return slot_inputs_plain(rows, f_a, ids, max_id, params, self.log_nfpb)
        return self._slots_on_card(rows, f_a, ids, max_id, params)

    def _slots_on_card(self, rows, f_a, ids, max_id, params: RippeParams):
        return INPUTS.slots(rows, f_a, ids, max_id, params, self.log_nfpb)

    def sub_vectors(self, full: GenomeState, rows, valid) -> SubVectors:
        """The slots' :class:`SubVectors` (extras as the engine needs
        them): :func:`sub_vectors_plain`'s result, by kernel I2 when the
        rows lie on a card."""
        if rows.device.type != "cuda":
            return sub_vectors_plain(full, rows, valid, self.vt, self.extras)
        return self._vectors_on_card(full, rows, valid)

    def _vectors_on_card(self, full: GenomeState, rows, valid) -> SubVectors:
        return INPUTS.vectors(full, rows, valid, self.vt, self.extras)

    # ---- scoring -----------------------------------------------------------
    def inputs(self, state: GenomeState, f_a, ids, rows, valid, params: RippeParams,
               max_id):
        """The candidates of every chain's m neighbours ``ids`` of ``f_a``
        on their member rows (:func:`extract_rows_union` or
        :func:`extract_rows_each`), and what scoring them takes.

        ``state`` fields (C, n), ``f_a`` and ``max_id`` (C,), ``ids`` (C,
        m), ``rows`` and ``valid`` (C, m, f_max) (one chain through
        :func:`lift_chain`); params shared, or one set per chain with
        fields (C,). The C x m neighbour slots are one batch of M = C x m:
        (candidates (M, 13, f_max), the sub-row vectors of base +
        candidates and the window keys (:class:`SubVectors`, R sub rows),
        observed grid (M, R, R), kernel parameter rows (M, 10), each slot
        its chain's). On a card one I1 launch before the catalogue and one
        I2 launch after it make everything but the mini-states, the
        catalogue and the grid."""
        c, m, f_max = rows.shape
        mini = gather_mini(state, rows, valid)
        mini = GenomeState(*[x.reshape(c * m, f_max) for x in mini])
        f_a = torch.as_tensor(f_a, device=rows.device)
        lf_a, lf_b, max_id, pvec = self.slot_inputs(rows, f_a, ids, max_id, params)
        # base + candidates (M, 14, f_max), written in place by the catalogue
        full = self.catalogue(mini, lf_a, lf_b, max_id=max_id, with_base=True)
        cands = GenomeState(*[x[:, 1:] for x in full])
        vec = self.sub_vectors(full, rows, valid)
        # ob is zeroed on inactive rows / columns (base activity is folded
        # into the keys): the expected side is masked through la = -1e9,
        # but an unmasked ob there would add ob * (-1e9) to every score and
        # the base / candidate difference would lose all precision. Base
        # activity is the right mask because no window entry touches a row
        # whose activity a candidate toggles: on a repeat-free table
        # activity never changes (swap_activity is a no-op at rep == 0),
        # and under data_keys the windows hold no entry of a multi-copy
        # bin, while only rep-flagged fragments, whose bins are all
        # multi-copy (core/delta_repeats.py), change activity.
        return cands, vec, self.obs_grid(vec.keys), pvec

    @staticmethod
    def mini_grid_args(vec: SubVectors, ob, pvec):
        """The mini-grid kernel's arguments (mid, idc, circ, stot, la, ob,
        pvec), as :meth:`inputs` made them."""
        return vec.mid, vec.idc, vec.circ, vec.stot, vec.la, ob, pvec

    def score(self, state: GenomeState, f_a, ids, rows, valid, overflow,
              params: RippeParams, max_id):
        """Score the m neighbours ``ids`` of ``f_a`` on their member rows.
        Returns (dll (m, 13), candidates (m, 13, f_max), rows, valid,
        overflow). With a chains axis (see :meth:`inputs`) every chain's
        neighbours go through one obs-grid and one mini-grid launch, and
        dll and the candidates come back as (C, m, 13) and (C, m, 13,
        f_max); one chain is scored as a chains axis of one."""
        f_a = torch.as_tensor(f_a, device=rows.device)
        args = (state, f_a, ids, rows, valid, max_id)
        if ids.dim() == 1:
            args = lift_chain(*args)
        cands, vec, ob, pvec = self.inputs(*args[:5], params, args[5])
        if self.band_w is None:
            _, dll = self.mini_grid(*self.mini_grid_args(vec, ob, pvec))
        else:
            dll = self._banded_dll(geometry_of(vec), ob, vec.accu_sub, pvec)
        lead = ids.shape
        return (dll.reshape(lead + dll.shape[1:]),
                GenomeState(*[x.reshape(lead + x.shape[1:]) for x in cands]),
                rows, valid, overflow)

    def __call__(self, state: GenomeState, f_a, f_b, params: RippeParams, max_id):
        dev = state.pos.device
        f_b = torch.as_tensor(f_b, device=dev)
        rows, valid, overflow = extract_rows(state, f_a, f_b, self.f_max)
        dll, cands, *_ = self.score(state, f_a, f_b.reshape(1), rows[None], valid[None],
                                    overflow[None], params, max_id)
        return dll[0], GenomeState(*[x[0] for x in cands]), rows, valid, overflow

    # ---- banded expected mass (plain torch) --------------------------------
    def _banded_dll(self, geo: Geometry, ob, accu_sub, pvec):
        """Scores with the expected mass as analytic trans mass + banded cis
        correction over the (contig, midpoint)-sorted rows; deltas in f64.
        Slabs are bounded by ``mini_grid_cuda.MAX_CELLS``. ``pvec``: one
        row per neighbour slot, (m, 10)."""
        max_cells = mini_grid_cuda.MAX_CELLS
        m, c, r = geo.mid.shape
        g = m * c
        flat = [x.reshape(g, r) for x in geo]
        mid, idc, act, circ, stot = flat
        nbr = torch.arange(m, device=mid.device).repeat_interleave(c)
        accu_g = accu_sub[nbr]                                      # (g, r)
        log_a = torch.log(accu_g)
        # observed term: sum over u < v of ob * log e (ob is strict upper)
        chunk = max(1, max_cells // (r * r))
        obs_terms = []
        for g0 in range(0, g, chunk):
            sl = slice(g0, g0 + chunk)
            pv = mini_grid_cuda.pvec_rows(pvec, nbr[sl], cell_dims=2)
            s = torch.abs(mid[sl, :, None] - mid[sl, None, :])
            same = idc[sl, :, None] == idc[sl, None, :]
            log_e = torch.where(same, log_cis_plain(s, (circ[sl] == 1)[:, :, None],
                                                    stot[sl, :, None], pv), pv[..., 5]) \
                + ((log_a[sl, :, None] + log_a[sl, None, :]) - pv[..., 9])
            pair = act[sl, :, None] & act[sl, None, :]
            obs_terms.append(torch.where(pair, ob[nbr[sl]] * log_e, 0.0)
                             .sum(dim=(1, 2), dtype=torch.float64))
        w = torch.cat(obs_terms)

        # expected mass: analytic trans + banded cis correction
        pv = mini_grid_cuda.pvec_rows(pvec, nbr, cell_dims=2)       # (g, 1, 1, 10)
        v_inter = pv[..., 6]
        a = torch.where(act, accu_g, 0.0)
        a64 = a.double()
        sa = a64.sum(-1)
        mass = v_inter.double().reshape(-1) * (sa * sa - (a64 * a64).sum(-1)) * 0.5 / self.nfpb
        order = lexsort2(idc, mid)
        mid_s, idc_s, circ_s, stot_s, a_s = [x.gather(-1, order) for x in (mid, idc, circ, stot, a)]
        rows_i = torch.arange(r, device=mid.device)[:, None]
        off_chunk = max(1, min(self.off_chunk, max_cells // max(g * r, 1)))
        corr = torch.zeros(g, dtype=torch.float64, device=mid.device)
        for off0 in range(1, self.band_w + 1, off_chunk):
            offs = torch.arange(off0, min(off0 + off_chunk, self.band_w + 1), device=mid.device)
            j = rows_i + offs[None, :]
            jc = j.clamp_max(r - 1)
            s = torch.abs(mid_s[:, :, None] - mid_s[:, jc])
            same = (idc_s[:, :, None] == idc_s[:, jc]) & (j < r)
            na = a_s[:, :, None] * a_s[:, jc] / self.nfpb
            log_cis = log_cis_plain(s, (circ_s == 1)[:, :, None], stot_s[:, :, None], pv)
            cis = torch.where(same, torch.clamp_min(torch.exp(log_cis) - v_inter, 0.0),
                              0.0) * na
            corr = corr + cis.sum(dim=(1, 2), dtype=torch.float64)
        tot = (w - (mass + corr)).reshape(m, c)
        return (tot[:, 1:] - tot[:, :1]).float()


def make_delta_scorer(table: SubFragTable, obs, f_max: int, sobs=None,
                      band_w: int | None = None, obs_grid=None, mini_grid=None,
                      data_keys=None, catalogue=None,
                      _off_chunk: int | None = None) -> DeltaScorer:
    """Build the per-neighbour delta scorer (see :class:`DeltaScorer`).
    ``band_w`` is honoured literally; production entries apply
    :func:`effective_band_w` first."""
    return DeltaScorer(table, obs, f_max, sobs=sobs, band_w=band_w, obs_grid=obs_grid,
                       mini_grid=mini_grid, data_keys=data_keys, catalogue=catalogue,
                       _off_chunk=_off_chunk)


def _pick(x, idx):
    """Entry ``idx[c]`` of each chain's ``x[c]`` (the axis after the chains
    axis), without a host read."""
    shape = (idx.shape[0], 1) + (1,) * (x.dim() - 2)
    return x.gather(1, idx.reshape(shape).expand((-1, 1) + tuple(x.shape[2:])))[:, 0]


def make_delta_em_step(table: SubFragTable, obs, nb, delta: int, f_max: int,
                       sobs=None, band_w: int | None = None,
                       thresh_overflow: float | None = None,
                       obs_grid=None, mini_grid=None, rep=None):
    """EM step with delta scoring (the selection filter is shift-invariant,
    so deltas select like absolute scores). Returns
    ``step(state, rng, params, l_t, f_a, f_t) -> (state, l_t + dL,
    (op, fb, n_overflow))`` where ``rng`` is a Generator or one step's
    :class:`StepDraws` (its ``u_nb`` and ``gumbel`` are used). When every
    selectable slot overflows, or fA is blacklisted, the step is a no-op
    with op -1.

    With a leading chains axis (``state`` fields (C, n), ``f_a`` and
    ``l_t`` (C,), draws (C, ...), ``f_t`` (C,) or a float, params shared or
    one set per chain with fields (C,)) every chain takes its step at once,
    as it would alone: each chain's member rows are extracted on their own,
    then the neighbour slots of all chains go through one obs-grid (B4) and
    one mini-grid (B2) launch, M = C x slots. The selection, the no-op on
    total overflow, the blacklist skip and the write-back stay per chain;
    the outputs gain the chains axis.

    A repeat (copy-expanded) table is scored by the repeat engine v2
    (:func:`core.delta_repeats.make_repeat_delta_scorer_v2`, on the data
    grid: ``obs`` is made sparse if no ``sobs`` is given; ``band_w`` does
    not apply) with each neighbour's rows extracted on their own
    (:func:`extract_rows_each`). ``rep``, the genome's (immutable) repeat
    flags, is then required: the engine checks its exactness contract
    against it."""
    if thresh_overflow is None:
        thresh_overflow = THRESH_OVERFLOW
    if table.has_repeats:
        from graal_tpu_torch.core import delta_repeats
        from graal_tpu_torch.core.sparse import sparse_from_dense

        if sobs is None:
            sobs = sparse_from_dense(obs, device=table.owner.device)
        scorer = delta_repeats.make_repeat_delta_scorer_v2(
            table, f_max, sobs, rep, obs_grid=obs_grid, mini_grid=mini_grid)
    else:
        scorer = make_delta_scorer(table, obs, f_max, sobs=sobs,
                                   band_w=effective_band_w(band_w, table, f_max),
                                   obs_grid=obs_grid, mini_grid=mini_grid)
    union = not table.has_repeats

    def step(state: GenomeState, rng, params: RippeParams, l_t, f_a, f_t, inplace=False):
        """``inplace``: on a card, commit into ``state``'s own tensors and
        return it (the captured cycle's carry, which nothing else holds)."""
        dev = state.pos.device
        f_a = torch.as_tensor(f_a, device=dev).long()
        if isinstance(rng, torch.Generator):
            rng = draw_step_inputs(rng, nb, delta, f_a.shape)
        if f_a.dim() == 0:      # one chain: a chains axis of one
            lifted, rng, f_a = lift_chain(state, rng, f_a)
            new_state, d_sel, out = chains_step(lifted, rng, f_a, params, f_t, inplace)
            new_state = state if new_state is lifted else drop_chain(new_state)[0]
            return new_state, l_t + d_sel[0], drop_chain(*out)
        new_state, d_sel, out = chains_step(state, rng, f_a, params, f_t, inplace)
        return new_state, l_t + d_sel, out

    def chains_step(state: GenomeState, rng, f_a, params: RippeParams, f_t, inplace):
        ids, valid = sample_neighbours(rng.u_nb, f_a, state, nb, delta)
        rows_b, valid_b, over_b, max_id = extract_rows_max(state, f_a, ids, scorer.f_max, union)
        dll, minis, rows, rows_valid, overflow = scorer.score(
            state, f_a, ids, rows_b, valid_b, over_b, params, max_id)
        new_state, d_sel, out, _ = select_commit_delta(
            state, minis, rows, rows_valid, dll, ids, valid, overflow, f_a, rng.gumbel, f_t,
            nb.blacklist, thresh_overflow, inplace)
        return new_state, d_sel, out

    return step


def make_delta_em_cycle(table: SubFragTable, obs, nb, delta: int, f_max: int,
                        sobs=None, anchor_fn=None, band_w: int | None = None,
                        thresh_overflow: float | None = None,
                        obs_grid=None, mini_grid=None, rep=None, capture=None):
    """A delta-scored EM cycle (a scan of steps) with a final full
    re-anchoring of the likelihood.

    Returns ``cycle(state, rng, params, frag_order, l_t, f_t) -> (state,
    l_anchor, (lls, ops, fbs, overs, ncs))`` with per-step metric tensors;
    ``rng`` is a Generator or :class:`StepDraws` with a leading axis of
    len(frag_order).

    ``anchor_fn(state, params) -> 0-d``: the full evaluation that re-anchors
    l_t; None uses the dense likelihood of ``obs``; False skips the
    re-anchor (chunked callers anchor once per cycle). ``rep``: as
    :func:`make_delta_em_step` takes it (repeat tables).

    The carry is Kahan-compensated: each step runs with l_t = 0 and returns
    its raw increment, summed here in a two-f32 compensated sum (a plain f32
    carry quantises every add to the ulp of |L|).

    With a chains axis (``state`` fields (C, n), ``frag_order`` (C, steps),
    ``l_t`` (C,), params shared or one set per chain, ``f_t`` (C,) or a
    float; ``rng`` a Generator or draws with leading axes (steps, C), e.g.
    :class:`graal_tpu_torch.parallel.tempering.ChainDraws`) every step is
    the chains-axis step of :func:`make_delta_em_step`, each chain's carry
    compensated on its own; the metrics gain the chains axis.

    The steps are a :class:`graal_tpu_torch.core.graphs.Scan`: on a CUDA
    table one captured graph replayed once a step, whatever the cycle's
    length (what a capture fixes, the bucket ``f_max``, ``delta``, the
    engine, the chains and their slots, is fixed by this cycle and the
    shapes of its arguments); elsewhere the same body step by step.
    ``capture``: as the scan takes it (False runs eagerly on the card). The
    re-anchor runs after the scan, eagerly.
    """
    step = make_delta_em_step(table, obs, nb, delta, f_max, sobs=sobs, band_w=band_w,
                              thresh_overflow=thresh_overflow, obs_grid=obs_grid,
                              mini_grid=mini_grid, rep=rep)
    if anchor_fn is None:
        from graal_tpu_torch.core.likelihood import log_likelihood

        obs_t = torch.as_tensor(obs, dtype=torch.float32, device=table.owner.device)

        def anchor_fn(state, params):
            return log_likelihood(state, table, obs_t, params)

    def body(carry, consts, x):
        state, l_hi, l_c = carry
        params, f_t = consts
        draws, f_a = x
        state, d_sel, (op, fb, n_over) = step(state, draws, params, torch.zeros_like(l_c),
                                              f_a, f_t, inplace=True)
        y = d_sel - l_c
        t = l_hi + y
        l_c = (t - l_hi) - y
        return (state, t, l_c), (t, op, fb, n_over, state.n_contigs())

    scan = graphs.Scan(body, table.owner.device, capture=capture)

    def cycle(state: GenomeState, rng, params: RippeParams, frag_order, l_t, f_t):
        dev = state.pos.device
        frag_order = torch.as_tensor(frag_order, device=dev).long()
        n_steps = frag_order.shape[-1]
        lead = frag_order.shape[:-1]
        if isinstance(rng, torch.Generator):
            rng = draw_step_inputs(rng, nb, delta, (n_steps,) + lead)
        l_hi = torch.as_tensor(l_t, dtype=torch.float32, device=dev)
        l_c = torch.zeros(lead, dtype=torch.float32, device=dev)
        # the steps' axis leads every per-step input
        (state, l_hi, _), outs = scan((state, l_hi, l_c), (params, f_t),
                                      (rng, frag_order.movedim(-1, 0)))
        l_anchor = l_hi if anchor_fn is False else anchor_fn(state, params)
        return state, l_anchor, outs

    cycle.scan = scan
    return cycle
