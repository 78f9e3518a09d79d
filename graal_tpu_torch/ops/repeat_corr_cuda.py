"""The repeat delta engine's copy corrections: hand-written CUDA kernels for
Hopper.

F1 (the routing and frozen terms) and F2 (the per-genome sums and the
delta) compute what ``core.delta_repeats.RepeatDeltaScorer.corrections_plain``
computes, the port of ``graal_tpu/core/delta_repeats.py`` ``dscore_spec`` /
``corr_terms``: for every chain and neighbour slot of one scoring call,
each genome's copy corrections (M, 14) f64, swap_activity's cross term (M,
13) f64 and the delta dll (M, 13) f32 on top of B2's single-copy deltas,
in one launch pair. The JAX package has no Pallas kernel for them: XLA
fuses their jnp code inside the jitted step. The kernel source is
``graal_tpu_torch/csrc/repeat_corr.cu``; its header says what bounds them
on the card and how the design answers that. Each call is two launches on
the current stream, with no synchronisation and no host read, into fresh
outputs and scratch, so a captured step (``core.graphs.Scan``) captures it.
Each kernel counts its own launches on its key's counter.

:data:`CORR` is the one wrapper: ``RepeatDeltaScorer.corrections`` sends
tensors on a card to it and any others to the plain version; the wrapper
itself refuses tensors that are not on a card. :func:`make_tables` puts the
engine's constant tables in the kernels' layout once, when the engine is
built; :func:`check_corrections` is what the kernels take, checked without
touching the card; :func:`plan` is F1's cluster size and router for a
call's shapes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from graal_tpu_torch.ops import build
from graal_tpu_torch.ops.counts import Counted, LaunchCount

N_GEN = 14            # base + 13 candidates a neighbour slot
N_OPS = 13
N_ROW = 10            # the scorers' parameter row (likelihood_cuda.params_vector)
STATE_FIELDS = ("start_bp", "ori", "id_c", "circ", "l_cont_bp", "activ")
KINDS = ("frozen", "sums")   # F1, F2: the launch keys
THREADS = 1024               # F1's block
MAX_CLUSTER = 8              # F1's blocks a cluster, at most (the portable size)
ROUTERS = ("staged", "bitmap")   # F1's routers (csrc/repeat_corr.cu RouterKind)
ROUTER = "bitmap"            # the one plan() picks (measured faster, PERF.md)
ROWS_A_THREAD = 2            # plan(): D rows a thread of a D-row cluster
SMEM_MOST = 216 * 1024       # F1's dynamic shared memory plan() keeps within (an H100's
                             # opt-in 227 KB less F1's static 8.3 KB)

_P, _I64, _F32, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int


class CorrTables(NamedTuple):
    """The engine's constant tables in the kernels' layout (int32 indices,
    contiguous), on the engine's device."""

    owner: torch.Tensor        # (K,) copy row -> fragment
    data_id: torch.Tensor      # (K,) copy row -> data bin
    accu: torch.Tensor         # (K,) f32
    pre: torch.Tensor          # (K,) prefix_kb
    suf: torch.Tensor          # (K,) suffix_kb
    half: torch.Tensor         # (K,) len_kb * 0.5
    sub_start: torch.Tensor    # (n,) a fragment's first copy row
    sub_count: torch.Tensor    # (n,)
    copy_start: torch.Tensor   # (S + 1,) data bin -> copy rows CSR
    copy_rows: torch.Tensor    # (K,)
    dup: torch.Tensor          # (S,) bool: multi-copy bins
    mx_start: torch.Tensor     # (S + 1,) the mixed (single, multi) CSR
    mx_cols: torch.Tensor
    mx_vals: torch.Tensor
    mx_lf: torch.Tensor        # log(ob!) of each entry
    so_start: torch.Tensor     # (S + 1,) the data-grid CSR
    so_cols: torch.Tensor
    so_vals: torch.Tensor
    so_lf: torch.Tensor
    dd_ob: torch.Tensor        # (ndd,) the multi-multi entries
    dd_lf: torch.Tensor
    ddu_rows: torch.Tensor     # (ndd, c_max) copy rows of each end
    ddv_rows: torch.Tensor
    ddu_ok: torch.Tensor       # (ndd, c_max) bool: the copy exists
    ddv_ok: torch.Tensor
    inv_nfpb: float            # f32 reciprocals of the plain version's divisors
    inv_kb: float
    s_max: int                 # copy rows of a fragment, at most
    c_max: int                 # copies of a data bin, at most
    capm: int                  # the mixed windows' width (0: no mixed entry)
    capd: int                  # the data-grid windows' width (0: no entry)


def _i32(x):
    x = torch.as_tensor(x)
    if x.numel() and int(x.abs().max()) >= 2 ** 31:
        raise ValueError("an index of the repeat tables does not fit in int32")
    return x.to(torch.int32).contiguous()


def _f32(x):
    return torch.as_tensor(x).to(torch.float32).contiguous()


def make_tables(table, mt, ct, dup, mixed, mixed_lf, sobs, sobs_lf, dd_ob, dd_lf, ddu,
                ddv) -> CorrTables:
    """The kernels' tables of a repeat engine: ``table`` its SubFragTable,
    ``mt`` its MiniTable, ``ct`` its CopyTable, ``dup`` (S,) bool, ``mixed``
    and ``sobs`` the mixed and data-grid SparseObs with their log(ob!)
    ``mixed_lf`` / ``sobs_lf``, ``dd_ob`` / ``dd_lf`` the multi-multi
    entries and ``ddu`` / ``ddv`` the (rows, ok) of their ends' copies."""
    nfpb = np.float32(table.n_frags_per_bins)
    return CorrTables(
        owner=_i32(table.owner), data_id=_i32(table.data_id), accu=_f32(table.accu),
        pre=_f32(table.prefix_kb), suf=_f32(table.suffix_kb), half=_f32(table.len_kb * 0.5),
        sub_start=_i32(mt.sub_start), sub_count=_i32(mt.sub_count),
        copy_start=_i32(ct.copy_start), copy_rows=_i32(ct.copy_rows),
        dup=torch.as_tensor(dup).bool().contiguous(),
        mx_start=_i32(mixed.row_start), mx_cols=_i32(mixed.cols), mx_vals=_f32(mixed.vals),
        mx_lf=_f32(mixed_lf), so_start=_i32(sobs.row_start), so_cols=_i32(sobs.cols),
        so_vals=_f32(sobs.vals), so_lf=_f32(sobs_lf), dd_ob=_f32(dd_ob), dd_lf=_f32(dd_lf),
        ddu_rows=_i32(ddu[0]), ddv_rows=_i32(ddv[0]), ddu_ok=ddu[1].bool().contiguous(),
        ddv_ok=ddv[1].bool().contiguous(),
        inv_nfpb=float(np.float32(1.0) / nfpb),
        inv_kb=float(np.float32(1.0) / np.float32(1000.0)),
        s_max=mt.s_max, c_max=ct.c_max,
        capm=mixed.row_cap if mixed.vals.numel() else 0,
        capd=sobs.row_cap if sobs.vals.numel() else 0)


class Tables(ctypes.Structure):
    _fields_ = [(name, _P) for name in CorrTables._fields[:25]] + [
        ("inv_nfpb", _F32), ("inv_kb", _F32), ("K", _I32), ("S", _I32), ("n", _I32),
        ("s_max", _I32), ("c_max", _I32), ("capm", _I32), ("capd", _I32), ("ndd", _I32)]


SCRATCH = ("n_rec", "mx_rec", "mx_aout", "sb_pair", "o_same", "dd_f", "dd_mini", "p4_f",
           "p4_ent", "ca_mini", "w_all", "sb_stage")


class CorrArgs(ctypes.Structure):
    _fields_ = [("t", Tables), ("rows", _P), ("valid", _P), ("st", _P * 6), ("st_cs", _I64 * 6),
                ("st_is", _I64 * 6), ("fa", _P), ("fa_s", _I64), ("mid", _P), ("idc", _P),
                ("act", _P), ("circ", _P), ("stot", _P), ("accu_sub", _P), ("pvec", _P),
                ("dll1", _P), *[(name, _P) for name in SCRATCH], ("corr", _P), ("cross", _P),
                ("dll", _P), ("frozen_counter", _P), ("sums_counter", _P), ("C", _I32),
                ("m", _I32), ("f_max", _I32), ("R", _I32), ("cluster", _I32), ("router", _I32)]


@functools.cache
def load_library():
    """The kernel library (built at first use), its C functions typed and
    its argument block checked against its ctypes mirror."""
    lib = build.load("repeat_corr")
    lib.repeat_corr_args_size.restype = _I32
    if lib.repeat_corr_args_size() != ctypes.sizeof(CorrArgs):
        raise RuntimeError("repeat_corr.cu and ops/repeat_corr_cuda.py disagree on CorrArgs: "
                           f"{lib.repeat_corr_args_size()} != {ctypes.sizeof(CorrArgs)} bytes")
    for name in ("repeat_corr_frozen", "repeat_corr_sums"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P]
        fn.restype = _I32
    lib.repeat_corr_frozen_smem.argtypes = [_P]
    lib.repeat_corr_frozen_smem.restype = _I64
    lib.repeat_corr_init.argtypes = []
    lib.repeat_corr_init.restype = _I64
    return lib


def frozen_smem(r: int, f_max: int, n: int, cluster: int, router: str) -> int:
    """F1's dynamic shared memory (bytes, csrc/repeat_corr.cu ``f1_smem``):
    the router (the staged prefix, f_max ints, or the bitmap and its
    ranks, two ints a 32 fragments) and three ints a D row of a block's
    run of ceil(R / K)."""
    routed = f_max if router == "staged" else 2 * -(-n // 32)
    return 4 * (routed + 3 * -(-r // cluster))


def plan(r: int, f_max: int, n: int):
    """F1's (cluster size K, router) for a slot of R = ``r`` mini rows at
    bucket ``f_max`` on an ``n``-fragment genome: the fewest blocks (of
    THREADS, at most MAX_CLUSTER) that give a thread of a D-row cluster at
    most ROWS_A_THREAD rows, more while the shared memory asked would pass
    SMEM_MOST; the router ROUTER, or the other where ROUTER's does not
    fit."""
    k = min(MAX_CLUSTER, max(1, -(-r // (THREADS * ROWS_A_THREAD))))
    routers = (ROUTER,) + tuple(x for x in ROUTERS if x != ROUTER)
    for k_try in range(k, MAX_CLUSTER + 1):
        for router in routers:
            if frozen_smem(r, f_max, n, k_try, router) <= SMEM_MOST:
                return k_try, router
    raise ValueError(f"F1 cannot route R = {r} rows at f_max {f_max} on {n} fragments in "
                     f"{SMEM_MOST} bytes of shared memory")


# ---- argument checks (pure functions: no launch, any device) -----------------

def _need(x, name, dtype, shape, dev):
    if not isinstance(x, torch.Tensor) or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or x.device != dev:
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device}" if isinstance(x, torch.Tensor)
               else type(x).__name__)
        raise ValueError(f"{name}: need {dtype} {tuple(shape)} on {dev}, got {got}")


def check_corrections(tables: CorrTables, state, f_a, rows, valid, geo, accu_sub, pvec, dll1):
    """What F1 / F2 take, on a chains axis of C chains of m neighbour slots
    (M = C x m): ``state``'s fields (a GenomeState) int32 (C, n) at any
    strides, n the tables' fragments; ``f_a`` int64 (C,); ``rows`` int64
    and ``valid`` bool (C, m, f_max), each slot's valid rows an ascending
    prefix (``core.delta.extract_rows_each``); ``geo`` the 14 genomes'
    geometry (``core.delta.Geometry``: mid, stot f32, idc, circ int32, act
    bool, (M, 14, R) with R = f_max x s_max); ``accu_sub`` f32 (M, R),
    ``pvec`` f32 (M, 10), ``dll1`` f32 (M, 13); the tables at least one
    copy a bin (any number), all on one device. Returns (C, m, f_max, R);
    raises ValueError on anything else."""
    if not isinstance(rows, torch.Tensor) or rows.dim() != 3:
        raise ValueError("rows: need a (C, m, f_max) tensor")
    dev = rows.device
    c, m, f_max = rows.shape
    if c < 1 or m < 1 or f_max < 1:
        raise ValueError(f"rows: need C, m, f_max >= 1, got {tuple(rows.shape)}")
    if tables.c_max < 1:
        raise ValueError(f"the kernels need at least one copy of a data bin, the table has "
                         f"{tables.c_max}")
    n = tables.sub_start.shape[0]
    big_m, r = c * m, f_max * tables.s_max
    _need(rows, "rows", torch.int64, (c, m, f_max), dev)
    _need(valid, "valid", torch.bool, (c, m, f_max), dev)
    _need(f_a, "f_a", torch.int64, (c,), dev)
    if len(state) != 11:
        raise ValueError(f"state: need a GenomeState, got {len(state)} fields")
    for name in STATE_FIELDS:
        _need(getattr(state, name), f"state.{name}", torch.int32, (c, n), dev)
    for name, dt in (("mid", torch.float32), ("idc", torch.int32), ("act", torch.bool),
                     ("circ", torch.int32), ("stot", torch.float32)):
        _need(getattr(geo, name), f"geo.{name}", dt, (big_m, N_GEN, r), dev)
    _need(accu_sub, "accu_sub", torch.float32, (big_m, r), dev)
    _need(pvec, "pvec", torch.float32, (big_m, N_ROW), dev)
    _need(dll1, "dll1", torch.float32, (big_m, N_OPS), dev)
    for name, x in zip(CorrTables._fields[:25], tables[:25]):
        if x.device != dev:
            raise ValueError(f"tables.{name}: on {x.device}, the call on {dev}")
    return c, m, f_max, r


def _ptr(x):
    return x.data_ptr() if x.numel() else None


class RepeatCorrKernels(Counted):
    """The copy-correction kernels F1 / F2 on a card; see the module
    docstring. ``n_launches`` counts the launches on the card, by kind
    (``KINDS``, ``ops.counts``)."""

    def __init__(self):
        self.launches = LaunchCount()

    @staticmethod
    def _card(dev):
        if dev.type != "cuda":
            raise ValueError(f"the CUDA copy-correction kernels need tensors on a card, not "
                             f"on {dev}")

    @staticmethod
    def _launched(kind, rc):
        if rc != 0:
            raise RuntimeError(f"repeat_corr {kind} launch failed: cudaError {rc}")

    def corrections(self, tables: CorrTables, state, f_a, rows, valid, geo, accu_sub, pvec,
                    dll1):
        """F1 then F2 on one scoring call's slots (see
        :func:`check_corrections`): (corr (M, 14) f64, cross (M, 13) f64,
        dll (M, 13) f32)."""
        dev = rows.device
        self._card(dev)
        a, keep, out = call_args(tables, state, f_a, rows, valid, geo, accu_sub, pvec, dll1,
                                 [self.launches.counter(dev, kind) for kind in KINDS])
        lib = load_library()
        need = lib.repeat_corr_frozen_smem(ctypes.byref(a))
        most = build.opted_in("repeat_corr", lib.repeat_corr_init, dev)
        if need > most:
            raise RuntimeError(f"F1 asks {need} bytes of shared memory, the device allows {most}")
        stream = torch.cuda.current_stream(dev).cuda_stream
        self._launched("frozen", lib.repeat_corr_frozen(ctypes.byref(a), stream))
        self._launched("sums", lib.repeat_corr_sums(ctypes.byref(a), stream))
        del keep
        return out


def call_args(tables: CorrTables, state, f_a, rows, valid, geo, accu_sub, pvec, dll1,
              counters=None):
    """The argument block of one call (see :func:`check_corrections`), the
    tensors it points into (kept alive until the launches are queued) and
    the outputs (corr, cross, dll), allocated on the call's device; F1's
    plan from :func:`plan`. ``counters``: the int64s F1 and F2 add one to a
    launch (the block's are null without them: a launch refuses it)."""
    dev = rows.device
    geo = type(geo)(*[x.contiguous() for x in geo])
    accu_sub, pvec, dll1 = accu_sub.contiguous(), pvec.contiguous(), dll1.contiguous()
    c, m, f_max, r = check_corrections(tables, state, f_a, rows, valid, geo, accu_sub, pvec,
                                       dll1)
    rows, valid = rows.contiguous(), valid.contiguous()
    big_m, cm, s_max = c * m, tables.c_max, tables.s_max
    ndd = tables.dd_ob.shape[0]

    def empty(dtype, *shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    # F1's records for F2 (repeat_corr.cu CorrArgs): each slot's mixed
    # records and same-bin pairs packed at the front of their rows
    scratch = dict(
        n_rec=empty(torch.int32, big_m, 2),
        mx_rec=empty(torch.int32, big_m, r * tables.capm, 2 + cm),
        mx_aout=empty(torch.float32, big_m, r * tables.capm),
        sb_pair=empty(torch.int32, big_m, r * cm, 2), o_same=empty(torch.float32, big_m, r),
        dd_f=empty(torch.float32, big_m, ndd, 3), dd_mini=empty(torch.int32, big_m, ndd, 2, cm),
        p4_f=empty(torch.float32, big_m, s_max, tables.capd, 2),
        p4_ent=empty(torch.int32, big_m, s_max, tables.capd),
        ca_mini=empty(torch.int32, big_m, s_max, cm), w_all=empty(torch.float64, c),
        sb_stage=empty(torch.int32, big_m, r, cm))
    out = (empty(torch.float64, big_m, N_GEN), empty(torch.float64, big_m, N_OPS),
           empty(torch.float32, big_m, N_OPS))
    fields = [getattr(state, name) for name in STATE_FIELDS]
    k, router = plan(r, f_max, tables.sub_start.shape[0])
    t = Tables(*[_ptr(x) for x in tables[:25]], tables.inv_nfpb, tables.inv_kb,
               tables.owner.shape[0], tables.dup.shape[0], tables.sub_start.shape[0], s_max, cm,
               tables.capm, tables.capd, ndd)
    a = CorrArgs(t=t, rows=rows.data_ptr(), valid=valid.data_ptr(),
                 st=(_P * 6)(*[x.data_ptr() for x in fields]),
                 st_cs=(_I64 * 6)(*[x.stride(0) for x in fields]),
                 st_is=(_I64 * 6)(*[x.stride(1) for x in fields]),
                 fa=f_a.data_ptr(), fa_s=f_a.stride(0), mid=geo.mid.data_ptr(),
                 idc=geo.idc.data_ptr(), act=geo.act.data_ptr(), circ=geo.circ.data_ptr(),
                 stot=geo.stot.data_ptr(), accu_sub=accu_sub.data_ptr(), pvec=pvec.data_ptr(),
                 dll1=dll1.data_ptr(), **{name: _ptr(x) for name, x in scratch.items()},
                 corr=out[0].data_ptr(), cross=out[1].data_ptr(), dll=out[2].data_ptr(),
                 frozen_counter=None if counters is None else counters[0].data_ptr(),
                 sums_counter=None if counters is None else counters[1].data_ptr(), C=c,
                 m=m, f_max=f_max, R=r, cluster=k, router=ROUTERS.index(router))
    return a, (geo, accu_sub, pvec, dll1, rows, valid, scratch, counters), out


CORR = RepeatCorrKernels()
