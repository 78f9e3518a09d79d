"""The delta engine's per-call scorer inputs: hand-written CUDA kernels for
Hopper.

I1 computes, in one launch a scoring call, what the catalogue (C1 / C2) and
the mini-grid scorer (B2) take of each of the C x m neighbour slots
besides the mini-states: the local indices of fA and of the neighbour in
the slot's member rows, the chain's fresh-id maximum, and the 10-float
parameter row. I2 computes, in one launch after the catalogue, the sub-row
vectors of every slot's 14 genomes that B2 reads (mid, idc, circ, stot and
la), the window keys that B4 reads, and for the repeat engine's copy
corrections (F1 / F2) and the banded route the activity, the int32 circ
and the sub rows' accu. They are the port of the jnp code that XLA fuses
into the operands of the JAX package's mini-grid ``pallas_call``
(graal_tpu/core/delta.py ``make_delta_scorer``; graal_tpu/ops/
likelihood_pallas.py ``params_vec``). The kernel source is
``graal_tpu_torch/csrc/delta_inputs.cu``; its header says what bounds them
on the card, how the design answers that and how they match the plain
versions (``core.delta.slot_inputs_plain``, ``sub_vectors_plain``) bit for
bit.

:data:`INPUTS` is the one wrapper: a delta scorer on a card sends its calls
to it (``DeltaScorer.slot_inputs``, ``DeltaScorer.sub_vectors``), a scorer
on the CPU to the plain versions; the wrapper itself refuses tensors that
are not on a card. :func:`check_slots` and :func:`check_vectors` are what
the kernels take, checked without touching the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.ops import build
from graal_tpu_torch.ops.counts import Counted, LaunchCount

N_ROW = 10
N_GEN = 14                # the base genome and its 13 candidates
N_FIELDS = 11
N_PARAMS = len(RippeParams._fields)
READ = ("start_bp", "ori", "id_c", "circ", "l_cont_bp", "activ")   # the fields I2 reads
# torch on the card divides by a Python float as a product with its f32
# reciprocal; the kernel takes the same f32
INV_KB = float(np.float32(1.0) / np.float32(1000.0))
MAX_SLOTS = 65535

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


class SlotArgs(ctypes.Structure):
    _fields_ = [("rows", _P), ("rows_cs", _I64), ("rows_ms", _I64), ("rows_is", _I64),
                ("f_a", _P), ("ids", _P), ("max_id", _P), ("fa_s", _I64), ("ids_cs", _I64),
                ("ids_ms", _I64), ("mx_s", _I64), ("par", _P * N_PARAMS),
                ("par_s", _I64 * N_PARAMS), ("log_nfpb", _P), ("lf", _P), ("max_id_out", _P),
                ("pvec", _P), ("C", _I32), ("m", _I32), ("f_max", _I32), ("fa64", _I32),
                ("ids64", _I32), ("mx64", _I32)]


class VecArgs(ctypes.Structure):
    _fields_ = [("g", _P * len(READ)), ("g_ss", _I64 * len(READ)), ("g_gs", _I64 * len(READ)),
                ("g_is", _I64 * len(READ)), ("rows", _P), ("rows_cs", _I64), ("rows_ms", _I64),
                ("rows_is", _I64), ("valid", _P), ("valid_cs", _I64), ("valid_ms", _I64),
                ("valid_is", _I64), ("sub_start", _P), ("sub_count", _P), ("prefix", _P),
                ("suffix", _P), ("len_kb", _P), ("accu", _P), ("key_of", _P), ("mid", _P),
                ("idc", _P), ("circ", _P), ("stot", _P), ("la", _P), ("keys", _P), ("act", _P),
                ("circ_i", _P), ("accu_sub", _P), ("inv_kb", ctypes.c_float), ("C", _I32),
                ("m", _I32), ("f_max", _I32), ("s_max", _I32), ("R", _I32), ("K", _I32),
                ("pad", _I32)]


class VectorTables(NamedTuple):
    """A delta engine's constant tables as I2 reads them, contiguous on the
    engine's device: each fragment's first sub row and sub-row count
    (int64, (n,)), each sub row's kb before it on a forward and on a
    reversed fragment, its length in kb and its accu (f32, (K,)), and the
    data sub each sub row is keyed by in the observed map (int64 (K,), the
    repeat engine's ``data_keys``; None: the sub row itself)."""

    sub_start: torch.Tensor
    sub_count: torch.Tensor
    prefix: torch.Tensor
    suffix: torch.Tensor
    len_kb: torch.Tensor
    accu: torch.Tensor
    key_of: torch.Tensor | None
    s_max: int


class SubVectors(NamedTuple):
    """I2's outputs for M neighbour slots of 14 genomes (the base first)
    over R sub rows: B2's (mid, idc, circ, stot, la) (M, 14, R) (circ f32;
    la the log accu, -1e9 on padding and inactive rows), B4's keys (M, R)
    int32 (-1 where the base row is not active), and, where asked for (the
    repeat engine, the banded route), act (M, 14, R) bool, circ_i (M, 14,
    R) int32 and accu_sub (M, R) f32, else None."""

    mid: torch.Tensor
    idc: torch.Tensor
    circ: torch.Tensor
    stot: torch.Tensor
    la: torch.Tensor
    keys: torch.Tensor
    act: torch.Tensor | None
    circ_i: torch.Tensor | None
    accu_sub: torch.Tensor | None


@functools.cache
def load_library():
    """The kernel library (built at first use), its C functions typed and
    its argument blocks checked against their ctypes mirrors."""
    lib = build.load("delta_inputs")
    for fn, mirror in ((lib.delta_slot_args_size, SlotArgs),
                       (lib.delta_vector_args_size, VecArgs)):
        fn.restype = _I32
        if fn() != ctypes.sizeof(mirror):
            raise RuntimeError(f"delta_inputs.cu and ops/delta_inputs_cuda.py disagree on "
                               f"{mirror.__name__}: {fn()} != {ctypes.sizeof(mirror)} bytes")
    for fn in (lib.delta_slots, lib.delta_vectors):
        fn.argtypes = [_P, _P]
        fn.restype = _I32
    return lib


def _need(x, name, dtypes, shape, dev, contiguous=False):
    dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
    if not isinstance(x, torch.Tensor) or x.dtype not in dtypes \
            or tuple(x.shape) != tuple(shape) or x.device != dev \
            or (contiguous and not x.is_contiguous()):
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device}" if isinstance(x, torch.Tensor)
               else type(x).__name__)
        want = " or ".join(str(d) for d in dtypes)
        raise ValueError(f"{name}: need {'contiguous ' if contiguous else ''}{want} "
                         f"{tuple(shape)} on {dev}, got {got}")


_INDEX = (torch.int32, torch.int64)


def _rows_shape(rows, valid=None):
    if not isinstance(rows, torch.Tensor) or rows.dim() != 3:
        raise ValueError("rows: need a (C, m, f_max) tensor")
    c, m, f_max = rows.shape
    dev = rows.device
    _need(rows, "rows", torch.int64, (c, m, f_max), dev)
    if valid is not None:
        _need(valid, "valid", torch.bool, (c, m, f_max), dev)
    if c < 1 or m < 1 or f_max < 1 or c * m > MAX_SLOTS or f_max >= 2 ** 31:
        raise ValueError(f"need C, m, f_max >= 1, C x m <= {MAX_SLOTS} and f_max < 2^31, got "
                         f"{tuple(rows.shape)}")
    return c, m, f_max, dev


def check_slots(rows, f_a, ids, max_id, params, log_nfpb):
    """What I1 takes: ``rows`` int64 (C, m, f_max) at any strides, C x m <=
    65,535; ``f_a`` int32 / int64 (C,), ``ids`` int32 / int64 (C, m),
    ``max_id`` int32 / int64 (C,), each at any stride; ``params``' fields
    f32 of one value (0-d or (1,)) or one a chain ((C,)), ``log_nfpb`` 0-d
    f32, all on one device. Returns (C, m, f_max); raises ValueError on
    anything else."""
    c, m, f_max, dev = _rows_shape(rows)
    _need(f_a, "f_a", _INDEX, (c,), dev)
    _need(ids, "ids", _INDEX, (c, m), dev)
    _need(max_id, "max_id", _INDEX, (c,), dev)
    if not isinstance(params, RippeParams):
        raise ValueError(f"params: need RippeParams, got {type(params).__name__}")
    for name, p in zip(RippeParams._fields, params):
        if not isinstance(p, torch.Tensor) or p.dim() > 1 or p.numel() not in (1, c):
            raise ValueError(f"parameter {name}: need one value or {c}, got "
                             f"{tuple(p.shape) if isinstance(p, torch.Tensor) else p!r}")
        _need(p, f"parameter {name}", torch.float32, tuple(p.shape), dev)
    _need(log_nfpb, "log_nfpb", torch.float32, (), dev)
    return c, m, f_max


def slot_args(rows, f_a, ids, max_id, params, log_nfpb):
    """The argument block of one I1 call (see :func:`check_slots`), the
    tensors it points into (kept alive until the launch is queued) and the
    outputs (lf_a, lf_b (M,) int64, max_id (M,) of ``max_id``'s dtype, pvec
    (M, 10) f32), allocated on the call's device."""
    c, m, f_max = check_slots(rows, f_a, ids, max_id, params, log_nfpb)
    dev = rows.device
    big_m = c * m
    lf = torch.empty((2, big_m), dtype=torch.int64, device=dev)
    mx = torch.empty(big_m, dtype=max_id.dtype, device=dev)
    pvec = torch.empty((big_m, N_ROW), dtype=torch.float32, device=dev)
    par = list(params)
    a = SlotArgs(
        rows=rows.data_ptr(), rows_cs=rows.stride(0), rows_ms=rows.stride(1),
        rows_is=rows.stride(2), f_a=f_a.data_ptr(), ids=ids.data_ptr(),
        max_id=max_id.data_ptr(), fa_s=f_a.stride(0), ids_cs=ids.stride(0),
        ids_ms=ids.stride(1), mx_s=max_id.stride(0),
        par=(_P * N_PARAMS)(*[p.data_ptr() for p in par]),
        par_s=(_I64 * N_PARAMS)(*[p.stride(0) if p.numel() > 1 else 0 for p in par]),
        log_nfpb=log_nfpb.data_ptr(), lf=lf.data_ptr(), max_id_out=mx.data_ptr(),
        pvec=pvec.data_ptr(), C=c, m=m, f_max=f_max, fa64=int(f_a.dtype == torch.int64),
        ids64=int(ids.dtype == torch.int64), mx64=int(max_id.dtype == torch.int64))
    return a, (rows, f_a, ids, max_id, par, log_nfpb), (lf[0], lf[1], mx, pvec)


def check_vectors(full, rows, valid, tables: VectorTables):
    """What I2 takes: ``full``'s 11 fields (a GenomeState) int32 (C x m,
    14, f_max) at any strides, the slots' base genome and 13 candidates;
    ``rows`` int64 and ``valid`` bool (C, m, f_max) at any strides, every
    row a fragment of the tables (not checked: that would read the card);
    ``tables`` contiguous on that device (:class:`VectorTables`), with
    R = f_max x s_max and K below 2^31. Returns (C, m, f_max, R, K); raises
    ValueError on anything else."""
    c, m, f_max, dev = _rows_shape(rows, valid)
    if len(full) != N_FIELDS:
        raise ValueError(f"full: need {N_FIELDS} fields, got {len(full)}")
    for name in READ:
        _need(getattr(full, name), f"genome field {name}", torch.int32, (c * m, N_GEN, f_max),
              dev)
    n = tables.sub_start.shape[0] if isinstance(tables.sub_start, torch.Tensor) else 0
    k = tables.prefix.shape[0] if isinstance(tables.prefix, torch.Tensor) else 0
    for name in ("sub_start", "sub_count"):
        _need(getattr(tables, name), name, torch.int64, (n,), dev, contiguous=True)
    for name in ("prefix", "suffix", "len_kb", "accu"):
        _need(getattr(tables, name), name, torch.float32, (k,), dev, contiguous=True)
    if tables.key_of is not None:
        _need(tables.key_of, "key_of", torch.int64, (k,), dev, contiguous=True)
    r = f_max * tables.s_max
    if n < 1 or not 1 <= k < 2 ** 31 or tables.s_max < 1 or r >= 2 ** 31:
        raise ValueError(f"need n >= 1, 1 <= K < 2^31, s_max >= 1 and R < 2^31, got {n}, {k}, "
                         f"{tables.s_max}, {r}")
    return c, m, f_max, r, k


def vector_args(full, rows, valid, tables: VectorTables, extras: bool):
    """The argument block of one I2 call (see :func:`check_vectors`), the
    tensors it points into and the outputs (a :class:`SubVectors`; act,
    circ_i and accu_sub only with ``extras``), allocated on the call's
    device."""
    c, m, f_max, r, k = check_vectors(full, rows, valid, tables)
    dev = rows.device
    big_m = c * m
    planes = torch.empty((4, big_m, N_GEN, r), dtype=torch.float32, device=dev)
    idc = torch.empty((big_m, N_GEN, r), dtype=torch.int32, device=dev)
    keys = torch.empty((big_m, r), dtype=torch.int32, device=dev)
    act = torch.empty((big_m, N_GEN, r), dtype=torch.bool, device=dev) if extras else None
    circ_i = torch.empty((big_m, N_GEN, r), dtype=torch.int32, device=dev) if extras else None
    accu_sub = torch.empty((big_m, r), dtype=torch.float32, device=dev) if extras else None
    out = SubVectors(planes[0], idc, planes[1], planes[2], planes[3], keys, act, circ_i,
                     accu_sub)
    fields = [getattr(full, name) for name in READ]

    def ptr(x):
        return None if x is None else x.data_ptr()

    def strides(i):
        return (_I64 * len(READ))(*[x.stride(i) for x in fields])

    a = VecArgs(
        g=(_P * len(READ))(*[x.data_ptr() for x in fields]), g_ss=strides(0), g_gs=strides(1),
        g_is=strides(2), rows=rows.data_ptr(), rows_cs=rows.stride(0), rows_ms=rows.stride(1),
        rows_is=rows.stride(2), valid=valid.data_ptr(), valid_cs=valid.stride(0),
        valid_ms=valid.stride(1), valid_is=valid.stride(2),
        sub_start=tables.sub_start.data_ptr(), sub_count=tables.sub_count.data_ptr(),
        prefix=tables.prefix.data_ptr(), suffix=tables.suffix.data_ptr(),
        len_kb=tables.len_kb.data_ptr(), accu=tables.accu.data_ptr(), key_of=ptr(tables.key_of),
        mid=out.mid.data_ptr(), idc=idc.data_ptr(), circ=out.circ.data_ptr(),
        stot=out.stot.data_ptr(), la=out.la.data_ptr(), keys=keys.data_ptr(), act=ptr(act),
        circ_i=ptr(circ_i), accu_sub=ptr(accu_sub), inv_kb=INV_KB, C=c, m=m, f_max=f_max,
        s_max=tables.s_max, R=r, K=k, pad=0)
    return a, (fields, rows, valid, tables), out


class DeltaInputKernels(Counted):
    """The delta engine's input kernels I1 and I2 on a card; see the module
    docstring. ``n_launches`` counts their launches on the card, by key
    ("delta_slots", "delta_vectors"; ``ops.counts``)."""

    def __init__(self):
        self.launches = LaunchCount()

    @staticmethod
    def _card(dev):
        if dev.type != "cuda":
            raise ValueError(f"the CUDA delta input kernels need tensors on a card, not on {dev}")

    def _launch(self, kind, dev, fn, a):
        rc = fn(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{kind} launch failed: cudaError {rc}")
        self.launches.add(dev, kind)

    def slots(self, rows, f_a, ids, max_id, params, log_nfpb):
        """I1 (see :func:`check_slots`): (lf_a, lf_b, max_id, pvec) of the C
        x m slots, bit for bit ``core.delta.slot_inputs_plain``."""
        self._card(rows.device)
        a, keep, out = slot_args(rows, f_a, ids, max_id, params, log_nfpb)
        self._launch("delta_slots", rows.device, load_library().delta_slots, a)
        del keep
        return out

    def vectors(self, full, rows, valid, tables: VectorTables, extras: bool) -> SubVectors:
        """I2 (see :func:`check_vectors`): the slots' :class:`SubVectors`,
        bit for bit ``core.delta.sub_vectors_plain``."""
        self._card(rows.device)
        a, keep, out = vector_args(full, rows, valid, tables, extras)
        self._launch("delta_vectors", rows.device, load_library().delta_vectors, a)
        del keep
        return out


INPUTS = DeltaInputKernels()
