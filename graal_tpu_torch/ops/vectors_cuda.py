"""The dense scorers' sub-fragment vectors and parameter row: a hand-written
CUDA kernel for Hopper.

H1 computes, in one launch a scoring call, what B1 and B3 read besides
their tables: each candidate's (mid, idc, circ, stot) over the scorer's
sub rows (``CopyRowScorer.geometry``), B3's copy-order ``a`` column
(``RepeatScorer.vectors_plain``) and, when the call has none yet, the
10-float parameter row (``ops.likelihood_cuda.params_vector``). It is the
port of the jnp code that XLA fuses into the JAX package's ``pallas_call``
operands (``sub_vectors``, ``params_vector`` and ``copy_vectors`` in
graal_tpu/ops/likelihood_pallas.py). The kernel source is
``graal_tpu_torch/csrc/vectors.cu``; its header says what bounds it on the
card and how the design answers that, and how it matches the plain
versions bit for bit.

:data:`VECTORS` is the one wrapper: a scorer on a card sends its calls to
it (``CopyRowScorer.vectors``), a scorer on the CPU to the plain versions;
the wrapper itself refuses tensors that are not on a card; the kernel
counts its own launches on its key's counter. :func:`check_vectors` is
what the kernel takes, checked without touching the card, and
:func:`plan` the launch's shape: the sub rows a block takes and the
genomes of its group.
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
N_PARAMS = len(RippeParams._fields)
READ = ("start_bp", "ori", "id_c", "circ", "l_cont_bp", "activ")   # the fields H1 reads
# torch on the card divides by a Python float as a product with its f32
# reciprocal; the kernel takes the same f32
INV_KB = float(np.float32(1.0) / np.float32(1000.0))
MAX_B = 65535
GROUPS = (1, 2, 4)          # the genomes a block can take (vectors.cu's instances)
THREADS = 128               # sub rows a block takes
N_SM = 132                  # streaming multiprocessors of an H100 SXM
RESIDENT = 16               # blocks of 128 threads an SM holds at G = 1 (32 registers)

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


class VectorsArgs(ctypes.Structure):
    _fields_ = [("st", _P * len(READ)), ("st_bs", _I64 * len(READ)),
                ("st_is", _I64 * len(READ)), ("owner", _P), ("prefix", _P), ("suffix", _P),
                ("len_half", _P), ("accu", _P), ("mid", _P), ("idc", _P), ("circ", _P),
                ("stot", _P), ("a", _P), ("par", _P * N_PARAMS), ("log_nfpb", _P), ("row", _P),
                ("counter", _P), ("inv_kb", ctypes.c_float), ("B", _I32), ("K", _I32),
                ("threads", _I32), ("group", _I32), ("pad", _I32)]


class SubRows(NamedTuple):
    """A scorer's per-sub-row vectors in its ``rows`` order, as H1 reads
    them: the owning fragment (int32), the kb offsets before the sub row on
    a forward and on a reversed fragment, half its length, and B3's
    copy-order accu (None on B1: no ``a`` column)."""

    owner: torch.Tensor
    prefix: torch.Tensor
    suffix: torch.Tensor
    len_half: torch.Tensor
    accu: torch.Tensor | None


@functools.cache
def load_library():
    """The kernel library (built at first use), its C function typed and its
    argument block checked against the ctypes mirror."""
    lib = build.load("vectors")
    lib.vectors_args_size.restype = _I32
    if lib.vectors_args_size() != ctypes.sizeof(VectorsArgs):
        raise RuntimeError(f"vectors.cu and ops/vectors_cuda.py disagree on VectorsArgs: "
                           f"{lib.vectors_args_size()} != {ctypes.sizeof(VectorsArgs)} bytes")
    lib.vectors.argtypes = [_P, _P]
    lib.vectors.restype = _I32
    return lib


def plan(b: int, k: int):
    """(threads, G) of a launch at B genomes and K sub rows: THREADS sub
    rows a block, and the fewest genomes a block (of GROUPS) that keep the
    grid within one wave of resident blocks (N_SM x RESIDENT), so no block
    waits for another to finish. Measured on the card (``kernel_times.py
    --kernels H --sweep``): one genome a thread was the fastest or within
    0.0002 ms of it wherever the grid fits a wave; past it G = 2 won (B =
    260 at 64 threads a block, 2.2 waves at G = 1: 0.0044 against 0.0055
    ms); G = 8 or 16 (66 and 120 registers, so far fewer warps to hide the
    loads' latency) was slower at every shape."""
    chunks = -(-k // THREADS)
    group = next((g for g in GROUPS if chunks * -(-b // g) <= N_SM * RESIDENT), GROUPS[-1])
    return THREADS, group


def _need(x, name, dtype, shape, dev, contiguous=False):
    if not isinstance(x, torch.Tensor) or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or x.device != dev or (contiguous and not x.is_contiguous()):
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device}" if isinstance(x, torch.Tensor)
               else type(x).__name__)
        raise ValueError(f"{name}: need {'contiguous ' if contiguous else ''}{dtype} "
                         f"{tuple(shape)} on {dev}, got {got}")


def check_vectors(states, sub: SubRows, params=None, log_nfpb=None):
    """What H1 takes: ``states``' fields (a GenomeState) int32 (B, n) at any
    strides with 1 <= B <= 65,535, ``sub``'s vectors contiguous (K,) (owner
    int32, every entry a fragment of the genome, not checked: that would
    read the card; the others f32), and for a row ``params``' fields and
    ``log_nfpb`` 0-d f32, all on one device. Returns (B, n, K); raises
    ValueError on anything else."""
    if not isinstance(sub.owner, torch.Tensor) or sub.owner.dim() != 1:
        raise ValueError("owner: need a (K,) tensor")
    dev, k = sub.owner.device, sub.owner.shape[0]
    x = states.start_bp
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("states: need (B, n) fields")
    b, n = x.shape
    for name in READ:
        _need(getattr(states, name), f"state field {name}", torch.int32, (b, n), dev)
    _need(sub.owner, "owner", torch.int32, (k,), dev, contiguous=True)
    for name in ("prefix", "suffix", "len_half") + (("accu",) if sub.accu is not None else ()):
        _need(getattr(sub, name), name, torch.float32, (k,), dev, contiguous=True)
    if not 1 <= b <= MAX_B or k < 1 or n < 1:
        raise ValueError(f"need 1 <= B <= {MAX_B}, K >= 1 and n >= 1, got {b}, {k}, {n}")
    if params is not None:
        for name, p in zip(RippeParams._fields, params):
            _need(p, f"parameter {name}", torch.float32, (), dev)
        _need(log_nfpb, "log_nfpb", torch.float32, (), dev)
    return b, n, k


def vectors_args(states, sub: SubRows, params=None, log_nfpb=None, counter=None):
    """The argument block of one call (see :func:`check_vectors`; its shape
    from :func:`plan`), the tensors it points into (kept alive until the
    launch is queued) and the outputs ((mid, idc, circ, stot[, a]) (B, K),
    the row (10,) f32 or None), allocated on the call's device. ``counter``
    is the int64 the kernel adds one to (None leaves the block without one,
    which the kernel refuses)."""
    b, _, k = check_vectors(states, sub, params, log_nfpb)
    threads, group = plan(b, k)
    dev = sub.owner.device
    with_a = sub.accu is not None
    planes = torch.empty((4 if with_a else 3, b, k), dtype=torch.float32, device=dev)
    idc = torch.empty((b, k), dtype=torch.int32, device=dev)
    row = None if params is None else torch.empty(N_ROW, dtype=torch.float32, device=dev)
    fields = [getattr(states, name) for name in READ]
    vecs = (planes[0], idc, planes[1], planes[2]) + ((planes[3],) if with_a else ())
    par = list(params) if params is not None else [None] * N_PARAMS
    a = VectorsArgs(
        st=(_P * len(READ))(*[x.data_ptr() for x in fields]),
        st_bs=(_I64 * len(READ))(*[x.stride(0) for x in fields]),
        st_is=(_I64 * len(READ))(*[x.stride(1) for x in fields]),
        owner=sub.owner.data_ptr(), prefix=sub.prefix.data_ptr(),
        suffix=sub.suffix.data_ptr(), len_half=sub.len_half.data_ptr(),
        accu=sub.accu.data_ptr() if with_a else None,
        mid=vecs[0].data_ptr(), idc=idc.data_ptr(), circ=vecs[2].data_ptr(),
        stot=vecs[3].data_ptr(), a=vecs[4].data_ptr() if with_a else None,
        par=(_P * N_PARAMS)(*[None if p is None else p.data_ptr() for p in par]),
        log_nfpb=None if params is None else log_nfpb.data_ptr(),
        row=None if row is None else row.data_ptr(),
        counter=None if counter is None else counter.data_ptr(), inv_kb=INV_KB, B=b, K=k,
        threads=threads, group=group, pad=0)
    return a, (fields, sub, par, log_nfpb), (vecs, row)


class VectorKernels(Counted):
    """The dense scorers' vector kernel H1 on a card; see the module
    docstring. ``n_launches`` counts its launches on the card (key
    "vectors", ``ops.counts``): the kernel adds one to the key's counter
    itself."""

    def __init__(self):
        self.launches = LaunchCount()

    @staticmethod
    def _card(dev):
        if dev.type != "cuda":
            raise ValueError(f"the CUDA vector kernel needs tensors on a card, not on {dev}")

    def __call__(self, states, sub: SubRows, params=None, log_nfpb=None):
        """H1 (see :func:`check_vectors`): ((mid, idc, circ, stot[, a]) each
        (B, K), the parameter row of ``params`` or None), bit for bit the
        plain versions."""
        dev = sub.owner.device
        self._card(dev)
        a, keep, out = vectors_args(states, sub, params, log_nfpb,
                                     self.launches.counter(dev, "vectors"))
        rc = load_library().vectors(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"vectors launch failed: cudaError {rc}")
        del keep
        return out


VECTORS = VectorKernels()
